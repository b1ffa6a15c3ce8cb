"""The port's YOLOv5 perception (`gaussianrpg_tpu_torch/sim/yolo.py`,
`sim/pipeline.py`) on the CPU: the properties of tests/test_yolo.py (spec,
forward shapes and decode range, NMS, letterbox round trip, detector,
checkpoint conversion with BN fusion), and the port held against the JAX
package on the same numpy inputs and weights: the forward's decoded
predictions within rtol 1e-4 / atol 1e-4 of each column group's max (xywh;
obj and class scores), the letterboxes within 1e-5, the top-K prefilter's
class semantics, the fused step's detections (the same count, boxes within
rtol 1e-4 / atol 1e-3) and checkpoint loading in both of its forms."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gaussianrpg_tpu.sim import pipeline as jpipe  # noqa: E402
from gaussianrpg_tpu.sim import yolo as jyolo  # noqa: E402

from gaussianrpg_tpu_torch.sim import pipeline as tpipe  # noqa: E402
from gaussianrpg_tpu_torch.sim import yolo as tyolo  # noqa: E402
from gaussianrpg_tpu_torch.sim.detector import (VEHICLE_CLASSES,  # noqa: E402
                                                YoloDetector)

from .torch_parity import one_cpu_thread  # noqa: E402,F401

CPU = "cpu"
RTOL = ATOL = 1e-4      # forward: of each column group's max


def assert_pred_close(got, ref):
    """Decoded predictions within RTOL / ATOL of each column group's max:
    xywh (input pixels), then obj and class scores (in [0, 1])."""
    for cols in (slice(0, 4), slice(4, None)):
        g, r = np.asarray(got)[..., cols], np.asarray(ref)[..., cols]
        scale = float(np.abs(r).max())
        err = float(np.abs(g - r).max())
        assert err <= ATOL + RTOL * scale, (cols, err, scale)


@pytest.fixture(scope="module")
def weights():
    """YOLOv5s at seed 1: the JAX params and the port's graph carried
    across from them."""
    spec = jyolo.spec_yolov5()
    jp = jyolo.init_params(spec, seed=1)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return spec, jp, tyolo.model_from_params(spec, tree, device=CPU)


def test_spec_channels():
    spec = tyolo.spec_yolov5()
    assert spec == jyolo.spec_yolov5()
    convs = [l for l in spec if l["kind"] == "conv"]
    # yolov5s backbone widths: 32, 64, 128, 256, 512
    assert convs[0]["cout"] == 32 and convs[0]["k"] == 6
    assert convs[1]["cout"] == 64
    assert convs[4]["cout"] == 512
    c3s = [l for l in spec if l["kind"] == "c3"]
    assert [c["n"] for c in c3s[:4]] == [1, 2, 3, 1]  # depth 0.33
    det = spec[-1]
    assert det["kind"] == "detect" and det["cins"] == [128, 256, 512]
    model = tyolo.YoloV5(spec)
    n_conv = sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    n_par = sum(p.numel() for p in model.parameters())
    assert (n_conv, n_par) == (60, 7_225_885)


def test_forward_shapes_and_decode_range():
    spec = tyolo.spec_yolov5()
    model = tyolo.init_params(spec, seed=0, device=CPU)
    pred = tyolo.forward(spec, model, torch.zeros((1, 192, 320, 3)))
    # anchors: 3 * (24*40 + 12*20 + 6*10) cells
    assert pred.shape == (1, 3 * (24 * 40 + 12 * 20 + 6 * 10), 85)
    p = pred[0].numpy()
    assert np.all(p[:, 4:] >= 0) and np.all(p[:, 4:] <= 1)
    # decoded xy must lie within the (padded) input frame
    assert p[:, 0].min() > -20 and p[:, 0].max() < 340


def test_init_params_draws_the_jax_weights(weights):
    spec, _, carried = weights
    drawn = tyolo.init_params(spec, seed=1, device=CPU)
    for (name, a), b in zip(carried.state_dict().items(),
                            drawn.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("hw", [(64, 96), (96, 160)])
def test_forward_matches_jax(weights, hw):
    spec, jp, model = weights
    img = np.random.default_rng(hw[0]).uniform(
        0, 1, (1, *hw, 3)).astype(np.float32)
    ref = np.asarray(jyolo.forward(spec, jp, jnp.asarray(img)))
    got = tyolo.forward(spec, model, torch.from_numpy(img)).numpy()
    cells = sum((hw[0] // s) * (hw[1] // s) for s in tyolo.STRIDES)
    assert got.shape == ref.shape == (1, 3 * cells, 85)
    assert_pred_close(got, ref)


def test_nms_merges_overlaps():
    pred = np.zeros((3, 85), np.float32)
    pred[0, :4] = (100, 100, 40, 40)
    pred[1, :4] = (102, 102, 40, 40)   # overlaps 0
    pred[2, :4] = (300, 100, 40, 40)   # separate
    pred[:, 4] = (0.9, 0.8, 0.7)
    pred[:, 5 + 2] = 1.0               # class 2 (car)
    det = tyolo.non_max_suppression(pred, conf_thres=0.25)
    assert det.shape[0] == 2
    assert det[0, 4] >= det[1, 4]
    assert set(det[:, 5].astype(int)) == {2}
    np.testing.assert_array_equal(
        det, jyolo.non_max_suppression(pred, conf_thres=0.25))


def test_nms_class_filter():
    pred = np.zeros((1, 85), np.float32)
    pred[0, :4] = (50, 50, 20, 20)
    pred[0, 4] = 0.9
    pred[0, 5 + 9] = 1.0               # class 9: not vehicle/person
    assert tyolo.non_max_suppression(pred, classes=(0, 2)).shape[0] == 0
    assert tyolo.non_max_suppression(pred, classes=None).shape[0] == 1


def test_letterbox_and_scale_roundtrip():
    img = np.random.default_rng(0).uniform(0, 1, (480, 640, 3)).astype(
        np.float32)
    out, gain, pad = tyolo.letterbox(img, (384, 640))
    assert out.shape == (384, 640, 3)
    assert abs(gain - 0.8) < 1e-6
    # a box at image center maps back to the original center
    boxes = np.array([[320 * gain + pad[0] - 10, 240 * gain + pad[1] - 10,
                       320 * gain + pad[0] + 10, 240 * gain + pad[1] + 10]],
                     np.float32)
    back = tyolo.scale_coords(boxes, gain, pad, (480, 640))
    cx = (back[0, 0] + back[0, 2]) / 2
    cy = (back[0, 1] + back[0, 3]) / 2
    assert abs(cx - 320) < 1.0 and abs(cy - 240) < 1.0


@pytest.mark.parametrize("on_device", [False, True])
@pytest.mark.parametrize("in_hw,out_hw", [
    ((480, 640), (384, 640)),       # shrink, pad rows
    ((96, 160), (64, 96)),          # shrink, pad columns
    ((1066, 1600), (384, 640)),     # the loop's frame
    ((50, 70), (96, 160)),          # enlarge
])
def test_letterbox_matches_jax(in_hw, out_hw, on_device):
    """Both letterboxes antialias when they shrink, as jax.image.resize
    does (without it the 1066x1600 frame differs by up to 0.6)."""
    img = np.random.default_rng(in_hw[1]).uniform(
        -0.1, 1.1, (*in_hw, 3)).astype(np.float32)
    if on_device:
        got, gain, pad = tpipe.letterbox_device(
            torch.from_numpy(img.transpose(2, 0, 1).copy()), out_hw)
        ref, jgain, jpad = jpipe.letterbox_device(
            jnp.asarray(img.transpose(2, 0, 1)), out_hw)
        got = got.numpy()
    else:
        img = img.clip(0, 1)
        got, gain, pad = tyolo.letterbox(img, out_hw)
        ref, jgain, jpad = jyolo.letterbox(img, out_hw)
    assert (gain, pad) == (jgain, jpad)
    assert got.shape == (*out_hw, 3)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)


def test_topk_candidates_class_filter_matches_jax():
    """A box whose best class (9, traffic light) is not kept but whose car
    score clears the threshold gets conf 0, as in the JAX prefilter and the
    unfused NMS."""
    rng = np.random.default_rng(4)
    pred = np.zeros((40, 85), np.float32)
    pred[:, :4] = rng.uniform(10, 200, (40, 4))
    pred[:, 4] = rng.uniform(0.0, 1.0, 40)
    pred[:, 5:] = rng.uniform(0.0, 0.2, (40, 80))
    pred[3, 4] = 0.95
    pred[3, 5 + 9] = 0.9
    pred[3, 5 + 2] = 0.8               # 0.76 > conf_thres, not best
    pred[7, 4] = 0.9
    pred[7, 5 + 2] = 0.85              # a kept car
    got = tpipe.topk_candidates(torch.from_numpy(pred), 16).numpy()
    ref = np.asarray(jpipe.topk_candidates(jnp.asarray(pred), 16))
    assert got.shape == ref.shape == (16, 6)
    assert got[0, 4] == pytest.approx(0.9 * 0.85)
    assert got[0, 5] == 2.0
    np.testing.assert_array_equal(got[0, :4], pred[7, :4])
    assert not np.any(np.all(got[:, :4] == pred[3, :4], axis=1)
                      & (got[:, 4] > 0))
    # rows with conf > 0 in the same order (ties are the conf-0 rows)
    live = ref[:, 4] > 0
    np.testing.assert_array_equal(got[live], ref[live])
    assert np.all(got[~live, 4] == 0)
    assert tyolo.non_max_suppression(
        pred, 0.7, classes=VEHICLE_CLASSES).shape[0] == 1


def test_fused_step_matches_jax_and_unfused_detector(weights):
    """The fused step (device letterbox + YOLO + top-K + host NMS tail)
    against the JAX fused step, and against the port's unfused detector
    (host letterbox, NMS over the full prediction), on one image: the same
    detections (tests/test_yolo.py:176)."""
    spec, jp, model = weights
    rng = np.random.default_rng(3)
    H, W = 96, 160
    img = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    conf = 0.25        # where the random head's obj*cls puts boxes

    jstep, jgain, jpad = jpipe.make_fused_step(
        lambda cam: jnp.asarray(img), spec, jp, (H, W), size=(64, 96),
        k=128, classes=VEHICLE_CLASSES)
    ref = jpipe.finish_detections(jstep(None), jgain, jpad, (H, W),
                                  conf_thres=conf)
    step, gain, pad = tpipe.make_fused_step(
        lambda cam: torch.from_numpy(img), spec, model, (H, W),
        size=(64, 96), k=128, classes=VEHICLE_CLASSES)
    assert (gain, pad) == (jgain, jpad)
    cand = step(None)
    assert isinstance(cand, np.ndarray) and cand.shape == (128, 6)
    out = tpipe.finish_detections(cand, gain, pad, (H, W), conf_thres=conf)
    unfused = tyolo.YoloDetector(spec=spec, params=model, size=(64, 96),
                                 conf_thres=conf, classes=VEHICLE_CLASSES,
                                 device=CPU)(img.transpose(1, 2, 0))
    assert ref.shape[0] > 5
    assert out.shape == ref.shape == unfused.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(out, unfused, rtol=1e-4, atol=1e-3)


def test_detector_runs_end_to_end():
    det = tyolo.YoloDetector(size=(192, 320), conf_thres=0.99, device=CPU)
    img = np.random.default_rng(1).uniform(0, 1, (300, 500, 3)).astype(
        np.float32)
    out = det(img)
    assert out.ndim == 2 and out.shape[1] == 6
    if out.shape[0]:
        assert np.all(out[:, 0] <= out[:, 2] + 1e-3)
        assert np.all(out[:, :4] >= -1e-3)
        assert np.all(out[:, 2] <= 500 + 1e-3)


def test_loop_detector_emits_normalized_boxes():
    """sim.detector.YoloDetector (the JAX package's JaxYoloDetector, seed-0
    weights) turns the graph's detections into the loop's normalized
    (cx, cy, w, h)."""
    H, W = 96, 160
    img = np.random.default_rng(3).uniform(0, 1, (3, H, W)).astype(
        np.float32)
    boxes = YoloDetector(size=(64, 96), device=CPU).detect(img, None)
    raw = tyolo.YoloDetector(size=(64, 96), classes=VEHICLE_CLASSES,
                             device=CPU)(img.transpose(1, 2, 0))
    assert len(boxes) == raw.shape[0] > 0
    for b, (x0, y0, x1, y1, _, _) in zip(boxes, raw):
        np.testing.assert_allclose(
            b, [(x0 + x1) / 2 / W, (y0 + y1) / 2 / H, (x1 - x0) / W,
                (y1 - y0) / H], rtol=1e-6)


class PickledModel(torch.nn.Module):
    """Stands in for a pickled YOLOv5 model: `state_dict()` gives the
    checkpoint's tensors."""

    def __init__(self, sd):
        super().__init__()
        self.sd = sd

    def state_dict(self, *args, **kw):
        return dict(self.sd)


def _checkpoint(spec, scale_weights):
    """A YOLOv5 state dict with BN layers, drawn from a seed. With
    `scale_weights` the conv weights are He-scaled so that activations stay
    in range through the 60 layers (for comparing predictions)."""
    sd = {}
    rng = np.random.default_rng(0)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    def add_convbn(prefix, cin, cout, k):
        s = np.sqrt(2.0 / (k * k * cin)) if scale_weights else 1.0
        sd[f"{prefix}.conv.weight"] = t(
            rng.standard_normal((cout, cin, k, k)) * s)
        sd[f"{prefix}.bn.weight"] = t(rng.uniform(0.5, 1.5, cout))
        sd[f"{prefix}.bn.bias"] = t(rng.standard_normal(cout))
        sd[f"{prefix}.bn.running_mean"] = t(rng.standard_normal(cout) * s)
        sd[f"{prefix}.bn.running_var"] = t(rng.uniform(0.5, 2.0, cout))

    for i, lay in enumerate(spec):
        base = f"model.{i}"
        if lay["kind"] == "conv":
            add_convbn(base, lay["cin"], lay["cout"], lay["k"])
        elif lay["kind"] == "c3":
            c_ = lay["cout"] // 2
            add_convbn(f"{base}.cv1", lay["cin"], c_, 1)
            add_convbn(f"{base}.cv2", lay["cin"], c_, 1)
            add_convbn(f"{base}.cv3", 2 * c_, lay["cout"], 1)
            for j in range(lay["n"]):
                add_convbn(f"{base}.m.{j}.cv1", c_, c_, 1)
                add_convbn(f"{base}.m.{j}.cv2", c_, c_, 3)
        elif lay["kind"] == "sppf":
            c_ = lay["cin"] // 2
            add_convbn(f"{base}.cv1", lay["cin"], c_, 1)
            add_convbn(f"{base}.cv2", 4 * c_, lay["cout"], 1)
        elif lay["kind"] == "detect":
            for j, cin in enumerate(lay["cins"]):
                s = np.sqrt(1.0 / cin) if scale_weights else 1.0
                sd[f"{base}.m.{j}.weight"] = t(
                    rng.standard_normal((255, cin, 1, 1)) * s)
                sd[f"{base}.m.{j}.bias"] = t(rng.standard_normal(255))
            sd[f"{base}.anchors"] = t(
                [[[1.25, 1.625], [2.0, 3.75], [4.125, 2.875]],
                 [[1.875, 3.8125], [3.875, 2.8125], [3.6875, 7.4375]],
                 [[3.625, 2.8125], [4.875, 6.1875], [11.65625, 10.1875]]])
    return sd


def test_torch_checkpoint_conversion(tmp_path):
    spec = tyolo.spec_yolov5(num_classes=80)
    sd = _checkpoint(spec, scale_weights=False)
    path = str(tmp_path / "y.pt")
    torch.save(sd, path)
    cspec, model = tyolo.load_torch_checkpoint(path, device=CPU)
    assert cspec == spec
    assert model.layers[0].conv.weight.shape == (32, 3, 6, 6)

    # fusion: conv+BN(x) == fused_conv(x) for layer 0 on random input
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((1, 3, 12, 12)).astype(np.float32))
    with torch.no_grad():
        y_ref = F.conv2d(x, sd["model.0.conv.weight"], None, stride=2,
                         padding=2)
        g = sd["model.0.bn.weight"][None, :, None, None]
        b = sd["model.0.bn.bias"][None, :, None, None]
        m = sd["model.0.bn.running_mean"][None, :, None, None]
        v = sd["model.0.bn.running_var"][None, :, None, None]
        y_ref = (y_ref - m) / torch.sqrt(v + 1e-3) * g + b
        y = model.layers[0].conv(x)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=2e-4,
                               atol=2e-4)

    # anchors rescaled by stride into pixels
    np.testing.assert_allclose(model.layers[-1].anchors[0, 0].numpy(),
                               [10.0, 13.0], rtol=1e-6)

    # full forward with converted weights runs
    pred = tyolo.forward(cspec, model, torch.zeros((1, 96, 160, 3)))
    assert pred.shape[2] == 85


@pytest.mark.parametrize("form", ["state_dict", "pickled_model"])
def test_checkpoint_predictions_match_jax(tmp_path, form):
    """One checkpoint file read by both packages' loaders: the JAX params
    and the port's graph give the same predictions."""
    spec = tyolo.spec_yolov5()
    sd = _checkpoint(spec, scale_weights=True)
    path = str(tmp_path / "y.pt")
    torch.save(sd if form == "state_dict" else {"model": PickledModel(sd)},
               path)
    jspec, jp = jyolo.load_torch_checkpoint(path)
    tspec, model = tyolo.load_torch_checkpoint(path, device=CPU)
    img = np.random.default_rng(6).uniform(0, 1, (1, 64, 96, 3)).astype(
        np.float32)
    ref = np.asarray(jyolo.forward(jspec, jp, jnp.asarray(img)))
    got = tyolo.forward(tspec, model, torch.from_numpy(img)).numpy()
    assert np.isfinite(ref).all()
    assert_pred_close(got, ref)


def test_yolo_entry_points_need_cuda_unless_told_cpu(monkeypatch):
    """Without CUDA the graph, the detectors and the loader raise unless
    given device="cpu"; nothing falls back silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tyolo.spec_yolov5()
    with pytest.raises(RuntimeError, match="CUDA"):
        tyolo.init_params(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        tyolo.YoloDetector()
    with pytest.raises(RuntimeError, match="CUDA"):
        YoloDetector().detect(np.zeros((3, 32, 32), np.float32), None)
    assert isinstance(tyolo.init_params(spec, device=CPU), tyolo.YoloV5)
