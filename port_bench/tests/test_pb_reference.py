"""The plain reference against the port at small sizes on the CPU: the
rendered image on both binning paths, YOLOv5's predictions, letterbox
and candidates, with the benchmark's own inputs."""
import math

import numpy as np
import pytest
import torch

from port_bench import inputs
from port_bench.drivers.closed_loop import _cameras, _load_yolo
from port_bench.reference import raster, yolo as ref_yolo


@pytest.mark.parametrize("tile", [(64, 32), (16, 16)])
@pytest.mark.parametrize("seed", [5, 2**31 + 3])
def test_render_matches_port(tiny, one_thread, tile, seed):
    from gaussianrpg_tpu_torch.ops.rasterize import (primitive_fields,
                                                     rasterize,
                                                     suggest_capacity)
    from gaussianrpg_tpu_torch.render.camera import make_camera

    sc = dict(tiny["scene"], tile_x=tile[0], tile_y=tile[1])
    gen, _ = inputs.generators(seed, torch.device("cpu"))
    s = inputs.frozen_scene(sc, gen, "cpu")
    W, H = sc["width"], sc["height"]
    fovx = math.radians(sc["fovx_deg"])
    fovy = 2 * math.atan(math.tan(fovx / 2) * H / W)
    wl = dict(episode_s=1.0, image_hz=10, ego_speed_mps=8.0)
    for k in (0, 7):
        c2w = _cameras(wl, 0.4)[k]
        w2c = np.linalg.inv(c2w)
        cam = make_camera(R=w2c[:3, :3].T, T=w2c[:3, 3], K=None, width=W,
                          height=H, fovx=fovx, fovy=fovy, device="cpu")
        fs = primitive_fields(s["means"], s["opacities"], camera=cam,
                              colors=s["colors"], scales=s["scales"],
                              rotations=s["quats"], tile_x=tile[0],
                              tile_y=tile[1])
        cap = suggest_capacity(fs, width=W, height=H)
        out = rasterize(s["means"], s["opacities"], colors=s["colors"],
                        scales=s["scales"], rotations=s["quats"],
                        camera=cam, bg_color=torch.tensor([0.1, 0.2, 0.3]),
                        capacity=cap, tile_x=tile[0], tile_y=tile[1],
                        device="cpu")
        assert not bool(out.overflow)
        ref = raster.render(s["means"], s["scales"], s["quats"],
                            s["opacities"], s["colors"],
                            raster.pinhole_camera(c2w, fovx, W, H, "cpu"),
                            tile_x=tile[0], tile_y=tile[1],
                            bg=torch.tensor([0.1, 0.2, 0.3]))
        assert ref.shape == out.color.shape
        assert float((ref - out.color).abs().max()) < 1e-4
        assert float((ref - out.color).abs().mean()) < 1e-6


def test_yolo_matches_port(one_thread):
    from gaussianrpg_tpu_torch.sim.pipeline import topk_candidates
    from gaussianrpg_tpu_torch.sim.yolo import YoloV5, spec_yolov5

    yc = dict(depth_multiple=0.33, width_multiple=0.5, num_classes=80)
    gen, _ = inputs.generators(11, torch.device("cpu"))
    weights = inputs.yolo_weights(yc, gen, "cpu")
    model = YoloV5(spec_yolov5(80, 0.33, 0.5))
    _load_yolo(model, model.spec, weights)
    img = torch.rand(3, 96, 160, generator=gen)
    with torch.no_grad():
        port = model.eval()(img.permute(1, 2, 0)[None])[0]
        ref = ref_yolo.predict(ref_yolo.layers(0.33, 0.5, 80), weights, img,
                               80)
    assert ref.shape == port.shape
    assert float((ref - port).abs().max()) < 1e-4
    classes = (0, 1, 2, 3, 5, 7)
    a = topk_candidates(port, 64, classes)
    b = ref_yolo.top_candidates(ref, 64, classes)
    assert float((a[:, 4] - b[:, 4]).abs().max()) < 1e-6


def test_letterbox_matches_port():
    from gaussianrpg_tpu_torch.sim.pipeline import letterbox_device

    img = torch.rand(3, 214, 320) * 1.2 - 0.1
    port, gain, pad = letterbox_device(img, (64, 96))
    ref, rgain, rpad = ref_yolo.letterbox(img, (64, 96))
    assert (gain, pad) == (rgain, rpad)
    assert torch.equal(port.permute(2, 0, 1), ref)


def test_yolo_weights_fill_every_conv_of_the_port():
    from gaussianrpg_tpu_torch.sim.yolo import YoloV5, spec_yolov5

    yc = dict(depth_multiple=0.33, width_multiple=0.5, num_classes=80)
    weights = inputs.yolo_weights(yc, torch.Generator(), "cpu")
    model = YoloV5(spec_yolov5(80, 0.33, 0.5))
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == len(weights)
    _load_yolo(model, model.spec, weights)
    loaded = {id(m.weight) for m in convs
              if any(m.weight.data_ptr() and torch.equal(m.weight, w)
                     for w, _ in weights)}
    assert len(loaded) == len(convs)
    with pytest.raises(ValueError):
        _load_yolo(model, model.spec, weights + weights[:1])
