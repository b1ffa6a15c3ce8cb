"""GaussianRPG's own loop on the port, on the CPU at a small size: the
Street Gaussians composite scene of the benchmark's street cell
(`port_bench/street_inputs.py`: SH 3, Fourier 5, three tracked vehicles,
the background's inactive slots, a 16^2 sky, 96 x 64) perceived by
YOLOv5s through `apps.simulate.loop_setup`'s fused branch, which reads a
seeded YOLOv5s checkpoint from `sim.yolov5_weights_path`. Held to the
plain reference the cell `loop_street600k_yolo` is checked against
(`port_bench/reference/street.py` and `perceived.py`) under that cell's
limits: the candidates, the boxes NMS keeps and the loop's decisions;
the fused branch's overflow policy (a render whose pairs overflowed is
rendered again at a grown capacity, counted in `pipeline.regrows`); and
the separate path's hand-off (`ros2.simulator.rgb8_bytes`,
`ros2.object_detector.decode_rgb8`) and detector (`sim.detector.
YoloDetector`) against the reference on the decoded image, with their
spans."""
import copy
import functools
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from port_bench import compare, inputs, street_inputs as si
from port_bench.drivers.street_yolo_loop import yolo_checkpoint
from port_bench.reference import perceived, street
from port_bench.reference import yolo as ref_yolo

from gaussianrpg_tpu_torch.apps import simulate as tsim
from gaussianrpg_tpu_torch.config.config import (DEFAULT_CONFIG, CfgNode,
                                                 merge)
from gaussianrpg_tpu_torch.sim import pipeline
from gaussianrpg_tpu_torch.sim.yolo import spec_yolov5

from .torch_parity import one_cpu_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "port_bench"
WL = json.loads((BENCH / "workloads" / "loop_street600k_yolo.json")
                .read_text())
CFG = json.loads((BENCH / "configs" / "street600k_w149_yolov5s.json")
                 .read_text())
LIMITS = WL["limits"]
CPU = torch.device("cpu")
SEED = 2**31 + 23
OFFSET = 0.5
# frame 3: the parked car is not tracked yet; frame 8: the lead fills the
# view; frame 55: the parked car is in view
FRAMES = (3, 8, 55)


def small_cfg() -> dict:
    cfg = copy.deepcopy(CFG)
    sc = cfg["scene"]
    sc.update(gaussians=3000, width=96, height=64)
    sc["ground"]["count"], sc["facades"]["count"] = 1500, 1000
    cfg["config"]["model"]["actor_capacity"] = 256
    cfg["sky_cubemap"] = dict(cfg["sky_cubemap"], resolution=16)
    lead, oncoming = cfg["vehicles"][:2]
    parked = dict(cfg["vehicles"][4], x_m=60.0, y_m=-3.5, frames=[60, 100])
    cfg["vehicles"] = [lead, oncoming, parked]
    return cfg


def view(cfg, offset, k, position=None) -> street.View:
    c2w, ego, t = si.camera_poses(cfg, WL, offset)[k]
    T = np.linalg.inv(c2w)[:3, 3] if position is None else position
    return street.View(R=c2w[:3, :3],
                       T=np.float32(T).astype(np.float64),
                       ego=ego.astype(np.float32).astype(np.float64),
                       t=float(np.float32(t)), frame=si.frames(cfg)[0] + k)


def meta(cfg) -> dict:
    g, r = cfg["config"]["model"]["gaussian"], cfg["config"]["render"]
    return dict(width=cfg["scene"]["width"], height=cfg["scene"]["height"],
                K=si.intrinsics(cfg["scene"]), tile_x=r["tile_x"],
                tile_y=r["tile_y"], sh_degree=g["sh_degree"],
                fourier_scale=g["fourier_scale"])


@functools.lru_cache(maxsize=None)
def drawn():
    """(cfg, scene tensors, YOLOv5s weights with the Detect head set on
    frame 8's reference image, reference layers)."""
    cfg = small_cfg()
    yc = cfg["yolo"]
    gen, _ = inputs.generators(SEED, CPU)
    s = si.draw(cfg, WL, gen, CPU)
    weights = inputs.yolo_weights(yc, gen, CPU)
    lays = ref_yolo.layers(yc["depth_multiple"], yc["width_multiple"],
                           yc["num_classes"])
    with torch.no_grad():
        img = street.frame(s, view(cfg, OFFSET, 8), meta(cfg))
        boxed, _, _ = ref_yolo.letterbox(img, tuple(yc["input_hw"]))
        raw = ref_yolo.predict(lays, weights, boxed, yc["num_classes"],
                               raw=True)
    return cfg, s, inputs.calibrate_detect(weights, raw, yc), lays


def checkpoint(tmp_path, weights) -> str:
    path = str(tmp_path / "yolov5s.pt")
    torch.save(yolo_checkpoint(spec_yolov5(), weights), path)
    return path


def fused_loop(tmp_path, **render):
    """`loop_setup` on the drawn scene with the seeded checkpoint; render
    keys override the configuration's (`autosize`, `capacity`)."""
    cfg, s, weights, _ = drawn()
    c = copy.deepcopy(cfg["config"])
    c["render"].update(render)
    pcfg = merge(CfgNode.from_dict(DEFAULT_CONFIG), c)
    pcfg.sim.yolov5_weights_path = checkpoint(tmp_path, weights)
    models, meta_, arrays = si.scene_models(s, cfg, CPU)
    cams = si.episode_cameras(cfg, WL, OFFSET, CPU)
    tape = {"frames": [], "image_freq": 10, "dynamic_freq": 50}
    loop = tsim.loop_setup(models, meta_, arrays, cams, tape, pcfg,
                           device=CPU)
    return loop, cams


def geometry(cfg):
    yc, sc = cfg["yolo"], cfg["scene"]
    hw = (sc["height"], sc["width"])
    gain, _, pad = ref_yolo.letterbox_geometry(hw, yc["input_hw"])
    return gain, pad, hw


def test_checkpoint_folds_back_to_the_drawn_weights(tmp_path):
    """The seeded checkpoint, read by `sim.yolo.load_torch_checkpoint`
    (batch norm folded in), gives the port's graph the reference's
    weights bit for bit."""
    from gaussianrpg_tpu_torch.sim.yolo import load_torch_checkpoint

    _, _, weights, _ = drawn()
    spec, model = load_torch_checkpoint(checkpoint(tmp_path, weights),
                                        device=CPU)
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == len(weights)
    got = {(tuple(c.weight.shape), float(c.weight.sum())): c for c in convs}
    for w, b in weights:
        c = got[(tuple(w.shape), float(w.sum()))]
        assert torch.equal(c.weight, w) and torch.equal(c.bias, b)


def test_perceive_fn_matches_the_composed_reference(tmp_path):
    """The fused branch's candidates against the reference's YOLOv5s on
    its own composite image within the cell's limits; the boxes NMS keeps
    equal the reference's NMS of those candidates."""
    cfg, s, weights, lays = drawn()
    loop, cams = fused_loop(tmp_path)
    pf = loop["perceive_fn"]
    assert isinstance(pf, pipeline.FusedPerception)
    assert loop["detector"] is None
    gain, pad, hw = geometry(cfg)
    yc, seen = cfg["yolo"], 0
    for k in FRAMES:
        boxes = pf(cams[k])
        img = street.frame(s, view(cfg, OFFSET, k), meta(cfg))
        pred, cand = perceived.perceive(lays, weights, img, yc)
        gaps = compare.candidate_gaps({k: pf.candidates}, {k: cand},
                                      {k: pred}, yc["classes"])
        assert gaps["cand_conf_gap"] <= LIMITS["cand_conf_gap"], k
        assert gaps["cand_box_gap"] <= LIMITS["cand_box_gap"], k
        want = perceived.boxes(pf.candidates, yc, gain, pad, hw)
        assert [b.tolist() for b in boxes] == [list(w) for w in want], k
        seen += len(want)
    assert seen > 0


def test_loop_decisions_match_the_replay(tmp_path):
    """`run_closed_loop` with the fused `perceive_fn` makes the decisions
    the reference's replay works out from each frame's candidates: the
    verdict, the frame count, and each frame's detections and brake."""
    from gaussianrpg_tpu_torch.sim.loop import run_closed_loop
    from gaussianrpg_tpu_torch.sim.tape import build_tape_from_cameras

    cfg, _, _, _ = drawn()
    loop, cams = fused_loop(tmp_path)
    pf, cands = loop["perceive_fn"], []

    def perceive(cam):
        boxes = pf(cam)
        cands.append(pf.candidates)
        return boxes

    sim, episode_s = cfg["config"]["sim"], 0.6
    tape = {"frames": build_tape_from_cameras(cams, 5), "image_freq": 10,
            "dynamic_freq": 50}
    gt = si.lead_tracklets(cfg, WL)
    res = run_closed_loop(
        tape, None, None, loop["camera_template"], gt,
        brake_distance=40.0, collision_threshold=sim["collision_threshold"],
        simulation_time=episode_s, cam_height=WL["cam_height_m"],
        ranger_extrinsic=loop["ranger_extrinsic"], perceive_fn=perceive)

    gain, pad, hw = geometry(cfg)
    poses = si.camera_poses(cfg, WL, OFFSET)
    lead = next(v for v in cfg["vehicles"] if v["role"] == "lead")
    ep = street.replay(
        lambda k, pos: perceived.boxes(cands[k], cfg["yolo"], gain, pad, hw)
        if k < len(cands) else [],
        positions=[np.float32(np.linalg.inv(c)[:3, 3]).astype(np.float64)
                   for c, _, _ in poses],
        times=[float(np.float32(t)) for _, _, t in poses], rate=5,
        dynamics_hz=50, episode_s=episode_s,
        gap_at=lambda k, pos: si.vehicle_track(
            lead, WL, poses[min(k, len(poses) - 1)][2])[0] + pos[2],
        brake_distance=40.0, collision_m=sim["collision_threshold"],
        K=si.intrinsics(cfg["scene"]).astype(np.float64),
        v2c=np.linalg.inv(si.cam_to_vehicle(cfg["scene"]["ground"]["y"])),
        hw=hw, cam_height=WL["cam_height_m"])
    assert (res.verdict, res.frames_rendered) == (ep.verdict, len(ep.frames))
    assert [(e["n_det"], e["brake"]) for e in res.log] == \
        [(f.n_det, f.brake) for f in ep.frames]
    assert sum(e["n_det"] for e in res.log) > 0


def test_overflow_regrows_and_matches_ample_capacity(tmp_path):
    """A pair capacity probed too small: the frame is rendered again at a
    grown capacity (`pipeline.regrows` up, span `pipeline.regrow` under a
    profiler) and perception reads the same candidates as at an ample
    capacity, where nothing is rendered again."""
    ample, cams = fused_loop(tmp_path, autosize=False, capacity=1 << 17)
    small, _ = fused_loop(tmp_path, autosize=False, capacity=1024)
    r0 = pipeline.regrows
    want = {}
    for k in (8, 55):
        boxes = ample["perceive_fn"](cams[k])
        want[k] = (boxes, ample["perceive_fn"].candidates)
    assert pipeline.regrows == r0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = {8: small["perceive_fn"](cams[8])}
    assert pipeline.regrows >= r0 + 1
    assert "pipeline.regrow" in {e.key for e in prof.key_averages()}
    for k in (8, 55):
        if k not in got:
            got[k] = small["perceive_fn"](cams[k])
        cand = small["perceive_fn"].candidates
        assert np.array_equal(cand, want[k][1]), k
        assert [b.tolist() for b in got[k]] == \
            [b.tolist() for b in want[k][0]], k


def test_separate_hand_off_and_spans(tmp_path):
    """`rgb8_bytes` then `decode_rgb8` give the 8-bit image back as
    floats (the reference's round trip), and under a profiler the
    hand-off and the detector record their spans."""
    from gaussianrpg_tpu_torch.ros2.object_detector import decode_rgb8
    from gaussianrpg_tpu_torch.ros2.simulator import rgb8_bytes
    from gaussianrpg_tpu_torch.sim.detector import YoloDetector

    _, _, weights, _ = drawn()
    g = torch.Generator().manual_seed(3)
    img = torch.rand((3, 64, 96), generator=g) * 1.2 - 0.1
    img[0, 0, :3] = torch.tensor([0.0, 1.0, 254.999 / 255])
    det = YoloDetector(weights_path=checkpoint(tmp_path, weights),
                       device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        msg = SimpleNamespace(data=rgb8_bytes(img.numpy()), height=64,
                              width=96)
        dec = decode_rgb8(msg)
        det.detect(dec, None)
    u8 = np.frombuffer(msg.data, np.uint8).reshape(64, 96, 3)
    assert np.array_equal(
        u8, (img.clamp(0, 1) * 255).to(torch.uint8).permute(1, 2, 0).numpy())
    assert u8[0, :3, 0].tolist() == [0, 255, 254]
    assert dec.dtype == np.float32
    assert np.array_equal(dec, perceived.rgb8_round_trip(img).numpy())
    keys = {e.key for e in prof.key_averages()}
    assert {"ros2.rgb8", "ros2.decode", "detector.yolo",
            "detector.letterbox", "detector.forward", "detector.nms"} <= keys


def test_yolo_detector_on_a_decoded_image_matches_reference(tmp_path):
    """`sim.detector.YoloDetector` with the seeded checkpoint on the
    decoded composite: its predictions' top K against the reference's
    YOLOv5s on the same image, letterboxed on the host, within the cell's
    limits; its boxes equal the reference's NMS of its predictions."""
    from gaussianrpg_tpu_torch.ros2.object_detector import decode_rgb8
    from gaussianrpg_tpu_torch.ros2.simulator import rgb8_bytes
    from gaussianrpg_tpu_torch.sim.detector import YoloDetector

    cfg, s, weights, lays = drawn()
    yc = cfg["yolo"]
    gain, pad, hw = geometry(cfg)
    det = YoloDetector(weights_path=checkpoint(tmp_path, weights),
                       conf_thres=yc["conf_thres"],
                       iou_thres=yc["iou_thres"], device="cpu")
    det._ensure()
    preds = []
    predict = det._det.predict

    def recorded(image):
        out = predict(image)
        preds.append(out[0])
        return out

    det._det.predict = recorded
    seen = 0
    for k in (8, 55):
        img = street.frame(s, view(cfg, OFFSET, k), meta(cfg))
        msg = SimpleNamespace(data=rgb8_bytes(img.numpy()), height=hw[0],
                              width=hw[1])
        boxes = det.detect(decode_rgb8(msg), None)
        pred, cand = perceived.perceive(lays, weights,
                                        perceived.rgb8_round_trip(img), yc,
                                        host=True)
        mine = ref_yolo.top_candidates(torch.from_numpy(preds[-1]),
                                       yc["top_k"], yc["classes"])
        gaps = compare.candidate_gaps({k: mine}, {k: cand}, {k: pred},
                                      yc["classes"])
        assert gaps["cand_conf_gap"] <= LIMITS["cand_conf_gap"], k
        assert gaps["cand_box_gap"] <= LIMITS["cand_box_gap"], k
        want = perceived.detections(torch.from_numpy(preds[-1]), yc, gain,
                                    pad, hw)
        assert len(boxes) == len(want), k
        np.testing.assert_array_equal(
            np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(want, np.float32).reshape(-1, 4))
        seen += len(want)
    assert seen > 0
