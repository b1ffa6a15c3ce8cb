"""The cells where YOLOv5s perceives a frame the reference renders:
`loop_street600k_yolo` and `loop_frozen600k_separate`. Their entries and
files found by name, a CPU run of each driver at a small size that loads
no JAX module, faults in the program their checks catch, a `yolo` block
the program does not follow refused at set-up, their controls each
outside a limit, and their per-layer readers on hand-made traces. The controls at the cells' own size run on the card
(`python -m pytest -m cuda port_bench/tests`)."""
import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import tiny_overrides
from port_bench import calibrate_perceived, compare, core
from port_bench import trace as tr

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
STREET, SEPARATE = "loop_street600k_yolo", "loop_frozen600k_separate"
SEED = 2**31 + 29
DEVICE = ["device_idle_share.loop", "device_busy_ms.loop"]
METRICS = {STREET: ["launches_per_frame", "perception_device_ms",
                    "render_device_ms", *DEVICE, "compose_device_ms.street",
                    "rasterize_device_ms.street", "sky_device_ms.street",
                    "scatter_device_ms.street", "cummax_roofline.street",
                    "blend_fwd_roofline.street", "street_yolo_mfu"],
           SEPARATE: ["launches_per_frame", "render_device_ms", *DEVICE,
                      "handoff_host_ms.separate",
                      "perception_device_ms.separate"]}
LIMITS = {"image_max_gap", "image_mean_gap", "cand_conf_gap",
          "cand_box_gap", "decision_mismatches"}


def street_small() -> dict:
    """The street YOLOv5s cell at 192x128 with 4,000 background
    Gaussians, 256 a vehicle, a 16^2 sky, two 1 s episodes a cycle;
    YOLOv5s at its own input size."""
    _, cfg = core.cell_files(STREET)
    sc = copy.deepcopy(cfg["scene"])
    sc.update(gaussians=4000, width=192, height=128)
    sc["ground"]["count"], sc["facades"]["count"] = 2000, 1500
    c = copy.deepcopy(cfg["config"])
    c["model"]["actor_capacity"] = 512
    return dict(scene=sc, config=c,
                sky_cubemap=dict(cfg["sky_cubemap"], resolution=16),
                episode_s=1.0, lateral_offsets_m=[-0.5, 0.5], samples=2,
                trace={"warmup_frames": 1, "frames": 2})


SMALL = {STREET: street_small, SEPARATE: tiny_overrides}


def run(cell, **kw):
    return core.run_cell(cell, SEED, 0.01, False, "cpu",
                         overrides=SMALL[cell](), **kw)


@pytest.mark.parametrize("cell", [STREET, SEPARATE])
def test_entries_and_files_found_by_name(cell):
    wl, cfg = core.cell_files(cell)
    assert wl["config"] == cfg["name"] and wl["chips"] == 1
    assert (ROOT / "port_bench" / "drivers"
            / f"{wl['driver']}.py").exists()
    assert set(wl["limits"]) == LIMITS
    for name in METRICS[cell]:
        assert (ROOT / "port_bench" / "metrics" / f"{name}.py").exists()
    cells = {w["name"]: w for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    mine = [m["name"] for m in BENCH["per_layer"]
            if cell in m["workloads"]]
    w = cells[cell]
    assert (w["traffic"], w["config"], w["chips"]) == (cell, cfg["name"], 1)
    for name in ("loop_frame_ms", "loop_frame_p95_ms"):
        assert cell in e2e[name]["workloads"]
    assert mine == METRICS[cell]


def test_limits_are_the_older_cells():
    street, _ = core.cell_files("loop_street600k_aeb")
    frozen, _ = core.cell_files("loop_frozen600k_yolo")
    for cell in (STREET, SEPARATE):
        limits = core.cell_files(cell)[0]["limits"]
        for name in ("image_max_gap", "image_mean_gap"):
            assert limits[name] == street["limits"][name] \
                == frozen["limits"][name]
        for name in ("cand_conf_gap", "cand_box_gap",
                     "decision_mismatches"):
            assert limits[name] == frozen["limits"][name]


def test_configurations():
    """The street YOLOv5s configuration is the street cell's scene and the
    frozen cell's YOLOv5s with what `loop_setup` applies; the separate
    cell runs the frozen configuration and traffic unchanged."""
    _, cfg = core.cell_files(STREET)
    _, street = core.cell_files("loop_street600k_aeb")
    frozen_wl, frozen = core.cell_files("loop_frozen600k_yolo")
    assert cfg["reduced"] == []
    for key in ("config", "scene", "sh_rest_sd", "fourier_sd",
                "track_noise", "sky_cubemap", "vehicles"):
        assert cfg[key] == street[key], key
    assert cfg["yolo"] == dict(frozen["yolo"], conf_thres=0.25,
                               objects_at_stop=8)
    assert cfg["yolov5_weights_path"].startswith("build/")
    wl, sep = core.cell_files(SEPARATE)
    assert sep == frozen
    assert {k: v for k, v in wl.items() if k not in ("driver", "why")} \
        == {k: v for k, v in frozen_wl.items() if k not in ("driver", "why")}


REHEARSAL = """
import json, sys
sys.path[0] = {root!r}
sys.path.insert(1, {tests!r})
from test_pb_perceived import SMALL
from port_bench import core
out = core.run_cell({cell!r}, {seed}, 0.01, True, "cpu",
                    overrides=SMALL[{cell!r}]())
print(json.dumps(dict(correct=out["correct"], attempted=out["attempted"],
                      metrics=out["metrics"],
                      banned=core.banned_modules(),
                      tops=sorted({{m.split(".")[0] for m in sys.modules}}))))
"""


@pytest.mark.parametrize("cell", [STREET, SEPARATE])
def test_small_traced_run_is_correct_and_loads_no_jax(cell):
    code = REHEARSAL.format(root=str(ROOT), tests=str(Path(__file__).parent),
                            cell=cell, seed=SEED)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900, cwd=ROOT,
                         env={"OMP_NUM_THREADS": "2", "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["attempted"] > 0
    assert out["banned"] == []
    assert "gaussianrpg_tpu_torch" in out["tops"]
    # the CPU trace holds no device record: the readers of device work
    # find nothing there, those of the host's spans and launches do
    assert set(out["metrics"]) <= set(METRICS[cell])
    if cell == STREET:
        assert "regrows in the window 0" in res.stderr
        assert "braked first at frame" in res.stderr
        assert "port_bench.step: 0 in 2 ranges" in res.stderr
    else:
        assert "handoff_host_ms.separate" in out["metrics"]
        assert "ros2.rgb8:" in res.stderr and "ros2.decode:" in res.stderr


def test_street_yolo_block_the_program_does_not_follow_is_refused():
    """A `yolo` block whose input size or threshold differs from what
    `loop_setup` applies stops the set-up, naming each difference, where
    the reference would otherwise silently follow another detector."""
    small = street_small()
    _, cfg = core.cell_files(STREET)
    small["yolo"] = dict(cfg["yolo"], input_hw=[64, 96], conf_thres=0.4)
    with pytest.raises(ValueError, match=r"input_hw \[64, 96\], \[384, "
                       r"640\].*conf_thres 0.4, 0.25"):
        core.run_cell(STREET, SEED, 0.01, False, "cpu", overrides=small)


def test_street_perception_thresholds_are_checked(monkeypatch):
    """A fused branch that keeps candidates above 0.3 instead of the
    configured 0.25, its signature unchanged, makes other decisions than
    the replay."""
    import functools

    from gaussianrpg_tpu_torch.sim import pipeline

    orig = pipeline.finish_detections

    @functools.wraps(orig)
    def higher(*a, **kw):
        return orig(*a, **dict(kw, conf_thres=0.3))

    monkeypatch.setattr(pipeline, "finish_detections", higher)
    out = run(STREET)
    assert not out["correct"]
    assert out["checks"]["decision_mismatches"]["value"] > 0


def test_street_overflow_is_rendered_again(monkeypatch):
    """The cell at a pair capacity probed 8 times too small stays correct:
    the fused branch renders the overflowing frames again."""
    from gaussianrpg_tpu_torch.render import renderer
    from gaussianrpg_tpu_torch.sim import pipeline

    orig = renderer.probe_scene_capacity

    def small(*a, **kw):
        o = orig(*a, **kw)
        return o.replace(capacity=o.capacity // 8)

    monkeypatch.setattr(renderer, "probe_scene_capacity", small)
    r0 = pipeline.regrows
    out = run(STREET)
    assert out["correct"], out["checks"]
    assert pipeline.regrows > r0


def test_separate_rounded_hand_off_is_caught(monkeypatch):
    """An rgb8 hand-off that rounds to the nearest level where the
    simulator node truncates hands YOLOv5s another image: its
    candidates leave the limits."""
    import numpy as np

    from gaussianrpg_tpu_torch.ros2 import simulator

    def rounded(rgb):
        return np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8) \
            .transpose(1, 2, 0).tobytes()

    monkeypatch.setattr(simulator, "rgb8_bytes", rounded)
    out = run(SEPARATE)
    assert not out["correct"]
    assert out["checks"]["cand_conf_gap"]["value"] > \
        out["checks"]["cand_conf_gap"]["limit"]


@pytest.mark.parametrize("cell", [STREET, SEPARATE])
def test_controls_each_fail_a_limit(cell):
    """bfloat16 YOLOv5s and, on the street, SH degree 1 leave the limits
    at the small size (TF32 changes nothing on the CPU)."""
    limits = core.cell_files(cell)[0]["limits"]
    rec = calibrate_perceived.readings(cell, SEED, 0.01, "cpu",
                                       SMALL[cell]())
    ok, checks = compare.judge(rec["program"], limits)
    assert ok, checks
    for name, nums in rec["controls"].items():
        if name == "tf32_yolo":
            continue
        ok, checks = compare.judge(dict(nums, decision_mismatches=0),
                                   limits)
        assert not ok, (name, checks)


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(ts, corr, tid=1):
    return ev("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid, corr=corr)


STREET_EVENTS = [
    ev("user_annotation", "ProfilerStep#3", 0, 300),
    # the driver's ranges: the step [0, 200) holds the render [0, 100)
    ev("user_annotation", "port_bench.step", 0, 200),
    ev("user_annotation", "port_bench.render", 0, 100),
    # render [0, 100) holds compose [0, 30), rasterize [30, 80), sky
    ev("user_annotation", "pipeline.render", 0, 100),
    ev("user_annotation", "scene.compose", 0, 30),
    ev("user_annotation", "scene.rasterize", 30, 50),
    ev("user_annotation", "scene.sky", 80, 20),
    ev("user_annotation", "pipeline.letterbox", 100, 10),
    ev("user_annotation", "pipeline.yolo", 110, 80),
    ev("user_annotation", "pipeline.topk", 190, 10),
    ev("user_annotation", "pipeline.fetch", 200, 50),
    launch(5, 1), launch(40, 2), launch(85, 3),
    launch(105, 4), launch(120, 5), launch(195, 6), launch(210, 7),
    ev("kernel", "compose_k", 10, 20, tid=7, corr=1),
    ev("kernel", "scatter_gather_elementwise_k", 50, 10, tid=7, corr=2),
    ev("kernel", "sky_k", 90, 5, tid=7, corr=3),
    ev("kernel", "resize_k", 110, 4, tid=7, corr=4),
    ev("kernel", "conv_k", 130, 40, tid=7, corr=5),
    ev("kernel", "topk_k", 196, 2, tid=7, corr=6),
    ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 215, 3, tid=7,
       corr=7),
]


def test_street_readers_on_a_recorded_trace():
    from port_bench.drivers import street_yolo_loop as d

    span_us, scatter = d.span_readings(STREET_EVENTS)
    assert span_us["pipeline.render"] == pytest.approx(35)
    assert span_us["scene.rasterize"] == pytest.approx(10)
    assert scatter == pytest.approx(10)
    summary = tr.summarize(STREET_EVENTS, (d.RENDER, d.STEP))
    trace = dict(frames=2, span_us=span_us, scatter_us=scatter,
                 summary=summary, render=d.RENDER, step=d.STEP,
                 counters={"compose": {"frames": 2, "slots": 2e6,
                                       "actors": 16}})
    read = {n: core.load_module(core.HERE / "metrics" / f"{n}.py").read
            for n in METRICS[STREET]}
    _, cfg = core.cell_files(STREET)
    counts = [type("C", (), dict(live_pair_pixels=1e6))()]
    ctx = dict(trace=trace, counts=counts, cfg=cfg, e2e={"loop_frame_ms": 50},
               peaks=core.peaks("NVIDIA H100 80GB HBM3"),
               roofline=core.roofline)
    # one step range: its launches outside the render's, 4 + 40 + 2 us
    assert read["perception_device_ms"](ctx) == pytest.approx(0.046)
    assert read["render_device_ms"](ctx) == pytest.approx(0.035)
    assert read["compose_device_ms.street"](ctx) == pytest.approx(0.01)
    assert read["rasterize_device_ms.street"](ctx) == pytest.approx(0.005)
    assert read["sky_device_ms.street"](ctx) == pytest.approx(0.0025)
    assert read["scatter_device_ms.street"](ctx) == pytest.approx(0.005)
    assert read["launches_per_frame"](ctx) == pytest.approx(3.5)
    assert read["device_busy_ms.loop"](ctx) == pytest.approx(0.042)
    mfu = read["street_yolo_mfu"](ctx)
    yolo = core.roofline("yolov5").flops(cfg["yolo"])
    assert 0 < mfu < 100
    assert mfu > 100 * yolo / (0.05 * ctx["peaks"]["fp32_flops_per_s"])
    # a program without the ranges, spans or counters: the readers of
    # ranges, spans, counters and counts find nothing
    bare = tr.summarize(STREET_EVENTS[:1] + STREET_EVENTS[11:],
                        (d.RENDER, d.STEP))
    empty = dict(trace=dict(frames=2, span_us={}, scatter_us=0.0,
                            summary=bare, render=d.RENDER, step=d.STEP,
                            counters={}),
                 counts=[], cfg=cfg, e2e={"loop_frame_ms": 50},
                 peaks=ctx["peaks"], roofline=core.roofline)
    assert all(read[n](empty) is None for n in METRICS[STREET]
               if n not in DEVICE and n != "launches_per_frame")


SEPARATE_EVENTS = [
    ev("user_annotation", "ProfilerStep#3", 0, 300),
    ev("user_annotation", "ros2.rgb8", 10, 40),
    ev("user_annotation", "ros2.decode", 60, 15),
    ev("user_annotation", "detector.yolo", 80, 100),
    ev("user_annotation", "detector.forward", 100, 60),
    ev("user_annotation", "port_bench.render", 195, 20),
    launch(90, 1), launch(110, 2), launch(150, 3), launch(200, 4),
    ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 95, 3, tid=7,
       corr=1),
    ev("kernel", "conv_k", 112, 30, tid=7, corr=2),
    ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 150, 5, tid=7,
       corr=3),
    ev("kernel", "render_k", 200, 50, tid=7, corr=4),
]


def test_separate_readers_on_a_recorded_trace():
    from port_bench.drivers import separate_loop as d

    host, handoff, det = d.handoff_readings(SEPARATE_EVENTS)
    assert host["ros2.rgb8"] == (40, 1) and handoff == pytest.approx(55)
    assert det == pytest.approx(38)
    read = {n: core.load_module(core.HERE / "metrics" / f"{n}.py").read
            for n in METRICS[SEPARATE]}
    trace = dict(frames=1, handoff_us=handoff, detector_us=det,
                 summary=tr.summarize(SEPARATE_EVENTS, (d.RENDER,)),
                 render=d.RENDER)
    ctx = dict(trace=trace, e2e={"loop_frame_ms": 0.5})
    assert read["handoff_host_ms.separate"](ctx) == pytest.approx(0.055)
    assert read["perception_device_ms.separate"](ctx) == pytest.approx(0.038)
    assert read["render_device_ms"](ctx) == pytest.approx(0.05)
    assert read["device_busy_ms.loop"](ctx) == pytest.approx(0.088)
    assert read["device_idle_share.loop"](ctx) == pytest.approx(82.4)
    assert read["launches_per_frame"](ctx) == 4
    # a program without the spans: the readers of spans find nothing
    _, none_h, none_d = d.handoff_readings(SEPARATE_EVENTS[:1]
                                           + SEPARATE_EVENTS[6:])
    assert none_h is None and none_d is None
    trace = dict(frames=1, handoff_us=none_h, detector_us=none_d)
    assert read["handoff_host_ms.separate"](dict(trace=trace)) is None
    assert read["perception_device_ms.separate"](dict(trace=trace)) is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [STREET, SEPARATE])
@pytest.mark.parametrize("seed", [31, 2**31 + 31])
def test_controls_fail_and_program_passes_at_full_size(cuda_card, cell,
                                                        seed):
    limits = core.cell_files(cell)[0]["limits"]
    rec = calibrate_perceived.readings(cell, seed, 0.1,
                                       overrides={"episode_s": 2.0})
    ok, checks = compare.judge(rec["program"], limits)
    assert ok, checks
    for name, nums in rec["controls"].items():
        ok, checks = compare.judge(dict(nums, decision_mismatches=0),
                                   limits)
        assert not ok, (name, checks)
