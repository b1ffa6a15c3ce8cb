"""The port's spans (`utils/spans.py`) on the CPU: off, `span()` is one
shared null context and records nothing; under `torch.profiler` the
fused closed loop of `test_torch_perception.py` records every loop,
pipeline and rasterizer span, so many a frame and each inside its
parent; the unfused loop records its own; and the loop's result is the
same with the profiler on and off. `apps/profile_trace` takes the
device's busy time as a union of intervals."""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from gaussianrpg_tpu_torch.apps import profile_trace
from gaussianrpg_tpu_torch.apps import simulate as tsim
from gaussianrpg_tpu_torch.sim.detector import (VEHICLE_CLASSES,
                                                normalized_boxes)
from gaussianrpg_tpu_torch.sim.loop import run_closed_loop
from gaussianrpg_tpu_torch.sim.pipeline import (finish_detections,
                                                make_fused_step)
from gaussianrpg_tpu_torch.utils.spans import span
from gaussianrpg_tpu_torch.utils.synthetic import (red_blob_predict,
                                                   red_lead_setup)

from .torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)

H, W = 80, 128
FRAMES = 3
KW = dict(brake_distance=15.0, collision_threshold=5.0, simulation_time=3.5,
          cam_height=1.3, max_ticks=5 * FRAMES)
LOOP = ("loop.tick", "loop.camera", "loop.perceive", "loop.range",
        "loop.aeb")
PIPELINE = ("pipeline.render", "pipeline.letterbox", "pipeline.yolo",
            "pipeline.topk", "pipeline.fetch", "pipeline.nms")
RASTER = ("raster.fields", "raster.sort", "raster.bin", "raster.gather",
          "raster.blend")


def spans_of(prof, tmp_path) -> dict:
    """{name: [(start, end)]} of the trace's user annotations."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation":
            a = float(e["ts"])
            out.setdefault(e["name"], []).append((a, a + float(e["dur"])))
    return out


def inside(iv, parents) -> bool:
    return any(a <= iv[0] and iv[1] <= b for a, b in parents)


@pytest.fixture(scope="module")
def fused():
    tape, render_rgb, cam0, gt, v2c = red_lead_setup(W, H, device="cpu")
    step, gain, pad = make_fused_step(
        render_rgb, None, None, (H, W), size=(48, 80), k=8,
        classes=VEHICLE_CLASSES, predict_fn=red_blob_predict)

    def perceive(cam):
        det = finish_detections(step(cam), gain, pad, (H, W),
                                conf_thres=0.4)
        return normalized_boxes(det, H, W)

    def run():
        return run_closed_loop(tape, None, None, cam0, gt,
                               perceive_fn=perceive, ranger_extrinsic=v2c,
                               **KW)

    return run


def same_result(a, b):
    assert (a.verdict, a.ticks, a.frames_rendered) == (
        b.verdict, b.ticks, b.frames_rendered)
    assert a.min_gt_distance == b.min_gt_distance
    assert a.log == b.log
    assert len(a.frame_seconds) == len(b.frame_seconds)


def test_off_a_span_is_one_null_context_and_records_nothing(tmp_path):
    assert not torch.autograd._profiler_enabled()
    assert span("loop.tick") is span("raster.blend")
    with span("loop.tick") as entered:
        assert entered is None
    # the profiler's wait and warm-up steps are off too: nothing of them
    # is kept
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=1, warmup=1, active=1,
                                   repeat=1)) as prof:
        for name in ("waiting", "warming", "active"):
            with span(name):
                torch.ones(2).sum()
            prof.step()
    names = spans_of(prof, tmp_path)
    assert "active" in names
    assert "waiting" not in names and "warming" not in names


def test_fused_loop_records_every_span_once_a_frame(fused, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fused()
    assert res.frames_rendered == FRAMES and res.ticks == 5 * FRAMES
    got = spans_of(prof, tmp_path)
    counts = {n: len(got.get(n, ())) for n in LOOP + PIPELINE + RASTER}
    assert counts == {n: (5 if n == "loop.tick" else 1) * FRAMES
                      for n in counts}
    for n in RASTER:
        assert all(inside(iv, got["pipeline.render"]) for iv in got[n]), n
    for n in PIPELINE:
        assert all(inside(iv, got["loop.perceive"]) for iv in got[n]), n
    # the frame's steps follow one another, none inside another
    for a, b in zip(("loop.camera", "loop.perceive", "loop.range"),
                    ("loop.perceive", "loop.range", "loop.aeb")):
        for x, y in zip(got[a], got[b]):
            assert x[1] <= y[0], (a, b)


def test_loop_result_is_the_same_with_the_profiler_on(fused):
    off = fused()
    with profile(activities=[ProfilerActivity.CPU]):
        on = fused()
    same_result(on, off)


def test_unfused_loop_records_its_spans(tmp_path):
    tape, render_fn, det, cam0, gt, v2c = tsim._synthetic_setup(
        128, 80, n_background=200, bkgd_capacity=256, device="cpu")
    kw = dict(brake_distance=18.0, collision_threshold=4.0,
              simulation_time=3.0, max_ticks=5 * FRAMES, cam_height=1.1)
    off = run_closed_loop(tape, render_fn, det, cam0, gt,
                          ranger_extrinsic=v2c, **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = run_closed_loop(tape, render_fn, det, cam0, gt,
                             ranger_extrinsic=v2c, **kw)
    same_result(on, off)
    got = spans_of(prof, tmp_path)
    for n in ("loop.camera", "loop.perceive", "loop.range", "loop.aeb"):
        assert len(got[n]) == FRAMES, n
    assert len(got["loop.tick"]) == 5 * FRAMES
    # the render inside the perceive span, no fused pipeline
    assert all(inside(iv, got["loop.perceive"])
               for iv in got["raster.blend"])
    assert "pipeline.render" not in got


def test_profile_trace_counts_overlapping_device_work_once():
    assert profile_trace._union_us([]) == 0
    assert profile_trace._union_us([(0, 10), (5, 12), (20, 21)]) == 13
    assert profile_trace._union_us([(0, 10), (2, 3), (10, 11)]) == 11
