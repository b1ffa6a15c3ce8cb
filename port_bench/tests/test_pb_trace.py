"""Reading a trace: the busy time as a union of device intervals, and a
`record_function` range's device time through the correlation ids of
the launches made inside it, on a hand-made event list."""
import pytest

from port_bench import trace as tr


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    # frame: step [0, 100) holds render [10, 50); the host launches
    # kernels 1, 2 in the render, 3 after it, 4 outside the step, and 5
    # on another thread inside the render's time
    ev("user_annotation", "step", 0, 100),
    ev("user_annotation", "render", 10, 40),
    ev("cuda_runtime", "cudaLaunchKernel", 12, 2, corr=1),
    ev("cuda_runtime", "cudaLaunchKernel", 30, 2, corr=2),
    ev("cuda_runtime", "cudaLaunchKernel", 60, 2, corr=3),
    ev("cuda_runtime", "cudaLaunchKernel", 150, 2, corr=4),
    ev("cuda_runtime", "cudaLaunchKernel", 20, 2, tid=2, corr=5),
    # the device runs them late, two of them overlapping
    ev("kernel", "a", 200, 30, tid=7, corr=1),
    ev("kernel", "b", 220, 30, tid=8, corr=2),
    ev("gpu_memcpy", "c", 300, 5, tid=7, corr=3),
    ev("kernel", "d", 400, 10, tid=7, corr=4),
    ev("kernel", "e", 500, 1, tid=7, corr=5),
]


def test_busy_time_is_a_union():
    assert tr.union_us([(0, 10), (5, 12), (20, 21)]) == 13
    s = tr.summarize(EVENTS)
    assert s["busy_us"] == 50 + 5 + 10 + 1
    assert s["launches"] == 5


def test_range_device_time_follows_the_launches():
    s = tr.summarize(EVENTS, ("render", "step"))
    render, n_render = s["ranges"]["render"]
    step, n_step = s["ranges"]["step"]
    assert (render, n_render) == ({1, 2}, 1)
    assert (step, n_step) == ({1, 2, 3}, 1)
    assert tr.range_busy_us(s, render) == pytest.approx(50)
    assert tr.range_busy_us(s, step - render) == pytest.approx(5)


def test_perception_and_render_readers():
    from port_bench import core

    s = tr.summarize(EVENTS, ("render", "step"))
    ctx = {"trace": dict(summary=s, frames=1, render="render",
                         step="step")}
    read = {n: core.load_module(core.HERE / "metrics" / f"{n}.py").read
            for n in ("render_device_ms", "perception_device_ms")}
    assert read["render_device_ms"](ctx) == pytest.approx(0.050)
    assert read["perception_device_ms"](ctx) == pytest.approx(0.005)
    empty = {"trace": dict(summary=tr.summarize(EVENTS[2:],
                                                ("render", "step")),
                           frames=1, render="render", step="step")}
    assert read["render_device_ms"](empty) is None
    assert read["perception_device_ms"](empty) is None
