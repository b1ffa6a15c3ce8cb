"""Reading the program's spans from a trace (`port_bench/spans.py`): host
times, the device time launched inside a span, the device's idle gaps
split by the innermost span open on the host, the copies and the clock
check, on a hand-made event list with values worked out by hand."""
import pytest

from port_bench import spans as sp


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(ts, corr, tid=1):
    return ev("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid, corr=corr)


EVENTS = [
    # one recorded step [0, 200) on host thread 1
    ev("user_annotation", "ProfilerStep#7", 0, 200),
    ev("user_annotation", "loop.tick", 0, 10),
    ev("user_annotation", "loop.camera", 10, 10),
    # perceive [20, 160) holds render [20, 100), which holds bin [40, 60)
    ev("user_annotation", "loop.perceive", 20, 140),
    ev("user_annotation", "pipeline.render", 20, 80),
    ev("user_annotation", "raster.bin", 40, 20),
    ev("user_annotation", "pipeline.fetch", 120, 30),
    ev("user_annotation", "loop.range", 170, 10),
    # the benchmark's own range is not a program span
    ev("user_annotation", "port_bench.render", 20, 80),
    # a span on another thread does not count
    ev("user_annotation", "loop.tick", 0, 50, tid=2),
    launch(15, 1),              # in camera: an upload
    launch(30, 2),              # in render
    launch(45, 3),              # in bin
    launch(50, 4),              # in bin
    launch(125, 5),             # in fetch: the candidates' copy
    launch(45, 6, tid=2),       # another thread's launch
    # the device: busy [16, 18), [35, 55) and [50, 65) overlapping,
    # [140, 145); idle [18, 35), [65, 140)
    ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 16, 2, tid=7,
       corr=1),
    ev("kernel", "render_k", 35, 10, tid=7, corr=2),
    ev("kernel", "bin_a", 45, 10, tid=7, corr=3),
    ev("kernel", "bin_b", 50, 15, tid=8, corr=4),
    ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 140, 5, tid=7,
       corr=5),
    ev("kernel", "other", 36, 1, tid=7, corr=6),
]


def test_span_host_times_on_the_host_thread():
    host = sp.span_host_us(EVENTS)
    assert host["loop.tick"] == (10, 1)
    assert host["loop.perceive"] == (140, 1)
    assert host["pipeline.render"] == (80, 1)
    assert host["raster.bin"] == (20, 1)
    assert host["pipeline.nms"] == (0, 0)
    assert "port_bench.render" not in host


def test_device_time_under_a_span_follows_the_correlation_ids():
    ids = sp.span_ids(EVENTS)
    assert ids["raster.bin"] == {3, 4}
    assert ids["pipeline.render"] == {2, 3, 4}
    assert ids["loop.camera"] == {1}
    dev = sp.span_device_us(EVENTS)
    # bin: [45, 55) and [50, 65) unioned; render adds [35, 45)
    assert dev["raster.bin"] == pytest.approx(20)
    assert dev["pipeline.render"] == pytest.approx(30)
    assert dev["pipeline.fetch"] == pytest.approx(5)
    assert dev["loop.tick"] == 0


IDLE = {"loop.camera": 7e-6, "pipeline.render": 50e-6, "raster.bin": 10e-6,
        "loop.perceive": 20e-6, "pipeline.fetch": 5e-6}


def test_an_idle_gap_is_split_between_nested_spans_and_unspanned():
    assert sp.device_gaps(EVENTS) == [(18, 35, 2), (65, 140, 5)]
    # each gap ends at the launch of the record that closes it: [18, 35)
    # at 30, so [13, 30): camera 7, render 10; [65, 140) at 125, so
    # [50, 125): bin 10, render 40, perceive 20, fetch 5
    assert dict(sp.idle_by_span(EVENTS)) == pytest.approx(IDLE)
    # a gap [145, 300) closed by a record with no launch keeps its times:
    # fetch [145, 150), perceive [150, 160), range [170, 180)
    late = EVENTS + [ev("kernel", "late", 300, 10, tid=7)]
    idle = dict(sp.idle_by_span(late))
    assert idle[sp.UNSPANNED] == pytest.approx(130e-6)
    assert idle["loop.range"] == pytest.approx(10e-6)
    assert idle["loop.perceive"] == pytest.approx(30e-6)
    assert sum(idle.values()) == pytest.approx((17 + 75 + 155) * 1e-6)


def test_a_device_clock_off_the_hosts_does_not_move_the_idle_split():
    # the clock check reads the trace's own times, and sees the shift:
    # 100 us ahead, 10 of the 11 (span, record) pairs start early; 40 us
    # behind, the candidates' copy ends after `pipeline.fetch`
    for shift, violations in ((-100, 10), (40, 1)):
        off = [dict(e, ts=e["ts"] + shift) if e["cat"] in sp.DEVICE_CATS
               else e for e in EVENTS]
        assert dict(sp.idle_by_span(off)) == pytest.approx(IDLE)
        assert sp.clock_violations(off) == violations


def test_innermost_spans_tile_the_host_timeline():
    segs = sp.innermost({"a": [(0, 100)], "b": [(10, 40), (60, 70)],
                         "c": [(20, 30)], "d": [(200, 210)]})
    assert segs == [(0, 10, "a"), (10, 20, "b"), (20, 30, "c"),
                    (30, 40, "b"), (40, 60, "a"), (60, 70, "b"),
                    (70, 100, "a"), (200, 210, "d")]


def test_copies_are_counted_between_card_and_host():
    assert sp.host_copies(EVENTS) == 2
    dtod = ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 150, 1,
              tid=7, corr=9)
    assert sp.host_copies(EVENTS + [dtod]) == 2


def test_clock_violations():
    assert sp.clock_violations(EVENTS) == 0
    # starts before raster.bin, inside render and perceive
    early = [dict(e, ts=25) if e.get("name") == "bin_a" else e
             for e in EVENTS]
    assert sp.clock_violations(early) == 1
    # starts before all three
    earlier = [dict(e, ts=19) if e.get("name") == "bin_a" else e
               for e in EVENTS]
    assert sp.clock_violations(earlier) == 3
    late_copy = [dict(e, ts=149) if e.get("name", "").startswith(
        "Memcpy DtoH") else e for e in EVENTS]   # ends at 154 > 150
    assert sp.clock_violations(late_copy) == 1
    # launch to start: 1, 5, 0, 0, 15 us on the host thread
    assert sp.launch_to_start_us(EVENTS) == (0, 1)
    assert sp.launch_to_start_us(earlier) == (-26, 1)


def test_host_cover_and_stretch():
    assert sp.stretch(EVENTS) == (0, 200, 1)
    # spans cover [0, 160) and [170, 180) of [0, 200)
    assert sp.host_cover(EVENTS) == pytest.approx(170 / 200)


def test_a_span_open_when_the_profiler_stops_is_cut_to_the_stretch():
    # the next frame's perceive span, entered at 190, recorded whole
    late = EVENTS + [ev("user_annotation", "loop.perceive", 190, 500)]
    assert sp.span_host_us(late)["loop.perceive"] == (140 + 10, 2)
    assert sp.host_cover(late) == pytest.approx(180 / 200)


def test_the_eight_readings():
    r = sp.readings(EVENTS, frames=2)
    # a reading whose spans are not all there is left out
    assert set(r) == {"frame_head_host_ms", "render_host_ms",
                      "fetch_wait_ms", "host_copies_per_frame"}
    assert r["frame_head_host_ms"] == pytest.approx(0.010)
    assert r["render_host_ms"] == pytest.approx(0.040)
    assert r["fetch_wait_ms"] == pytest.approx(0.015)
    assert r["host_copies_per_frame"] == 1
    full = EVENTS + [ev("user_annotation", n, t, 4) for n, t in
                     (("pipeline.nms", 152), ("loop.aeb", 185),
                      ("pipeline.letterbox", 100), ("pipeline.yolo", 105),
                      ("pipeline.topk", 110), ("raster.gather", 62),
                      ("raster.sort", 22))]
    r = sp.readings(full, frames=2)
    assert len(r) == 8
    assert r["host_tail_ms"] == pytest.approx((4 + 10 + 4) * 1e-3 / 2)
    assert r["perception_host_ms"] == pytest.approx(12e-3 / 2)
    assert r["gather_device_ms"] == 0
    # raster.sort [22, 26) launched nothing: binning is bin's alone
    assert r["binning_device_ms"] == pytest.approx(0.010)


def test_a_trace_without_program_spans_reads_nothing():
    bare = [e for e in EVENTS if e["cat"] != "user_annotation"
            or e["name"].startswith(sp.STEP_PREFIX)]
    assert sp.readings(bare, frames=1) == {}
    assert sp.idle_by_span(bare) == [[sp.UNSPANNED, 92e-6]]
    assert sp.clock_violations(bare) == 0
