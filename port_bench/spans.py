"""The program's own spans in a traced run (`gaussianrpg_tpu_torch/utils/
spans.py`: `record_function` ranges on the profiler's clock), read from
the trace's events, and a report of them on the loop cell's traced
stretch:

    python3 -m port_bench.spans --workload loop_frozen600k_yolo \\
        --seed <n> --seconds <s> [--events FILE.json.gz]

runs the cell as `run.py --trace 1` does (its set-up, window, traced
stretch and check, unchanged) and prints one JSON line: that run's
result, the window's end-to-end numbers, and the readings below, with on
stderr the count of clock violations. `--events` keeps the traced
stretch's events.

Readers (every time in us, on the trace's clock):
- `span_host_us`: each span's host time and count on the host thread
  (the thread that holds the most program spans);
- `span_device_us`: the device time of the work launched inside each
  span, by correlation id as `trace.range_ids` finds it, unioned;
- `idle_by_span`: every device idle gap of the stretch, put on the
  host's clock through the launch that ends it, split by the innermost
  program span open on the host thread during each part of it,
  `unspanned` where none is;
- `host_copies`: the copy records between card and host;
- `clock_violations`: device records that start before the span they
  were launched in, and candidates' copies that end after
  `pipeline.fetch`; `launch_to_start_us`, how far the device's records
  sit after (or, where the clocks disagree, before) their launches;
- `readings`: the eight per-frame numbers these give (`READINGS`).
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import gzip
import json
import sys
import time
from collections import defaultdict

from .trace import DEVICE_CATS, HOST_CATS, _corr, union_us

LOOP = ("loop.tick", "loop.camera", "loop.perceive", "loop.range",
        "loop.aeb")
PIPELINE = ("pipeline.render", "pipeline.letterbox", "pipeline.yolo",
            "pipeline.topk", "pipeline.fetch", "pipeline.nms")
RASTER = ("raster.fields", "raster.sort", "raster.bin", "raster.gather",
          "raster.blend")
PROGRAM_SPANS = LOOP + PIPELINE + RASTER
UNSPANNED = "unspanned"
STEP_PREFIX = "ProfilerStep#"

# reading: (host or device time, the spans it sums); `host_copies_per_frame`
# counts copy records
READINGS = {
    "frame_head_host_ms": ("host", ("loop.tick", "loop.camera")),
    "render_host_ms": ("host", ("pipeline.render",)),
    "perception_host_ms": ("host", ("pipeline.letterbox", "pipeline.yolo",
                                    "pipeline.topk")),
    "fetch_wait_ms": ("host", ("pipeline.fetch",)),
    "host_tail_ms": ("host", ("pipeline.nms", "loop.range", "loop.aeb")),
    "binning_device_ms": ("device", ("raster.sort", "raster.bin")),
    "gather_device_ms": ("device", ("raster.gather",)),
}


def _annotations(events, names):
    """{tid: {name: [(start, end)]}} of the user annotations in `names`."""
    out = defaultdict(lambda: defaultdict(list))
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in names:
            a = float(e["ts"])
            b = a + float(e.get("dur", 0.0))
            out[e.get("tid")][e["name"]].append((a, b))
    return out


def span_intervals(events, names=PROGRAM_SPANS) -> tuple:
    """(host thread, {name: sorted [(start, end)]}) of the program's spans
    on the thread that holds the most of them, cut to the profiler's
    recorded steps where the trace has them: a span still open when the
    profiler stops is recorded whole, past the stretch's end."""
    by_tid = _annotations(events, set(names))
    if not by_tid:
        return None, {n: [] for n in names}
    tid = max(by_tid, key=lambda t: sum(map(len, by_tid[t].values())))
    t0, t1, _ = stretch(events)
    if t0 is None:
        t0, t1 = float("-inf"), float("inf")
    return tid, {n: sorted((max(a, t0), min(b, t1))
                           for a, b in by_tid[tid].get(n, ()) if b > t0
                           and a < t1) for n in names}


def span_host_us(events, names=PROGRAM_SPANS) -> dict:
    """{name: (host us summed over its spans, number of spans)}."""
    _, ivs = span_intervals(events, names)
    return {n: (sum(b - a for a, b in v), len(v)) for n, v in ivs.items()}


def _launches(events, tid):
    """(sorted start times, correlation ids) of the host's launch calls on
    `tid`."""
    host = sorted((float(e["ts"]), _corr(e)) for e in events
                  if e.get("cat") in HOST_CATS and e.get("tid") == tid
                  and _corr(e) is not None)
    return [t for t, _ in host], [c for _, c in host]


def _device_by_corr(events):
    out = defaultdict(list)
    for e in events:
        if e.get("cat") in DEVICE_CATS and _corr(e) is not None:
            a = float(e["ts"])
            out[_corr(e)].append((a, a + float(e.get("dur", 0.0)), e))
    return out


def _ids_inside(times, ids, a, b):
    return ids[bisect.bisect_left(times, a):bisect.bisect_right(times, b)]


def span_ids(events, names=PROGRAM_SPANS) -> dict:
    """{name: correlation ids of the launch calls made inside its spans on
    the host thread}."""
    tid, ivs = span_intervals(events, names)
    times, ids = _launches(events, tid)
    return {n: {c for a, b in v for c in _ids_inside(times, ids, a, b)}
            for n, v in ivs.items()}


def device_us(by_corr: dict, ids) -> float:
    """The union of the device intervals of these correlation ids."""
    return union_us((a, b) for c in ids for a, b, _ in by_corr.get(c, ()))


def span_device_us(events, names=PROGRAM_SPANS) -> dict:
    """{name: union us of the device records launched inside its spans}."""
    by_corr = _device_by_corr(events)
    return {n: device_us(by_corr, ids)
            for n, ids in span_ids(events, names).items()}


def innermost(ivs: dict) -> list:
    """Disjoint [(start, end, name)] of the innermost span open at each
    time, from properly nested spans ({name: [(start, end)]})."""
    spans = sorted(((a, b, n) for n, v in ivs.items() for a, b in v),
                   key=lambda s: (s[0], -s[1]))
    out, stack, t = [], [], float("-inf")

    def close_until(limit):
        nonlocal t
        while stack and stack[-1][1] <= limit:
            a, b, n = stack.pop()
            if t < b:
                out.append((t, b, n))
                t = b

    for a, b, n in spans:
        close_until(a)
        if stack and t < a:
            out.append((t, a, stack[-1][2]))
        stack.append((a, b, n))
        t = max(t, a)
    close_until(float("inf"))
    return out


def device_gaps(events) -> list:
    """[(start, end, correlation id of the record that ends it)] of the
    device's idle gaps between its first and last record (kernels, copies
    and sets on every stream unioned)."""
    dev = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                   _corr(e)) for e in events if e.get("cat") in DEVICE_CATS),
                 key=lambda r: r[:2])
    gaps, end = [], None
    for a, b, c in dev:
        if end is not None and a > end:
            gaps.append((end, a, c))
        end = b if end is None else max(end, b)
    return gaps


def idle_by_span(events, names=PROGRAM_SPANS) -> list:
    """[[span, seconds]] of the device's idle time, each part of each gap
    put down to the innermost program span open on the host thread then
    (`unspanned` where none is), largest first.

    A gap is put on the host's clock through the launch call of the
    record that ends it: the card idles until the host launches that
    record. So a device clock that runs ahead of or behind the host's
    (`launch_to_start_us` below zero) does not move the split. A gap
    whose closing record was not launched on the host thread keeps the
    trace's times."""
    tid, ivs = span_intervals(events, names)
    times, ids = _launches(events, tid)
    at = dict(zip(ids, times))
    segs = innermost(ivs)
    starts = [s[0] for s in segs]
    out = defaultdict(float)
    for g0, g1, c in device_gaps(events):
        if c in at:
            g0, g1 = at[c] - (g1 - g0), at[c]
        covered = 0.0
        i = max(0, bisect.bisect_right(starts, g0) - 1)
        while i < len(segs) and segs[i][0] < g1:
            a, b, n = segs[i]
            part = min(b, g1) - max(a, g0)
            if part > 0:
                out[n] += part
                covered += part
            i += 1
        out[UNSPANNED] += (g1 - g0) - covered
    return [[n, us * 1e-6] for n, us in
            sorted(out.items(), key=lambda kv: -kv[1]) if us > 0]


def host_copies(events) -> int:
    """Copy records between card and host (`Memcpy HtoD` / `DtoH`)."""
    return sum(1 for e in events if e.get("cat") == "gpu_memcpy"
               and any(k in e.get("name", "") for k in ("HtoD", "DtoH")))


def clock_violations(events, names=PROGRAM_SPANS) -> int:
    """Device records that start before the span their launch was made in
    starts, and device-to-host copies launched in `pipeline.fetch` that
    end after it ends: 0 when the spans and the device records share
    one clock."""
    tid, ivs = span_intervals(events, names)
    times, ids = _launches(events, tid)
    by_corr = _device_by_corr(events)
    bad = 0
    for n, v in ivs.items():
        for a, b in v:
            for c in _ids_inside(times, ids, a, b):
                for da, db, e in by_corr.get(c, ()):
                    bad += da < a
                    bad += (n == "pipeline.fetch" and "DtoH" in e["name"]
                            and db > b)
    return bad


def launch_to_start_us(events) -> tuple:
    """(least, median) us from a launch call on the host thread to the
    start of the device record it launched. A negative least means the
    device's records ran ahead of the host's clock in this trace."""
    tid, _ = span_intervals(events)
    times, ids = _launches(events, tid)
    at = dict(zip(ids, times))
    lat = sorted(da - at[c] for c, recs in _device_by_corr(events).items()
                 if c in at for da, _, _ in recs)
    if not lat:
        return None, None
    return lat[0], lat[len(lat) // 2]


def stretch(events) -> tuple:
    """(start, end, steps) of the profiler's recorded steps."""
    steps = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(STEP_PREFIX)]
    if not steps:
        return None, None, 0
    return min(a for a, _ in steps), max(b for _, b in steps), len(steps)


def host_cover(events, names=PROGRAM_SPANS) -> float | None:
    """The share of the recorded steps' wall time that program spans
    cover on the host thread."""
    t0, t1, _ = stretch(events)
    if t0 is None or t1 <= t0:
        return None
    _, ivs = span_intervals(events, names)
    return union_us(iv for v in ivs.values() for iv in v) / (t1 - t0)


def readings(events, frames: int) -> dict:
    """The eight per-frame readings (ms, copies) of the traced stretch's
    `frames` frames; a reading whose spans the trace lacks is left out."""
    host = span_host_us(events)
    ids = span_ids(events)
    by_corr = _device_by_corr(events)
    out = {}
    for name, (kind, spans) in READINGS.items():
        if not all(host[s][1] for s in spans):
            continue
        us = (sum(host[s][0] for s in spans) if kind == "host" else
              device_us(by_corr, set().union(*(ids[s] for s in spans))))
        out[name] = us * 1e-3 / frames
    if any(n for _, n in host.values()):
        out["host_copies_per_frame"] = host_copies(events) / frames
    return out


# -- the report --------------------------------------------------------

@contextlib.contextmanager
def _kept():
    """Keep the traced stretch's events and the window's end-to-end
    numbers of a `core.run_cell` inside this block."""
    from . import core, trace

    kept = {}
    export, make = trace.export_events, core.make_cell

    def export_kept(prof):
        kept["events"] = export(prof)
        return kept["events"]

    def make_kept(*a, **kw):
        run, wl, cfg = make(*a, **kw)
        window = run.window

        def window_kept(seconds):
            kept["e2e"] = window(seconds)
            return kept["e2e"]

        run.window = window_kept
        return run, wl, cfg

    trace.export_events, core.make_cell = export_kept, make_kept
    try:
        yield kept
    finally:
        trace.export_events, core.make_cell = export, make


def span_cost_us(n: int = 20_000) -> dict:
    """The cost of entering and leaving one `span()`, in us: `off` with no
    profiler running (the gate alone), `on` under a profiler that traces
    the host and the card, as `traced()` runs it; None for a program
    without spans."""
    from torch.profiler import ProfilerActivity, profile

    try:
        from gaussianrpg_tpu_torch.utils.spans import span
    except ImportError:
        return None

    def each():
        t = time.perf_counter()
        for _ in range(n):
            with span("cost"):
                pass
        return (time.perf_counter() - t) * 1e6 / n

    off = each()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = each()
    return dict(off=off, on=on)


def report(events, result: dict) -> dict:
    """The spans' readings of one traced run beside its result line."""
    _, _, frames = stretch(events)
    host = span_host_us(events)
    dev = span_device_us(events)
    idle = idle_by_span(events)
    idle_s = sum(s for _, s in idle)
    unspanned = sum(s for n, s in idle if n == UNSPANNED)
    render = result["metrics"].get("render_device_ms", {}).get("value")
    in_render = dev["pipeline.render"] * 1e-3 / frames if frames else None
    return dict(
        frames=frames, readings=readings(events, frames),
        idle_by_span=idle,
        unspanned_idle_share=unspanned / idle_s if idle_s else None,
        host_cover_share=host_cover(events),
        clock_violations=clock_violations(events),
        launch_to_start_us=launch_to_start_us(events),
        spans_per_frame={n: k / frames for n, (_, k) in host.items()},
        host_ms={n: us * 1e-3 / frames for n, (us, _) in host.items()},
        device_ms={n: us * 1e-3 / frames for n, us in dev.items()},
        render_span_vs_range=(in_render / render if render and in_render
                              else None),
        traced_frame_ms=result["device"]["window_s"] * 1e3 / frames
        if frames else None,
        span_cost_us=span_cost_us())


def main(argv=None) -> int:
    from . import core

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="loop_frozen600k_yolo")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--events", default=None,
                   help="write the traced stretch's events here (gzip)")
    a = p.parse_args(argv)
    print(f"port_bench.spans: {core.smi_line()}", file=sys.stderr)
    with _kept() as kept:
        out = core.run_cell(a.workload, a.seed, a.seconds, True)
    events = kept["events"]
    if a.events:
        with gzip.open(a.events, "wt") as f:
            json.dump(events, f)
    out["e2e"] = kept["e2e"]
    out["spans"] = report(events, out)
    print(f"port_bench.spans: clock violations "
          f"{out['spans']['clock_violations']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
