"""Reading a `torch.profiler` trace of the card (a chrome trace written
under TMPDIR and deleted once read): the device's busy time as the union
of its kernel, copy and set intervals (two streams that overlap count
once), device time by name, the host's launch calls, the idle gaps
labelled by the kernel that ended them, and the device time of the work
launched inside named `record_function` ranges.

A range's device work is found through the trace's correlation ids: the
host's launch calls (runtime and driver records) that start inside one
of the range's intervals on the same thread, and the device records that
carry their ids. Its time is the union of those records' intervals, so
the host's pace, which stretches the range, does not enter it."""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


def export_events(prof) -> list:
    """The trace's events, through a file under TMPDIR that is removed."""
    with tempfile.TemporaryDirectory(prefix="port_bench_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _corr(e):
    return (e.get("args") or {}).get("correlation")


def range_ids(events: list, names) -> dict:
    """{range name: (correlation ids launched inside it, intervals)}."""
    spans = {n: [] for n in names}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in spans:
            a = float(e["ts"])
            spans[e["name"]].append((a, a + float(e.get("dur", 0.0)),
                                     e.get("tid")))
    host = [(float(e["ts"]), e.get("tid"), _corr(e)) for e in events
            if e.get("cat") in HOST_CATS and _corr(e) is not None]
    out = {}
    for name, ivs in spans.items():
        ids = {c for t, tid, c in host
               if any(a <= t <= b and tid == ti for a, b, ti in ivs)}
        out[name] = (ids, len(ivs))
    return out


def summarize(events: list, ranges=(), top: int = 10) -> dict:
    """busy_us, device time by name, launch calls, the idle gaps, and for
    each name in `ranges` the correlation ids launched inside it
    (`range_busy_us` unions their device time)."""
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
            e["name"]) for e in events if e.get("cat") in DEVICE_CATS]
    by_corr = defaultdict(list)
    for e in events:
        if e.get("cat") in DEVICE_CATS and _corr(e) is not None:
            a = float(e["ts"])
            by_corr[_corr(e)].append((a, a + float(e.get("dur", 0.0))))
    by_name, n_by_name = defaultdict(float), defaultdict(int)
    for a, b, name in dev:
        by_name[name] += b - a
        n_by_name[name] += 1
    launches = sum(1 for e in events if e.get("cat") in HOST_CATS
                   and "LaunchKernel" in e.get("name", ""))
    gaps = defaultdict(float)
    end = None
    for a, b, name in sorted(dev):
        if end is not None and a > end:
            gaps["before " + name[:80]] += a - end
        end = b if end is None else max(end, b)
    rank = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(busy_us=union_us((a, b) for a, b, _ in dev),
                by_name=dict(by_name), n_by_name=dict(n_by_name),
                launches=launches,
                device_ops=[[n[:120], us * 1e-6] for n, us in rank[:top]],
                idle_gaps=[[n, us * 1e-6] for n, us in
                           sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
                n_device=len(dev), by_corr=dict(by_corr),
                ranges={n: (ids, k) for n, (ids, k)
                        in range_ids(events, ranges).items()})


def range_busy_us(summary: dict, ids) -> float:
    """The union of the device intervals of these correlation ids."""
    return union_us(iv for c in ids for iv in summary["by_corr"].get(c, ()))


def kernel_us(summary: dict, fragment: str) -> tuple[float, int]:
    """Device us and record count of the kernels whose name holds
    `fragment`."""
    names = [k for k in summary["by_name"] if fragment in k]
    return (sum(summary["by_name"][k] for k in names),
            sum(summary["n_by_name"][k] for k in names))
