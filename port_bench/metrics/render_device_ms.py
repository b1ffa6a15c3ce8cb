"""Renderer and rasterizer (`ops/rasterize.py`, `ops/binning.py`, kernels A
and B): the device time of the work launched inside the render
callable's `record_function` range, in ms a traced frame: the union of
the device intervals of the kernels, copies and sets whose launches fall
inside it (`trace.range_ids`). Nothing when the trace holds no such
range."""


def read(ctx):
    from port_bench.trace import range_busy_us

    t = ctx["trace"]
    ids, n = t["summary"]["ranges"][t["render"]]
    if not n or not ids:
        return None
    return range_busy_us(t["summary"], ids) * 1e-3 / n
