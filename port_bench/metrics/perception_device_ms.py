"""Perception (`sim/pipeline.py`, `sim/yolo.py`): the device time of the
work the fused step launched outside the render callable (letterbox,
YOLOv5, top-K), in ms a traced frame: the union of the device intervals
of the kernels, copies and sets whose launches fall inside the step's
`record_function` range and outside the render's (`trace.range_ids`).
Nothing when the trace holds no such range."""


def read(ctx):
    from port_bench.trace import range_busy_us

    t = ctx["trace"]
    r = t["summary"]["ranges"]
    (step, n), (render, _) = r[t["step"]], r[t["render"]]
    if not n or not step - render:
        return None
    return range_busy_us(t["summary"], step - render) * 1e-3 / n
