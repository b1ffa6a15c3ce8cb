"""Renderer and rasterizer on the composite scene (the `rasterize` call in `render/renderer._render`: binning over every slot, the pair gather, kernels A and B, inside one CUDA graph replay when the path captures): the device time of the work launched inside the program's
`scene.rasterize` spans in the traced stretch (`spans.span_device_us`: the
union of the device records whose launches fall inside the spans on the
host thread, by correlation id), in ms a traced frame. Nothing when the
trace holds no such span."""


def read(ctx):
    t = ctx["trace"]
    us = t.get("span_us", {}).get("scene.rasterize")
    return us * 1e-3 / t["frames"] if us else None
