"""Scene graph (`models/scene_graph.compose`: the SH 3 colours, actor poses and Fourier DC of every slot): the device time of the work launched inside the program's
`scene.compose` spans in the traced stretch (`spans.span_device_us`: the
union of the device records whose launches fall inside the spans on the
host thread, by correlation id), in ms a traced frame. Nothing when the
trace holds no such span."""


def read(ctx):
    t = ctx["trace"]
    us = t.get("span_us", {}).get("scene.compose")
    return us * 1e-3 / t["frames"] if us else None
