"""Sky (`models/sky.render_sky` and the composite rgb + sky (1 - alpha) in `render/renderer._render`): the device time of the work launched inside the program's
`scene.sky` spans in the traced stretch (`spans.span_device_us`: the
union of the device records whose launches fall inside the spans on the
host thread, by correlation id), in ms a traced frame. Nothing when the
trace holds no such span."""


def read(ctx):
    t = ctx["trace"]
    us = t.get("span_us", {}).get("scene.sky")
    return us * 1e-3 / t["frames"] if us else None
