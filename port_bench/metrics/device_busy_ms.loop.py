"""The device (one card) in the closed loop: the union of the kernel, copy
and set intervals in the traced stretch, in ms a rendered frame. The
card's own work, which the host's pace does not stretch: steadier from
run to run than the frame's wall time."""


def read(ctx):
    t = ctx["trace"]
    return t["summary"]["busy_us"] * 1e-3 / t["frames"]
