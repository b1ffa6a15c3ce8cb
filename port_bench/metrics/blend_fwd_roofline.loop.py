"""Kernel B (`csrc/blend_fwd.cu`) in the closed loop: the least time the
card could take on the traced frames' inputs (`rooflines/blend_fwd.py`,
the counts from the reference on those same frames) over B's device time
in the trace, in %: the mean bound a frame over B's time a frame, taken
as the mean time a kept record of B times the launches of B a frame
(`ops.blend.launches`), so a dropped record does not count as time
saved. The frames' other stages are not counted. Nothing when the trace
holds no B record."""


def read(ctx):
    from port_bench.trace import kernel_us

    t, peaks = ctx["trace"], ctx["peaks"]
    us, n = kernel_us(t["summary"], "blend_fwd")
    if not n or peaks is None:
        return None
    rl = ctx["roofline"]("blend_fwd")
    bounds = [rl.bound_s(c, peaks) for c in ctx["counts"]]
    per_frame_s = us * 1e-6 / n * t["blend_launches"] / t["frames"]
    return 100.0 * (sum(bounds) / len(bounds)) / per_frame_s
