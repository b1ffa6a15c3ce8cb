"""Kernel B (`csrc/blend_fwd.cu`) on the composite scene: the least time
the card could take on the traced frames' inputs (`rooflines/blend_fwd.py`,
the counts from the plain reference on those same frames) over B's device
time in the trace, in %: the mean bound a frame over B's time a frame,
taken as the mean time a kept record of B times the launches of B a
frame (the program's counter `blend.launches`). Nothing when the trace
holds no B record."""


def read(ctx):
    from port_bench.trace import kernel_us

    t, peaks = ctx["trace"], ctx["peaks"]
    us, n = kernel_us(t["summary"], "blend_fwd")
    launches = t.get("counters", {}).get("blend", 0)
    if not n or not launches or peaks is None or not ctx["counts"]:
        return None
    rl = ctx["roofline"]("blend_fwd")
    bounds = [rl.bound_s(c, peaks) for c in ctx["counts"]]
    per_frame_s = us * 1e-6 / n * launches / t["frames"]
    return 100.0 * (sum(bounds) / len(bounds)) / per_frame_s
