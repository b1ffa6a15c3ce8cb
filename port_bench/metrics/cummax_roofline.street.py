"""Kernel A (`csrc/cummax.cu`) on the composite scene: the least time the
card could take on the elements A read in the traced stretch
(`rooflines/cummax.py`; the program's counter `scan.elements`, k * P over
every slot of each array, advanced by a graph replay as by a launch) over
A's device time in the trace, in %: the bound of the mean launch over
the mean time of a kept record of A. Nothing when the trace or the
counters hold no A."""


def read(ctx):
    from port_bench.trace import kernel_us

    t, peaks = ctx["trace"], ctx["peaks"]
    us, n = kernel_us(t["summary"], "cummax_lookback")
    c = t.get("counters", {})
    launches, elements = c.get("cummax", 0), c.get("cummax_elements", 0)
    if not n or not launches or not elements or peaks is None:
        return None
    bound = ctx["roofline"]("cummax").bound_s(elements / launches, peaks)
    return 100.0 * bound / (us * 1e-6 / n)
