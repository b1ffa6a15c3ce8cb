"""Host dispatch (`sim/loop.py`, `sim/pipeline.py`): the host's kernel-launch
calls (`cudaLaunchKernel` and its driver and `ExC` forms) in the traced
stretch, from the trace's runtime and driver records, which the profiler
keeps whole, over the stretch's rendered frames."""


def read(ctx):
    t = ctx["trace"]
    return t["summary"]["launches"] / t["frames"]
