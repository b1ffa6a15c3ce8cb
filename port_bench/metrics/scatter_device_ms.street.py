"""Binning's scatter (`ops/binning._scatter_max`, PyTorch's
`scatter_reduce` kernel): the device time of the records whose kernel
name holds `scatter_gather_elementwise` among those launched inside the
program's `scene.rasterize` spans (a graph replay's kernels carry its
launch's correlation id and have no child spans), unioned, in ms a
traced frame. Nothing when the trace holds none."""


def read(ctx):
    t = ctx["trace"]
    us = t.get("scatter_us")
    return us * 1e-3 / t["frames"] if us else None
