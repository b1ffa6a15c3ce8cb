"""One CUDA graph of `rasterize`'s eval path, captured once per call
signature and then replayed, so the host issues one graph launch a frame
in place of the path's ~600 kernel launches.

`rasterize.rasterize` hands every call to `run`. A call engages the graph
(`engages`) on the card, with no training hooks, no input that needs grad
while grad mode is on, no mesh axis and the stream not already capturing;
every other call, and every call inside `eager()`, runs the eager path.
`key` holds everything of an engaging call that shapes the work. A key
met for the first time runs eagerly. The same key on the next call warms
up on a side stream, then captures into a `torch.cuda.CUDAGraph`; later
calls with that key replay it. A key that does not repeat on consecutive
calls (two cameras in turns) runs eagerly, as before.

One graph is held at a time: a key that is captured frees the graph
before it. What it holds, for the life of the process, is the graph's
private memory pool (one render's working set) and its input buffers (a
copy of the scene's tensors); a caller that stops rendering, or goes on
to another scene, frees both with `release()`.

Each replay copies every tensor input (the scene's and the camera's
three matrices) into the graph's buffers, so a replay reads what the
call passed, whoever owns it, and returns tensors that are the caller's:
the planes are cloned once (one `cat`, of which `color`, `depth`,
`alpha` and `semantic` are views), and `radii`, `means2d`, `overflow`,
`n_pairs` are cloned.

`graph_counts` says how often each route was taken. A replay launches no
kernel from the host, so the kernel wrappers' counters `blend.launches`
and `scan.launches` (and `scan.elements`, the k * P kernel A read), and
binning's `scatter_counts["calls"]` and `["entries"]`, advance on each
replay by what the capture ran, and keep counting the kernels the card
runs (chip_smoke.py holds the first two to the kernel records of a
profiler trace). Binning's superseded tally lives on the card and
advances inside the replay by itself: the warm-up run makes it before
the capture, so the graph adds to it and does not make it anew. A replay
is one `raster.graph` span (utils/spans.py); the `raster.*` spans of the
captured path are not recorded on replay.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..utils.spans import span
from . import binning, blend, scan

# rasterize's tensor inputs that the graph may read (the hooks never
# reach it)
TENSORS = ("means3d", "opacities", "bg_color", "colors", "shs", "semantics",
           "scales", "rotations", "cov3d_precomp", "active_mask")
CAMERA = ("viewmatrix", "projmatrix", "cam_center")

graph_counts = {"captures": 0, "replays": 0, "eager": 0}


@dataclasses.dataclass
class _Held:
    key: tuple
    graph: torch.cuda.CUDAGraph
    buffers: dict       # input name -> the buffer each call copies into
    cam_buffers: dict   # camera field -> its buffer
    out: tuple          # the graph's own RasterOut
    launches: tuple     # what a replay adds to `_counters()`: kernel B's
                        # and A's launches, A's elements, binning's
                        # scatter calls and entries


_held: _Held | None = None
_last = None            # the key of the call before, if it ran eagerly
_eager_only = 0
_side: dict = {}        # device -> the side stream that warms up and captures


def release() -> None:
    """Drop the held graph, its memory pool and its buffers."""
    global _held, _last
    _held = _last = None


@contextlib.contextmanager
def eager():
    """Every `rasterize` call inside runs the eager path: for tools and
    tests that record or wrap the path's inner functions (`pair_rows`,
    `blend_pairs`, `binning.fused_cummax`), which a replay does not
    call."""
    global _eager_only
    _eager_only += 1
    try:
        yield
    finally:
        _eager_only -= 1


def engages(call: dict, dev: torch.device) -> bool:
    """Whether a call of `rasterize` (its keyword arguments, `device`
    left out) may run through the graph: on the card, no training hooks,
    no input that needs grad while grad mode is on, no mesh axis, the
    stream not already capturing."""
    if (dev.type != "cuda" or call["model_axis"] is not None
            or call["means2d_offset"] is not None
            or call["absgrad_sink"] is not None):
        return False
    tensors = [call[n] for n in TENSORS] + [
        getattr(call["camera"], n) for n in CAMERA]
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        return False
    return not torch.cuda.is_current_stream_capturing()


def key(call: dict) -> tuple:
    """What of a `rasterize` call shapes the work the graph replays: N,
    each tensor input's shape and dtype (None when absent), the static
    options, the camera's size and field of view, the module switches the
    path reads, the device, the current stream and inference mode. The
    camera's matrices and the scene's values are not in it."""
    from . import rasterize    # which imports this module

    cam = call["camera"]
    t = call["means3d"]
    return (
        t.shape[0],
        tuple(None if call[n] is None else (tuple(call[n].shape),
                                            call[n].dtype)
              for n in TENSORS),
        tuple(call[n] for n in ("sh_degree", "scale_modifier", "capacity",
                                "tile_x", "tile_y", "tight_rect",
                                "sub_chunks", "tail_cap", "big_cap",
                                "emit_k")),
        (cam.width, cam.height, cam.tan_fovx, cam.tan_fovy,
         cam.lim_tan_fovx, cam.lim_tan_fovy, cam.full_width,
         cam.full_height),
        (binning.EMIT_PAIRS, binning.EMIT_K, binning.SUB_CHUNKS,
         rasterize.DERIVE_GM),
        t.device, torch.cuda.current_stream(t.device).cuda_stream
        if t.device.type == "cuda" else None,
        torch.is_inference_mode_enabled(),
    )


def run(call: dict, dev: torch.device, fn):
    """fn(**call) (a RasterOut): eagerly, through the held graph, or by a
    capture; see the module's docstring. A capture call counts a capture
    and a replay, so eager + replays is the number of calls."""
    global _held, _last
    if _eager_only or not engages(call, dev):
        graph_counts["eager"] += 1
        return fn(**call)
    k = key(call)
    prev, _last = _last, None
    if _held is not None and _held.key == k:
        return _replay(_held, call)
    if prev != k:
        graph_counts["eager"] += 1
        _last = k
        return fn(**call)
    # the old graph may still be read by work in flight on another stream
    torch.cuda.synchronize(dev)
    _held = None
    _held = _capture(k, call, fn)
    return _replay(_held, call)


def _copy_in(held: _Held, call: dict) -> None:
    for n, buf in held.buffers.items():
        buf.copy_(call[n])
    for n, buf in held.cam_buffers.items():
        buf.copy_(getattr(call["camera"], n))


def _counters() -> tuple:
    """The host counters a replay advances, in `_Held.launches` order."""
    sc = binning.scatter_counts
    return (blend.launches, scan.launches, scan.elements, sc["calls"],
            sc["entries"])


def _set_counters(values: tuple) -> None:
    (blend.launches, scan.launches, scan.elements,
     binning.scatter_counts["calls"],
     binning.scatter_counts["entries"]) = values


def _capture(k, call, fn) -> _Held:
    dev = call["means3d"].device
    held = _Held(k, torch.cuda.CUDAGraph(),
                 {n: torch.empty_like(call[n]) for n in TENSORS
                  if call[n] is not None},
                 {n: torch.empty_like(getattr(call["camera"], n))
                  for n in CAMERA}, None, None)
    _copy_in(held, call)
    static = dict(call, **held.buffers, camera=dataclasses.replace(
        call["camera"], **held.cam_buffers))
    side = _side.get(dev)
    if side is None:
        side = _side[dev] = torch.cuda.Stream(dev)
    cur = torch.cuda.current_stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        fn(**static)              # warm-up: per-stream handles, workspaces
    cur.wait_stream(side)
    before = _counters()
    with torch.cuda.graph(held.graph, stream=side,
                          capture_error_mode="thread_local"):
        held.out = fn(**static)
    # the capture ran no kernel: each replay counts them
    held.launches = tuple(a - b for a, b in zip(_counters(), before))
    _set_counters(before)
    graph_counts["captures"] += 1
    return held


def _replay(held: _Held, call: dict):
    with span("raster.graph"):
        _copy_in(held, call)
        held.graph.replay()
        _set_counters(tuple(a + b for a, b in zip(_counters(),
                                                  held.launches)))
        o = held.out
        planes = torch.cat([o.color, o.depth, o.alpha, o.semantic])
        out = type(o)(color=planes[0:3], depth=planes[3:4],
                      alpha=planes[4:5], semantic=planes[5:],
                      radii=o.radii.clone(), means2d=o.means2d.clone(),
                      overflow=o.overflow.clone(), n_pairs=o.n_pairs.clone())
    graph_counts["replays"] += 1
    return out
