"""One CUDA graph of `rasterize`'s eval path, captured once per call
signature and then replayed, so the host issues one graph launch a frame
in place of the path's ~600 kernel launches.

`rasterize.rasterize` hands every call to `run`. A call that `engages`
the graph is keyed by everything of it that shapes the work (`key`). A
key met for the first time runs eagerly; the same key on the next call
warms up on a side stream, then captures; later calls with that key
replay. Each replay copies every tensor argument of the call, and the
camera's matrices, into the graph's buffers, and returns clones: what a
replay reads and returns is the caller's.

One graph is held at a time: a key that is captured frees the graph
before it. A graph pins its private memory pool (one render's working
set) and a copy of the scene's tensors for the life of the process, so
holding more than one would hold that many scenes; `release()` frees it.

A replay launches no kernel from the host, so it advances the host
counters in `COUNTERS` by what its capture ran: they keep counting the
kernels the card runs (chip_smoke.py holds them to a profiler trace's
kernel records). A replay is one `raster.graph` span (utils/spans.py).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..utils.spans import span
from . import binning, blend, fields, gather, scan

# the camera's tensors the path reads (copied on each replay) and the
# fields that shape its work (keyed); the path reads none of the rest (K,
# ego_pose, extrinsic, timestamp, frame, ids, meta)
CAMERA = ("viewmatrix", "projmatrix", "cam_center")
CAMERA_KEY = ("width", "height", "tan_fovx", "tan_fovy", "lim_tan_fovx",
              "lim_tan_fovy", "full_width", "full_height")
# module switches that shape eval work (`rasterize.DERIVE_GM` shapes
# train calls only, which never engage)
SWITCHES = ((binning, "EMIT_PAIRS"), (binning, "EMIT_K"),
            (binning, "SUB_CHUNKS"))
# host counters of the kernels the path launches
COUNTERS = ((blend, "launches"), (scan, "launches"), (scan, "elements"),
            (gather, "launches"), (fields, "launches"))

graph_counts = {"captures": 0, "replays": 0, "eager": 0}


@dataclasses.dataclass
class _Held:
    key: tuple
    graph: torch.cuda.CUDAGraph
    buffers: dict       # tensor argument -> the buffer each call copies into
    cam_buffers: dict   # camera field -> its buffer
    out: tuple          # the graph's own RasterOut
    launches: tuple     # what a replay adds to COUNTERS


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


def _tensors(call: dict) -> dict:
    return {n: v for n, v in call.items() if isinstance(v, torch.Tensor)}


def engages(call: dict, dev: torch.device) -> bool:
    """Whether a call of `rasterize` (its keyword arguments, `device`
    left out) may run through the graph: on the card, no training hooks,
    no input that needs grad while grad mode is on, no mesh axis, the
    stream not already capturing."""
    if (dev.type != "cuda" or call["model_axis"] is not None
            or call["means2d_offset"] is not None
            or call["absgrad_sink"] is not None):
        return False
    tensors = list(_tensors(call).values()) + [
        getattr(call["camera"], n) for n in CAMERA]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return False
    return not torch.cuda.is_current_stream_capturing()


def key(call: dict) -> tuple:
    """What of a `rasterize` call shapes the work the graph replays: each
    argument but the camera, a tensor as its shape and dtype and anything
    else (None too) as its value; the camera's `CAMERA_KEY` fields; the
    `SWITCHES`; the device, the current stream and inference mode."""
    cam = call["camera"]
    dev = cam.device
    return (
        tuple((n, (tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
               else v) for n, v in call.items() if n != "camera"),
        tuple(getattr(cam, n) for n in CAMERA_KEY),
        tuple(getattr(m, a) for m, a in SWITCHES),
        dev, torch.cuda.current_stream(dev).cuda_stream
        if dev.type == "cuda" else None,
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


def _buffers(call: dict) -> tuple[dict, dict]:
    """A buffer for each tensor argument of the call and for each
    `CAMERA` field."""
    return ({n: torch.empty_like(v) for n, v in _tensors(call).items()},
            {n: torch.empty_like(getattr(call["camera"], n))
             for n in CAMERA})


def _copy_in(held: _Held, call: dict) -> None:
    for n, buf in held.buffers.items():
        buf.copy_(call[n])
    for n, buf in held.cam_buffers.items():
        buf.copy_(getattr(call["camera"], n))


def _snapshot() -> tuple:
    return tuple(getattr(m, a) for m, a in COUNTERS)


def _advance(by: tuple) -> None:
    for (m, a), d in zip(COUNTERS, by):
        setattr(m, a, getattr(m, a) + d)


def _capture(k, call, fn) -> _Held:
    dev = call["camera"].device
    held = _Held(k, torch.cuda.CUDAGraph(), *_buffers(call), None, None)
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
    before = _snapshot()
    with torch.cuda.graph(held.graph, stream=side,
                          capture_error_mode="thread_local"):
        held.out = fn(**static)
    # the capture ran no kernel: each replay counts them
    held.launches = tuple(a - b for a, b in zip(_snapshot(), before))
    _advance(tuple(-d for d in held.launches))
    graph_counts["captures"] += 1
    return held


def _replay(held: _Held, call: dict):
    with span("raster.graph"):
        _copy_in(held, call)
        held.graph.replay()
        _advance(held.launches)
        o = held.out
        planes = torch.cat([o.color, o.depth, o.alpha, o.semantic])
        out = type(o)(color=planes[0:3], depth=planes[3:4],
                      alpha=planes[4:5], semantic=planes[5:],
                      radii=o.radii.clone(), means2d=o.means2d.clone(),
                      overflow=o.overflow.clone(), n_pairs=o.n_pairs.clone())
    graph_counts["replays"] += 1
    return out
