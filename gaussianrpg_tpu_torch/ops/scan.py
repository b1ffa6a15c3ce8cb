"""Fused running max over k int32 arrays (kernel A).

Counterpart of `gaussianrpg_tpu/ops/pallas_scan.py` (`fused_cummax`). On a
CUDA tensor the wrapper launches the hand-written single-pass scan with
decoupled look-back in `csrc/cummax.cu` (one memset of its status words,
one kernel); on a CPU tensor it uses the plain version, one
`torch.cummax` per array. Every running-max fill of the binning
(ops/binning.py `_fill`) comes here, zero-padded to a multiple of 65536.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

BLOCK = 65536        # the TPU kernel's 512x128 block: P must be a multiple
MAX_K = 4

launches = 0         # kernel launches through `fused_cummax` (CUDA only)
elements = 0         # k * P summed over those launches: A moves 8 bytes each


def fused_cummax_plain(xs) -> list[torch.Tensor]:
    """Plain PyTorch version: inclusive running max of each array."""
    return [torch.cummax(x, dim=0).values for x in xs]


def _check(xs) -> None:
    if not 1 <= len(xs) <= MAX_K:
        raise ValueError(f"fused_cummax takes 1..{MAX_K} arrays, got {len(xs)}")
    p = xs[0].shape[0] if xs[0].dim() == 1 else -1
    for x in xs:
        if x.dim() != 1 or x.shape[0] != p:
            raise ValueError("fused_cummax: arrays must be 1-D of one length")
        if x.dtype != torch.int32:
            raise TypeError(f"fused_cummax: int32 arrays only, got {x.dtype}")
        if x.device != xs[0].device:
            raise ValueError("fused_cummax: arrays on different devices")
    if p % BLOCK != 0:
        raise ValueError(f"fused_cummax: P={p} must be a multiple of {BLOCK}")


def bind(lib: ctypes.CDLL):
    """(grpg_fused_cummax, grpg_fused_cummax_scratch_bytes) of a built
    cummax library, with their ctypes signatures."""
    fn = lib.grpg_fused_cummax
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.grpg_fused_cummax_scratch_bytes
    size.argtypes = [ctypes.c_int, ctypes.c_longlong]
    size.restype = ctypes.c_longlong
    return fn, size


def fused_cummax(xs) -> list[torch.Tensor]:
    """Running max over each of k same-length int32 arrays, P a multiple
    of 65536. CUDA tensors go through the kernel, CPU tensors through the
    plain version."""
    global launches, elements
    xs = list(xs)
    _check(xs)
    if xs[0].device.type == "cpu":
        return fused_cummax_plain(xs)
    if xs[0].device.type != "cuda":
        raise ValueError(f"fused_cummax: unsupported device {xs[0].device}")
    xs = [x.contiguous() for x in xs]
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError("fused_cummax: arrays must be 16-byte aligned")
    k, p = len(xs), xs[0].shape[0]
    fn, size = bind(cuda_build.library("cummax"))
    outs = [torch.empty_like(x) for x in xs]
    # the ticket and the tiles' status words (zeroed by the C entry)
    scratch = torch.empty(size(k, p), dtype=torch.uint8,
                          device=xs[0].device)
    ins = (ctypes.c_void_p * k)(*[x.data_ptr() for x in xs])
    ptrs = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
    stream = torch.cuda.current_stream(xs[0].device).cuda_stream
    with torch.cuda.device(xs[0].device):
        err = fn(ins, ptrs, k, p, scratch.data_ptr(), stream)
    cuda_build.check(err, "fused_cummax launch")
    launches += 1
    elements += k * p
    return outs
