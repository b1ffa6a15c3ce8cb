"""Row gather of a float32 table by int32 row ids, with zero rows for ids
outside the table (the padding slots of a pair list).

On a CUDA tensor the wrapper launches the hand-written `csrc/gather_rows.cu`
(one block per 128-row chunk, rows staged in shared memory by `cp.async`;
the port of the TPU kernel `tools/gather_fold.py:65`), for any width that
is a multiple of 4; where autograd records the table, its backward adds
each output row's gradient back into its table row. On a CPU tensor it
uses the plain version, an `index_select` and a `where`. The eval path of
`ops/rasterize.pair_rows` takes its rows here: the depth-order take of the
marker path and the pair gather, whose padding rows the kernel writes as
zeros. `tools/gather_fold.py` times it against `index_select`.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

launches = 0              # kernel launches through `gather_rows` (CUDA)


def gather_rows_plain(fields: torch.Tensor, src: torch.Tensor):
    """Plain version: out[i] = fields[src[i]], a zero row where src[i] is
    outside [0, N) (the padding slots of a pair list)."""
    ok = (src >= 0) & (src < fields.shape[0])
    taken = fields.index_select(0, torch.where(ok, src, 0).long())
    return torch.where(ok[:, None], taken, torch.zeros_like(taken))


def _check(fields, src):
    if fields.dim() != 2 or fields.dtype != torch.float32:
        raise TypeError("gather_rows: fields must be a 2-D float32 tensor")
    if fields.shape[1] <= 0 or fields.shape[1] % 4:
        raise ValueError(f"gather_rows: NF={fields.shape[1]} must be a "
                         "positive multiple of 4")
    if src.dim() != 1 or src.dtype != torch.int32:
        raise TypeError("gather_rows: src must be a 1-D int32 tensor")
    if src.device != fields.device:
        raise ValueError("gather_rows: tensors on different devices")


def _launch(fields: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    global launches
    fields = fields.contiguous()
    src = src.contiguous()
    if fields.data_ptr() % 16:
        raise ValueError("gather_rows: fields must be 16-byte aligned")
    out = torch.empty((src.shape[0], fields.shape[1]), dtype=torch.float32,
                      device=fields.device)
    fn = cuda_build.library("gather_rows").grpg_gather_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(fields.device).cuda_stream
    with torch.cuda.device(fields.device):
        err = fn(fields.data_ptr(), fields.shape[0], fields.shape[1],
                 src.data_ptr(), src.shape[0], out.data_ptr(), stream)
    cuda_build.check(err, "gather_rows launch")
    if src.shape[0]:          # the C entry launches nothing for no rows
        launches += 1
    return out


class _GatherRows(torch.autograd.Function):
    """The kernel's gather where autograd records the table: the backward
    adds each output row's gradient into the table row it came from (the
    zero rows of ids outside the table add nothing)."""

    @staticmethod
    def forward(ctx, fields, src):
        ctx.save_for_backward(src)
        ctx.n_rows = fields.shape[0]
        return _launch(fields, src)

    @staticmethod
    def backward(ctx, grad):
        (src,) = ctx.saved_tensors
        ok = (src >= 0) & (src < ctx.n_rows)
        g = grad.new_zeros((ctx.n_rows, grad.shape[1]))
        g.index_add_(0, torch.where(ok, src, 0).long(),
                     grad * ok[:, None].to(grad.dtype))
        return g, None


def gather_rows(fields: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Rows of `fields` [N, NF] float32 at `src` [P] int32 ([P, NF]), zero
    rows where src is outside [0, N). CUDA tensors go through the kernel,
    CPU tensors through the plain version."""
    _check(fields, src)
    if fields.device.type == "cpu":
        return gather_rows_plain(fields, src)
    if fields.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {fields.device}")
    if torch.is_grad_enabled() and fields.requires_grad:
        return _GatherRows.apply(fields, src)
    return _launch(fields, src)
