"""Meshes of ranks and the collectives of the multi-device layer.

The mesh is a thin class over per-axis process groups rather than
`torch.distributed.device_mesh.DeviceMesh`: the scaling bench builds
meshes of the first s ranks of the world, the single-card check runs two
ranks on one device under gloo, and the collective helpers read each
group's backend to decide how to move CUDA tensors (below).

The autograd functions here are the explicit transposes of the JAX
package's `shard_map` specs (`parallel/sharded.py` maps each one):
`GatherStrips` (all-gather of strip planes; backward keeps this rank's
rows), `_GatherShards` (tiled all-gather; backward reduce-scatter) and
`_SumGrads` (identity; backward all-reduce of replicated inputs'
cotangents).

Collectives of a gloo group stage CUDA tensors through host memory: gloo's
collectives on CUDA tensors differ by collective and build, so every
collective of a gloo group copies the tensor to the host, runs there and
copies the result back; its reduce-scatter is an all-reduce of the whole
tensor, of which each rank keeps its chunk. The compute stays on the card;
this is a transport, not a fallback. NCCL groups run every collective on
the device tensors.

Imports nothing of the renderer, so that `ops/rasterize` can use it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.tree import tree_leaves, tree_unflatten


class Axis(NamedTuple):
    """One axis of a mesh as this rank sees it."""

    name: str
    group: object      # torch.distributed process group of the axis
    size: int
    index: int         # this rank's coordinate along the axis


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of ranks as this rank sees it: the axes it lies on and the
    group of the whole mesh. `ranks` holds the global ranks in mesh
    order (shape: the axis sizes)."""

    axis_names: tuple
    ranks: np.ndarray
    axes: dict
    group: object

    @property
    def lead(self) -> bool:
        """Whether this rank is the mesh's first (the one that logs)."""
        return dist.get_rank() == int(self.ranks.flat[0])

    def axis(self, name: str) -> Axis:
        return self.axes[name]


def _world_ranks(ranks):
    return (list(range(dist.get_world_size())) if ranks is None
            else [int(r) for r in ranks])


def make_mesh(ranks=None, axis: str = "data") -> Mesh | None:
    """A 1-axis mesh over `ranks` (default: the whole world). Every rank
    of the world must call it (it creates a process group); a rank outside
    `ranks` gets None."""
    ranks = _world_ranks(ranks)
    group = dist.new_group(ranks)
    me = dist.get_rank()
    if me not in ranks:
        return None
    return Mesh((axis,), np.asarray(ranks),
                {axis: Axis(axis, group, len(ranks), ranks.index(me))}, group)


def make_mesh_2d(n_data: int, n_model: int, ranks=None) -> Mesh | None:
    """A ("data", "model") mesh of the first n_data * n_model of `ranks`
    in row-major order: tile strips over `data`, Gaussians over `model`.
    Every rank of the world must call it; a rank outside the mesh gets
    None."""
    ranks = _world_ranks(ranks)
    if len(ranks) < n_data * n_model:
        raise ValueError(f"a {n_data}x{n_model} mesh needs "
                         f"{n_data * n_model} ranks, have {len(ranks)}")
    grid = np.asarray(ranks[:n_data * n_model]).reshape(n_data, n_model)
    whole = dist.new_group(grid.ravel().tolist())
    data_groups = [dist.new_group(grid[:, m].tolist())
                   for m in range(n_model)]
    model_groups = [dist.new_group(grid[d, :].tolist())
                    for d in range(n_data)]
    at = np.argwhere(grid == dist.get_rank())
    if not len(at):
        return None
    d, m = (int(x) for x in at[0])
    return Mesh(("data", "model"), grid,
                {"data": Axis("data", data_groups[m], n_data, d),
                 "model": Axis("model", model_groups[d], n_model, m)}, whole)


def _staged(group, t: torch.Tensor) -> bool:
    """Whether a collective of `group` on `t` goes through host memory (a
    CUDA tensor in a gloo group; see the module docstring)."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


class _Pending:
    """An all-reduce in flight: `wait()` finishes it (and copies a staged
    result back into the device tensor)."""

    def __init__(self, work, host, dst):
        self.work, self.host, self.dst = work, host, dst

    def wait(self):
        if self.work is not None:
            self.work.wait()
        if self.host is not None:
            self.dst.copy_(self.host)
        return self.dst


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM,
                async_op: bool = False):
    """In-place all-reduce of `t` over `group`; with `async_op` returns a
    handle whose `wait()` completes it."""
    host = t.cpu() if _staged(group, t) else None
    work = dist.all_reduce(t if host is None else host, op=op, group=group,
                           async_op=async_op)
    pending = _Pending(work if async_op else None, host, t)
    return pending if async_op else pending.wait()


def all_gather(t: torch.Tensor, axis: Axis) -> list:
    """Every rank's `t` (equal shapes) along `axis`, in axis order."""
    src = t.detach().contiguous()
    host = _staged(axis.group, src)
    if host:
        src = src.cpu()
    outs = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(outs, src, group=axis.group)
    return [o.to(t.device) for o in outs] if host else outs


def reduce_scatter(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum over `axis` of `t`'s chunk (dim 0, `axis.size` equal
    chunks) at this rank's index."""
    t = t.contiguous()
    n = t.shape[0] // axis.size
    if dist.get_backend(axis.group) == dist.Backend.GLOO:
        return all_reduce_(t.clone(), axis.group)[axis.index * n:
                                                  (axis.index + 1) * n]
    out = torch.empty_like(t[:n])
    dist.reduce_scatter(out, list(t.split(n)), op=dist.ReduceOp.SUM,
                        group=axis.group)
    return out


class GatherStrips(torch.autograd.Function):
    """Strip planes [C, h, W] of every `data` rank, stacked along rows:
    [C, n * h, W]. Backward: this rank's rows of the cotangent times
    `scale` (not reduced: see the module docstring)."""

    @staticmethod
    def forward(ctx, planes, axis, scale):
        ctx.axis, ctx.scale, ctx.rows = axis, scale, planes.shape[1]
        return torch.cat(all_gather(planes, axis), dim=1)

    @staticmethod
    def backward(ctx, ct):
        lo = ctx.axis.index * ctx.rows
        g = ct[:, lo:lo + ctx.rows]
        return (g * ctx.scale if ctx.scale != 1 else g), None, None


class _GatherShards(torch.autograd.Function):
    """Rows of every `model` rank concatenated in rank order (a tiled
    all-gather); backward: reduce-scatter (SUM) of the cotangent."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return torch.cat(all_gather(x, axis), dim=0)

    @staticmethod
    def backward(ctx, ct):
        return reduce_scatter(ct, ctx.axis), None


class _SumGrads(torch.autograd.Function):
    """Identity on the inputs; backward sums their cotangents over
    `group` in one all-reduce (the transpose of a replicated input)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *cts):
        dtype = cts[0].dtype
        flat = torch.cat([c.reshape(-1).to(dtype) for c in cts])
        all_reduce_(flat, ctx.group)
        parts = flat.split([c.numel() for c in cts])
        return (None,) + tuple(p.view(c.shape).to(c.dtype)
                               for p, c in zip(parts, cts))


def replicated(group, items: list) -> list:
    """`items` (tensors, None, or nested dataclasses and dicts of tensors)
    with every tensor that requires grad passed through one `_SumGrads`
    over `group`: the gradients that reach those tensors through the
    result are summed over the group. Other leaves pass as they are."""
    leaves = [tree_leaves(x) for x in items]
    live = [(i, j) for i, ls in enumerate(leaves) for j, x in enumerate(ls)
            if torch.is_tensor(x) and x.requires_grad]
    if not live or not torch.is_grad_enabled():
        return list(items)
    outs = _SumGrads.apply(group, *(leaves[i][j] for i, j in live))
    for (i, j), o in zip(live, outs):
        leaves[i][j] = o
    return [tree_unflatten(x, ls) for x, ls in zip(items, leaves)]


def _gather_shards(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Tiled all-gather over `axis`, differentiable when `x` is (its
    backward is a reduce-scatter)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _GatherShards.apply(x, axis)
    return torch.cat(all_gather(x, axis), dim=0)


def gather_field_rows(fs, axis: Axis):
    """A FieldSet of this rank's Gaussian shard -> the FieldSet of every
    shard of `axis` in rank order (the JAX package's
    `all_gather(..., "model", tiled=True)` of its rows)."""
    return fs._replace(**{k: _gather_shards(getattr(fs, k), axis)
                          for k in ("fields", "rect_min", "rect_max",
                                    "radii", "depths", "means2d")})
