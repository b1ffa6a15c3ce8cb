"""Gaussian sub-model parameters as capacity-padded dataclasses of tensors,
the hand-rolled Adam and adaptive density control.

Counterpart of `gaussianrpg_tpu/models/gaussians.py`. Arrays are
capacity-padded along N: the first `n_active` slots are live. Updates are
out of place, as in JAX, so a caller can discard a step by keeping the old
state. Adam is written out (not `torch.optim.Adam`): densification edits
its moments slot by slot and each parameter group has its own schedule.
The random draws of the split and of the actor bounding-box prune go
through `_randn` with an explicit `torch.Generator`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.math3d import inverse_sigmoid, quaternion_to_matrix
from ..ops.sh import rgb_to_sh
from ..utils.device import resolve_device
from ..utils.tree import tree_leaves, tree_map


@dataclasses.dataclass
class GaussianParams:
    """Raw (pre-activation) parameters; N may be preceded by a stack dim
    (actors are stacked [O, A, ...])."""

    xyz: torch.Tensor            # [N, 3]
    features_dc: torch.Tensor    # [N, F, 3]
    features_rest: torch.Tensor  # [N, K-1, 3]
    scaling: torch.Tensor        # [N, 3] log-scale
    rotation: torch.Tensor       # [N, 4] unnormalized quaternion
    opacity: torch.Tensor        # [N, 1] logit
    semantic: torch.Tensor       # [N, C]

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def replace(self, **kw) -> "GaussianParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class GaussianAux:
    n_active: torch.Tensor            # [] i32 (or [O] for stacked actors)
    xyz_gradient_accum: torch.Tensor  # [N, 2]: norm-grad, abs-grad (AbsGS)
    denom: torch.Tensor               # [N, 1]
    max_radii2d: torch.Tensor         # [N]

    def replace(self, **kw) -> "GaussianAux":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class AdamState:
    mu: object      # tree like the parameters
    nu: object
    count: torch.Tensor   # [] i32

    def replace(self, **kw) -> "AdamState":
        return dataclasses.replace(self, **kw)


def active_mask(params: GaussianParams, aux: GaussianAux) -> torch.Tensor:
    return torch.arange(params.capacity,
                        device=params.xyz.device) < aux.n_active


def get_scaling(p: GaussianParams) -> torch.Tensor:
    return torch.exp(p.scaling)


def get_rotation(p: GaussianParams) -> torch.Tensor:
    return p.rotation / torch.linalg.norm(p.rotation, dim=-1, keepdim=True)


def get_opacity(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.opacity)


def get_features(p: GaussianParams) -> torch.Tensor:
    """[N, K, 3] SH coefficients (DC first)."""
    return torch.cat([p.features_dc, p.features_rest], dim=-2)


def get_semantic(p: GaussianParams, mode: str = "logits") -> torch.Tensor:
    if mode == "probabilities":
        return torch.softmax(p.semantic, dim=-1)
    return p.semantic


def init_from_points(
    points: np.ndarray,
    colors: np.ndarray,
    capacity: int,
    sh_degree: int,
    fourier_dim: int = 1,
    num_classes: int = 0,
    init_opacity: float = 0.1,
    scales: np.ndarray | None = None,
    device=None,
) -> tuple[GaussianParams, GaussianAux]:
    """Initialize from a point cloud (scale from the mean 3-NN distance
    unless `scales` is given) on `device` (CUDA unless given)."""
    from ..ops.knn import mean_knn_dist_sq

    dev = resolve_device(device)
    n = points.shape[0]
    assert n <= capacity, f"capacity {capacity} < points {n}"
    k = (sh_degree + 1) ** 2
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)

    if scales is None:
        d2 = torch.clamp(mean_knn_dist_sq(pts), min=1e-7)
        scales_t = torch.log(torch.sqrt(d2))[:, None].repeat(1, 3)
    else:
        scales_t = torch.as_tensor(np.asarray(scales, np.float32), device=dev)

    def pad(x, shape_tail, fill=0.0):
        out = torch.full((capacity,) + shape_tail, fill, dtype=torch.float32,
                         device=dev)
        out[:n] = torch.as_tensor(x, dtype=torch.float32, device=dev)
        return out

    f_dc = np.zeros((n, fourier_dim, 3), np.float32)
    f_dc[:, 0, :] = rgb_to_sh(np.asarray(colors, np.float32))
    rots = np.zeros((n, 4), np.float32)
    rots[:, 0] = 1.0
    rotation = pad(rots, (4,))
    rotation[:, 0] = 1.0
    opacity = inverse_sigmoid(torch.full((n, 1), init_opacity,
                                         dtype=torch.float32, device=dev))
    params = GaussianParams(
        xyz=pad(pts, (3,)),
        features_dc=pad(f_dc, (fourier_dim, 3)),
        features_rest=pad(np.zeros((n, k - 1, 3), np.float32), (k - 1, 3)),
        scaling=pad(scales_t, (3,), fill=-20.0),
        rotation=rotation,
        opacity=pad(opacity, (1,), fill=-20.0),
        semantic=pad(np.zeros((n, max(num_classes, 1)), np.float32),
                     (max(num_classes, 1),)),
    )
    aux = GaussianAux(
        n_active=torch.tensor(n, dtype=torch.int32, device=dev),
        xyz_gradient_accum=torch.zeros((capacity, 2), device=dev),
        denom=torch.zeros((capacity, 1), device=dev),
        max_radii2d=torch.zeros((capacity,), device=dev),
    )
    return params, aux


def stack_params(items: list) -> "GaussianParams | GaussianAux":
    """Stack per-actor containers along a new leading dim."""
    cls = type(items[0])
    return cls(**{f.name: torch.stack([getattr(i, f.name) for i in items])
                  for f in dataclasses.fields(cls)})


# ---------------------------------------------------------------------------
# Adam with per-group learning rates
# ---------------------------------------------------------------------------

ADAM_EPS = 1e-15


def adam_init(params) -> AdamState:
    dev = tree_leaves(params)[0].device
    return AdamState(mu=tree_map(torch.zeros_like, params),
                     nu=tree_map(torch.zeros_like, params),
                     count=torch.zeros((), dtype=torch.int32, device=dev))


def adam_update(params, grads, state: AdamState, lrs, b1=0.9, b2=0.999,
                eps=ADAM_EPS):
    """One Adam step, out of place. `lrs` is a tree of scalars (or
    broadcastable tensors) matching `params`."""
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)

    def upd(p, m, v, lr):
        mhat = m / bc1
        vhat = v / bc2
        return p - lr * mhat / (torch.sqrt(vhat) + eps)

    new_params = tree_map(upd, params, mu, nu, lrs)
    return new_params, AdamState(mu=mu, nu=nu, count=count)


# ---------------------------------------------------------------------------
# Adaptive density control (clone -> split -> prune within fixed capacity)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    grad_threshold: float = 0.0002
    use_abs_grad: bool = False
    min_opacity: float = 0.005
    percent_dense: float = 0.01
    percent_big_ws: float = 0.1
    extent: float = 20.0
    prune_big_points: bool = False
    split_n: int = 2


def _randn(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard normal draws of one densification step (tests replace this
    helper to feed the JAX package's draws)."""
    return torch.randn(shape, generator=generator, device=device)


def _gather(tree, idx):
    return tree_map(lambda p: p.index_select(0, idx), tree)


def _set_rows(tree, slot, values, cap):
    """tree.at[slot].set(values, mode="drop"): rows whose slot is past the
    capacity are dropped."""
    keep = slot < cap
    s, k = slot[keep], torch.nonzero(keep).flatten()
    return tree_map(lambda p, v: p.index_copy(0, s, v.index_select(0, k)),
                    tree, values)


def densify_and_prune(params: GaussianParams, aux: GaussianAux,
                      adam: AdamState, generator: torch.Generator,
                      cfg: DensifyConfig, sphere_center=None,
                      sphere_radius=None, extent=None, bbox_min=None,
                      bbox_max=None):
    """One densification round of one sub-model within its capacity:
    clone -> split -> prune, then the statistics reset. Survivors are
    compacted to the front (stable), clones then split children fill the
    slots after them (the lowest-priority new points are dropped when the
    capacity is full); Adam moments follow the same permutation, zeros for
    new entries. `extent` overrides `cfg.extent` (actors pass their bbox
    extent); `bbox_min`/`bbox_max` [3] enable the actor outside-bbox
    sampled prune (2 points from each Gaussian's N(xyz, scale)). Returns
    (params, aux, adam, stats)."""
    cap = params.capacity
    dev = params.xyz.device
    ext = cfg.extent if extent is None else extent
    act = active_mask(params, aux)
    grads_accum = aux.xyz_gradient_accum[:, 1] if cfg.use_abs_grad \
        else aux.xyz_gradient_accum[:, 0]
    denom = torch.clamp(aux.denom[:, 0], min=1e-12)
    zero = torch.zeros_like(grads_accum)
    grads = torch.where(aux.denom[:, 0] > 0, grads_accum / denom, zero)
    grads = torch.where(act, grads, zero)

    scaling = torch.exp(params.scaling)
    max_scale = torch.amax(scaling, dim=-1)
    opacity = torch.sigmoid(params.opacity[:, 0])

    hi_grad = grads >= cfg.grad_threshold
    small = max_scale <= cfg.percent_dense * ext
    clone_mask = act & hi_grad & small
    split_mask = act & hi_grad & (~small)

    prune = opacity < cfg.min_opacity
    if cfg.prune_big_points:
        big_ws = max_scale > ext * cfg.percent_big_ws
        if sphere_center is not None:
            dist = torch.linalg.norm(params.xyz - sphere_center, dim=-1)
            big_ws = big_ws & (dist <= 2.0 * sphere_radius)
        prune = prune | big_ws
        if bbox_min is not None:
            samples = scaling[:, None, :] * _randn((cap, 2, 3), generator,
                                                   dev)
            rots = quaternion_to_matrix(
                params.rotation / torch.linalg.norm(params.rotation, dim=-1,
                                                    keepdim=True))
            pts = params.xyz[:, None, :] + torch.einsum("nij,nmj->nmi", rots,
                                                        samples)
            inside = ((pts >= bbox_min) & (pts <= bbox_max)).flatten(1) \
                .all(dim=1)
            prune = prune | (~inside)
    clone_mask = clone_mask & (~prune)
    split_mask = split_mask & (~prune)
    keep = act & (~prune) & (~split_mask)

    def first(mask):
        return torch.argsort((~mask).to(torch.uint8), stable=True)

    keep_rank = first(keep)
    n_keep = int(keep.sum())
    params_k = _gather(params, keep_rank)
    mu_k = _gather(adam.mu, keep_rank)
    nu_k = _gather(adam.nu, keep_rank)
    iota = torch.arange(cap, device=dev)

    def emit(mask, maker, base_offset, params_k, mu_k, nu_k):
        order = first(mask)
        count = int(mask.sum())
        new = maker(_gather(params, order))
        slot = torch.where(iota < count, base_offset + iota,
                           torch.full_like(iota, cap))
        zeros = tree_map(torch.zeros_like, new)
        return (_set_rows(params_k, slot, new, cap),
                _set_rows(mu_k, slot, zeros, cap),
                _set_rows(nu_k, slot, zeros, cap), count)

    params_k, mu_k, nu_k, n_clone = emit(clone_mask, lambda src: src, n_keep,
                                         params_k, mu_k, nu_k)
    n_after_clone = n_keep + n_clone
    n_split = int(split_mask.sum())
    for i in range(cfg.split_n):
        def make_split(src):
            stds = torch.exp(src.scaling)
            samples = stds * _randn(tuple(src.xyz.shape), generator, dev)
            rots = quaternion_to_matrix(
                src.rotation / torch.linalg.norm(src.rotation, dim=-1,
                                                 keepdim=True))
            new_xyz = src.xyz + torch.einsum("nij,nj->ni", rots, samples)
            return src.replace(xyz=new_xyz,
                               scaling=torch.log(stds / (0.8 * cfg.split_n)))

        params_k, mu_k, nu_k, _ = emit(split_mask, make_split,
                                       n_after_clone + i * n_split, params_k,
                                       mu_k, nu_k)

    n_new = min(n_after_clone + cfg.split_n * n_split, cap)
    dead = (iota >= n_new)[:, None]
    params_k = params_k.replace(
        opacity=torch.where(dead, torch.full_like(params_k.opacity, -20.0),
                            params_k.opacity),
        scaling=torch.where(dead, torch.full_like(params_k.scaling, -20.0),
                            params_k.scaling))
    aux_new = GaussianAux(
        n_active=torch.tensor(n_new, dtype=torch.int32, device=dev),
        xyz_gradient_accum=torch.zeros_like(aux.xyz_gradient_accum),
        denom=torch.zeros_like(aux.denom),
        max_radii2d=torch.zeros_like(aux.max_radii2d))
    adam_new = AdamState(mu=mu_k, nu=nu_k, count=adam.count)
    stats = dict(n_keep=n_keep, n_clone=n_clone, n_split=n_split,
                 n_active=n_new)
    return params_k, aux_new, adam_new, stats


def box_reg_loss(params: GaussianParams, aux: GaussianAux, extent,
                 percent_dense: float) -> torch.Tensor:
    """Actor box regularization: mean over active Gaussians of
    max-scale/extent, zeroed below the percent_dense threshold."""
    act = active_mask(params, aux)
    smax = torch.amax(torch.exp(params.scaling), dim=-1)
    zero = torch.zeros_like(smax)
    smax = torch.where(smax > extent * percent_dense, smax, zero)
    smax = torch.where(act, smax, zero)
    return torch.sum(smax / extent) / torch.clamp(
        torch.sum(act.to(torch.float32)), min=1.0)


def grow_capacity(params: GaussianParams, aux: GaussianAux, adam: AdamState,
                  new_capacity: int):
    """Grow the padded capacity: new slots are inactive (opacity and
    scaling logits at -20), Adam moments pad with zeros."""
    old = params.capacity
    assert new_capacity >= old
    pad_n = new_capacity - old

    def pad(x, fill=0.0):
        return torch.cat([x, torch.full((pad_n,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)])

    rotation = pad(params.rotation)
    rotation[old:, 0] = 1.0
    params = GaussianParams(
        xyz=pad(params.xyz), features_dc=pad(params.features_dc),
        features_rest=pad(params.features_rest),
        scaling=pad(params.scaling, -20.0), rotation=rotation,
        opacity=pad(params.opacity, -20.0), semantic=pad(params.semantic))
    aux = GaussianAux(n_active=aux.n_active,
                      xyz_gradient_accum=pad(aux.xyz_gradient_accum),
                      denom=pad(aux.denom), max_radii2d=pad(aux.max_radii2d))
    adam = AdamState(mu=tree_map(pad, adam.mu), nu=tree_map(pad, adam.nu),
                     count=adam.count)
    return params, aux, adam


def reset_opacity(params: GaussianParams, adam: AdamState,
                  max_opacity: float = 0.01):
    """Clamp opacity to <= max_opacity and zero its Adam moments."""
    new_op = inverse_sigmoid(torch.clamp(torch.sigmoid(params.opacity),
                                         max=max_opacity))
    mu = adam.mu.replace(opacity=torch.zeros_like(adam.mu.opacity))
    nu = adam.nu.replace(opacity=torch.zeros_like(adam.nu.opacity))
    return params.replace(opacity=new_op), AdamState(mu=mu, nu=nu,
                                                     count=adam.count)


def add_densification_stats(aux: GaussianAux, viewspace_grad, abs_grad,
                            radii, visible) -> GaussianAux:
    """Accumulate one step's statistics: viewspace_grad [N, 2] (NDC scale),
    abs_grad [N] (AbsGS), radii [N], visible [N] bool."""
    norm = torch.linalg.norm(viewspace_grad, dim=-1)
    vis = visible.to(torch.float32)
    return aux.replace(
        xyz_gradient_accum=aux.xyz_gradient_accum
        + torch.stack([norm * vis, abs_grad * vis], dim=-1),
        denom=aux.denom + vis[..., None],
        max_radii2d=torch.maximum(
            aux.max_radii2d, torch.where(visible, radii.to(torch.float32),
                                         torch.zeros_like(aux.max_radii2d))))
