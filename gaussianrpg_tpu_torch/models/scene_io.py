"""Scene checkpointing and PLY export/import.

Counterpart of `gaussianrpg_tpu/models/scene_io.py`, reading and writing
the JAX package's files: a checkpoint is `trained_model/iteration_{i}.npz`
with keys `leaf_0 .. leaf_n` (the leaves of the JAX package's `TrainState`
in `jax.tree.flatten` order), `__step__` and `__sh_degree__`; the
composite PLY has one `vertex_<model>` element per sub-model.

The leaf order is written down here as an explicit list of paths
(`checkpoint_leaf_paths`), not inferred from the port's dataclasses:
flax fields marked `pytree_node=False` (`ActorPose.opt_track`,
`ColorCorrection.mode` / `.use_mlp`, `PoseCorrection.mode`) contribute no
leaf, a None sub-model contributes nothing, and dict keys (the Adam
`mu`/`nu` trees, an MLP colour correction's layer dict) flatten in sorted
order. The JAX state holds int32 where the port holds int64 (`n_active`
of a carried-across scene, `col_of`) and a 0-d array for `step` where the
port holds an int: integers are written as int32 and read back in the
template's dtype.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.ply import (gaussian_to_struct, read_ply, struct_to_gaussian,
                        write_ply)
from ..utils.tree import tree_map
from . import gaussians as G

GAUSS_FIELDS = ("xyz", "features_dc", "features_rest", "scaling",
                "rotation", "opacity", "semantic")
AUX_FIELDS = ("n_active", "xyz_gradient_accum", "denom", "max_radii2d")
POSE_FIELDS = ("input_trans", "input_rots", "timestamps", "col_of",
               "opt_trans", "opt_rots")


def _cc_paths(prefix: tuple, value) -> list:
    """A colour-correction table (one leaf) or MLP layer dict (sorted)."""
    if isinstance(value, dict):
        return [prefix + (k,) for k in sorted(value)]
    return [prefix]


def _learnable_paths(models, prefix: tuple) -> list:
    """The leaves of the JAX `_learnables(models)` dict (keys sorted; the
    `actors` key is there even when None, and contributes nothing)."""
    groups = {"background": [(f,) for f in GAUSS_FIELDS]}
    if models.actors is not None:
        groups["actors"] = [(f,) for f in GAUSS_FIELDS]
    if models.sky_gauss is not None:
        groups["sky_gauss"] = [(f,) for f in GAUSS_FIELDS]
    if models.actor_pose is not None and models.actor_pose.opt_track:
        groups["actor_pose"] = [("opt_rots",), ("opt_trans",)]
    if models.sky is not None:
        groups["sky"] = [()]
    if models.color_correction is not None:
        cc = models.color_correction
        groups["color_correction"] = (_cc_paths(("affine",), cc.affine)
                                      + _cc_paths(("affine_sky",),
                                                  cc.affine_sky))
    if models.pose_correction is not None:
        groups["pose_correction"] = [("rots",), ("trans",)]
    return [prefix + (k,) + p for k in sorted(groups) for p in groups[k]]


def checkpoint_leaf_paths(state) -> list:
    """Paths (tuples of field names and dict keys) of the leaves of a
    `TrainState`, in the order `jax.tree.flatten` gives the JAX package's
    `TrainState` of the same scene."""
    m = state.models
    paths = []

    def sub(name, fields):
        if getattr(m, name) is not None:
            paths.extend(("models", name, f) for f in fields)

    sub("background", GAUSS_FIELDS)
    sub("bkgd_aux", AUX_FIELDS)
    sub("actors", GAUSS_FIELDS)
    sub("actors_aux", AUX_FIELDS)
    sub("actor_pose", POSE_FIELDS)
    sub("sky", ("cube_map",))
    if m.color_correction is not None:
        cc = m.color_correction
        paths.extend(_cc_paths(("models", "color_correction", "affine"),
                               cc.affine)
                     + _cc_paths(("models", "color_correction",
                                  "affine_sky"), cc.affine_sky))
    sub("pose_correction", ("trans", "rots"))
    sub("sky_gauss", GAUSS_FIELDS)
    sub("sky_gauss_aux", AUX_FIELDS)
    paths.extend(_learnable_paths(m, ("adam", "mu")))
    paths.extend(_learnable_paths(m, ("adam", "nu")))
    paths.append(("adam", "count"))
    paths.append(("step",))
    return paths


def _get(tree, path: tuple):
    for k in path:
        tree = tree[k] if isinstance(tree, dict) else getattr(tree, k)
    return tree


def _set(tree, path: tuple, value) -> None:
    parent = _get(tree, path[:-1])
    if isinstance(parent, dict):
        parent[path[-1]] = value
    else:
        setattr(parent, path[-1], value)


def _to_numpy(x) -> np.ndarray:
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    if a.dtype.kind in "iu":
        a = a.astype(np.int32)
    return a


def save_checkpoint(path: str, state, step: int, active_sh_degree: int):
    """Save a `TrainState` and the two scalars in the JAX package's
    layout (`train.py:309-314`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrs = {f"leaf_{i}": _to_numpy(_get(state, p))
            for i, p in enumerate(checkpoint_leaf_paths(state))}
    arrs["__step__"] = np.asarray(step)
    arrs["__sh_degree__"] = np.asarray(active_sh_degree)
    np.savez(path, **arrs)


def load_checkpoint(path: str, template):
    """Restore a checkpoint into a `TrainState` shaped like `template`, on
    the template's devices and in its dtypes. Returns (state, step,
    active_sh_degree). Raises, naming the leaf, when the file's leaves do
    not match the template's."""
    paths = checkpoint_leaf_paths(template)
    with np.load(path) as data:
        n_file = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_file != len(paths):
            raise ValueError(f"{path}: {n_file} leaves, the scene has "
                             f"{len(paths)}")
        state = tree_map(lambda x: x, template)
        for i, p in enumerate(paths):
            arr = data[f"leaf_{i}"]
            ref = _get(template, p)
            name = "/".join(p)
            shape = tuple(ref.shape) if isinstance(ref, torch.Tensor) else ()
            if arr.shape != shape:
                raise ValueError(f"{path}: leaf {i} ({name}) has shape "
                                 f"{arr.shape}, the scene's is {shape}")
            if isinstance(ref, torch.Tensor):
                ref_kind = "f" if ref.is_floating_point() else (
                    "b" if ref.dtype == torch.bool else "i")
                if arr.dtype.kind.replace("u", "i") != ref_kind:
                    raise ValueError(f"{path}: leaf {i} ({name}) is "
                                     f"{arr.dtype}, the scene's {ref.dtype}")
                val = torch.as_tensor(arr).to(device=ref.device,
                                              dtype=ref.dtype)
            else:
                if arr.dtype.kind not in "iu":
                    raise ValueError(f"{path}: leaf {i} ({name}) is "
                                     f"{arr.dtype}, not an integer")
                val = int(arr)
            _set(state, p, val)
        return state, int(data["__step__"]), int(data["__sh_degree__"])


def load_latest_checkpoint(dirname: str, models_template):
    """The models of the latest `iteration_*.npz` in `dirname` (the Scene's
    non-train path, `lib/models/scene.py:19-49`); the template unchanged
    when there is none."""
    from ..train.trainer import init_train_state
    it = search_max_iteration(dirname)
    if it is None:
        return models_template
    state, _, _ = load_checkpoint(
        os.path.join(dirname, f"iteration_{it}.npz"),
        init_train_state(models_template))
    return state.models


def search_max_iteration(dirname: str) -> Optional[int]:
    """`system_utils.searchForMaxIteration` analog."""
    if not os.path.isdir(dirname):
        return None
    its = []
    for f in os.listdir(dirname):
        m = re.match(r"iteration_(\d+)\.npz", f)
        if m:
            its.append(int(m.group(1)))
    return max(its) if its else None


def _active_np(params: G.GaussianParams, n_active: int):
    def take(x):
        return _to_numpy(x[:n_active])
    return (take(params.xyz), take(params.features_dc),
            take(params.features_rest), take(params.opacity),
            take(params.scaling), take(params.rotation),
            take(params.semantic))


def _actor(params: G.GaussianParams, o: int) -> G.GaussianParams:
    return tree_map(lambda x: x[o], params)


def save_composite_ply(path: str, models, actor_names=None):
    """One `vertex_<model>` element per sub-model
    (`street_gaussian_model.save_ply:94-105`); only active slots are
    written."""
    elements = {}
    elements["vertex_background"] = gaussian_to_struct(*_active_np(
        models.background, int(models.bkgd_aux.n_active)))
    if models.actors is not None and models.actors.xyz.shape[0]:
        for o in range(models.actors.xyz.shape[0]):
            n_act = int(models.actors_aux.n_active[o])
            name = actor_names[o] if actor_names else f"obj_{o:03d}"
            elements[f"vertex_{name}"] = gaussian_to_struct(*_active_np(
                _actor(models.actors, o), n_act))
    if models.sky_gauss is not None:
        elements["vertex_sky"] = gaussian_to_struct(*_active_np(
            models.sky_gauss, int(models.sky_gauss_aux.n_active)))
    write_ply(path, elements)


@torch.no_grad()
def export_flat_ply(path: str, models, meta, arrays, frame: int = 0):
    """Flatten the composite scene at one frame into a standard
    single-element 3DGS PLY for external viewers (`make_ply.py` analog):
    actor Gaussians are posed into world space and their time-conditioned
    DC coefficients evaluated at the frame."""
    from ..ops.math3d import quaternion_multiply, quaternion_to_matrix
    from ..ops.sh import idft_basis
    from .actor_pose import object_poses

    xs, dcs, rests, ops, scs, rots, sems = [], [], [], [], [], [], []
    xyz, f_dc, f_rest, op, sc, rot, sem = _active_np(
        models.background, int(models.bkgd_aux.n_active))
    xs.append(xyz)
    dcs.append(f_dc[:, :1])
    rests.append(f_rest)
    ops.append(op)
    scs.append(sc)
    rots.append(rot)
    sems.append(sem)

    if models.actors is not None and meta.num_actors:
        end0 = float(arrays.actor_end_frame[0])
        ts = frame / max(1, int(end0))
        trans, quats = object_poses(models.actor_pose, ts)
        for o in range(meta.num_actors):
            n_act = int(models.actors_aux.n_active[o])
            p = _actor(models.actors, o)
            xyz, f_dc, f_rest, op, sc, rot, sem = _active_np(p, n_act)
            rmat = _to_numpy(quaternion_to_matrix(quats[o]))
            xyz_w = xyz @ rmat.T + _to_numpy(trans[o])
            rot_w = _to_numpy(quaternion_multiply(quats[o][None],
                                                  p.rotation[:n_act]))
            start = float(arrays.actor_start_frame[o])
            denom = max(float(arrays.actor_end_frame[o]) - start, 1.0)
            tnorm = (frame - start) / denom
            basis = _to_numpy(idft_basis(
                torch.tensor(tnorm * meta.fourier_scale), meta.fourier_dim))
            dc = (f_dc * basis[None, :, None]).sum(axis=1, keepdims=True)
            xs.append(xyz_w.astype(np.float32))
            dcs.append(dc)
            rests.append(f_rest)
            ops.append(op)
            scs.append(sc)
            rots.append(rot_w)
            sems.append(np.zeros((n_act, sems[0].shape[1]), np.float32))

    k_rest = max(r.shape[1] for r in rests)
    rests = [np.pad(r, ((0, 0), (0, k_rest - r.shape[1]), (0, 0)))
             for r in rests]

    def cat(arrs):
        return np.concatenate(arrs, axis=0)

    elements = {"vertex": gaussian_to_struct(
        cat(xs), cat(dcs), cat(rests), cat(ops), cat(scs), cat(rots),
        cat(sems))}
    write_ply(path, elements)


def load_gaussians_from_ply(path: str, element: str = "vertex",
                            capacity: int | None = None,
                            fourier_dim: int = 1, device=None
                            ) -> Tuple[G.GaussianParams, G.GaussianAux]:
    """Load one PLY element into capacity-padded parameters on `device`
    (CUDA unless given)."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    elems = read_ply(path)
    v = elems[element] if element in elems else next(iter(elems.values()))
    d = struct_to_gaussian(v, fourier_dim)
    n = d["xyz"].shape[0]
    cap = capacity or int(2 ** np.ceil(np.log2(max(n, 1) * 1.5)))

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return torch.as_tensor(out, device=dev)

    f_dc = d["features_dc"]
    if f_dc.shape[1] < fourier_dim:
        f_dc = np.pad(f_dc, ((0, 0), (0, fourier_dim - f_dc.shape[1]),
                             (0, 0)))
    rotation = pad(d["rotation"])
    rotation[n:, 0] = 1.0
    params = G.GaussianParams(
        xyz=pad(d["xyz"]),
        features_dc=pad(f_dc),
        features_rest=pad(d["features_rest"]),
        scaling=pad(d["scaling"], fill=-20.0),
        rotation=rotation,
        opacity=pad(d["opacity"], fill=-20.0),
        semantic=pad(d["semantic"]),
    )
    aux = G.GaussianAux(
        n_active=torch.tensor(n, dtype=torch.int32, device=dev),
        xyz_gradient_accum=torch.zeros((cap, 2), device=dev),
        denom=torch.zeros((cap, 1), device=dev),
        max_radii2d=torch.zeros((cap,), device=dev),
    )
    return params, aux
