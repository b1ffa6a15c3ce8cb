"""Carry a composite scene across from the JAX package.

`scene_from_tree` builds the port's (SceneModels, SceneMeta, SceneArrays)
from a nested dict of numpy arrays and python values keyed by the JAX
dataclass field names: {"models": {"background": {"xyz": ...}, "bkgd_aux":
{...}, "actors": {...}, "actor_pose": {"input_trans": ..., "opt_track":
...}, "sky": {"cube_map": ...}, "color_correction": {"affine": ...,
"mode": ..., "use_mlp": ...}, "pose_correction": {...}, ...}, "meta":
{...}, "arrays": {...}}. Absent sub-models are None. A colour-correction
MLP arrives as the JAX layer dict {"w0": [in, out], "b0": [out], ...}.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device
from . import gaussians as G
from .actor_pose import ActorPose
from .corrections import ColorCorrection, PoseCorrection
from .scene_graph import SceneArrays, SceneMeta, SceneModels
from .sky import SkyCubeMap


def _tensor(x, dev):
    a = np.array(x)                 # a writable copy
    if a.dtype == np.int32 or a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(a, device=dev)


def _fill(cls, tree, dev, overrides=None):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in tree:
            v = tree[f.name]
            kw[f.name] = _tensor(v, dev) if isinstance(v, np.ndarray) else v
    kw.update(overrides or {})
    return cls(**kw)


def _color_correction(tree, dev):
    if tree["use_mlp"]:
        def layers(t):
            return {k: _tensor(np.asarray(v, np.float32), dev)
                    for k, v in t.items()}
        return ColorCorrection(layers(tree["affine"]),
                               layers(tree["affine_sky"]), mode=tree["mode"],
                               use_mlp=True)
    return ColorCorrection(_tensor(tree["affine"], dev),
                           _tensor(tree["affine_sky"], dev),
                           mode=tree["mode"])


def scene_from_tree(tree: dict, device=None):
    """(SceneModels, SceneMeta, SceneArrays) on `device` (CUDA unless
    given) from the nested dict described in the module docstring."""
    dev = resolve_device(device)
    m = tree["models"]

    def opt(name, build):
        return build(m[name]) if m.get(name) is not None else None

    def params(t):
        return _fill(G.GaussianParams, t, dev)

    def aux(t):
        return _fill(G.GaussianAux, t, dev)

    models = SceneModels(
        background=params(m["background"]),
        bkgd_aux=aux(m["bkgd_aux"]),
        actors=opt("actors", params),
        actors_aux=opt("actors_aux", aux),
        actor_pose=opt("actor_pose",
                       lambda t: _fill(ActorPose, t, dev)),
        sky=opt("sky", lambda t: SkyCubeMap(_tensor(t["cube_map"], dev))),
        color_correction=opt("color_correction",
                             lambda t: _color_correction(t, dev)),
        pose_correction=opt("pose_correction",
                            lambda t: _fill(PoseCorrection, t, dev)),
        sky_gauss=opt("sky_gauss", params),
        sky_gauss_aux=opt("sky_gauss_aux", aux),
    )
    meta = SceneMeta(**{f.name: tree["meta"][f.name]
                        for f in dataclasses.fields(SceneMeta)
                        if f.name in tree["meta"]})
    arrays = _fill(SceneArrays, tree["arrays"], dev)
    return models, meta, arrays
