"""Composite Street Gaussians scene graph flattened per camera.

Counterpart of `gaussianrpg_tpu/models/scene_graph.py`: static background
+ tracked actors stacked [O, A, ...] + optional sky Gaussians, flattened
into one rasterizer-ready set of length B_cap + O*A_cap (+ S_cap) for every
frame; actors not alive at the camera timestamp and inactive slots are
masked. In training, actor Gaussians are mirrored about their box's y axis
with probability `flip_prob` (drawn from a `torch.Generator`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.math3d import (matrix_to_quaternion, quaternion_multiply,
                          quaternion_to_matrix)
from ..ops.sh import idft_basis, sh_to_rgb_clamped
from ..utils.spans import span
from . import gaussians as G
from .actor_pose import ActorPose, object_poses
from .corrections import (ColorCorrection, PoseCorrection,
                          correct_gaussian_rotation, correct_gaussian_xyz)
from .sky import SkyCubeMap

# quaternion of diag(-1, 1, -1): the 180-degree rotation about +y of the
# symmetry flip
FLIP_QUAT = (0.0, 0.0, 1.0, 0.0)
FLIP_AXIS = 1

# what `compose` has flattened since the process started, from shapes the
# host knows (no device read): calls, slots (the composed arrays' length,
# inactive slots and actors not alive included) and actor models
compose_counts = {"frames": 0, "slots": 0, "actors": 0}


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static per-scene metadata."""

    num_actors: int
    bkgd_sh_degree: int
    obj_sh_degree: int
    fourier_dim: int
    fourier_scale: float = 1.0
    num_classes: int = 0
    semantic_mode: str = "logits"
    flip_prob: float = 0.0
    use_color_correction: bool = False
    use_pose_correction: bool = False
    include_sky: bool = False
    include_sky_gaussians: bool = False
    box_scale: float = 1.0


@dataclasses.dataclass
class SceneArrays:
    actor_start_ts: torch.Tensor     # [O]
    actor_end_ts: torch.Tensor       # [O]
    actor_start_frame: torch.Tensor  # [O]
    actor_end_frame: torch.Tensor    # [O]
    actor_bbox: torch.Tensor         # [O, 3] (l, w, h)
    actor_deformable: torch.Tensor   # [O] bool
    actor_class: torch.Tensor        # [O] i64 global semantic label
    scene_center: torch.Tensor       # [3]
    scene_radius: torch.Tensor       # []
    sphere_center: torch.Tensor      # [3]
    sphere_radius: torch.Tensor      # []

    def replace(self, **kw) -> "SceneArrays":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class SceneModels:
    background: G.GaussianParams
    bkgd_aux: G.GaussianAux
    actors: Optional[G.GaussianParams]       # stacked [O, A, ...]
    actors_aux: Optional[G.GaussianAux]
    actor_pose: Optional[ActorPose]
    sky: Optional[SkyCubeMap]
    color_correction: Optional[ColorCorrection]
    pose_correction: Optional[PoseCorrection]
    sky_gauss: Optional[G.GaussianParams] = None
    sky_gauss_aux: Optional[G.GaussianAux] = None

    def replace(self, **kw) -> "SceneModels":
        return dataclasses.replace(self, **kw)


def total_capacity(models: SceneModels) -> int:
    b = models.background.capacity
    if models.sky_gauss is not None:
        b += models.sky_gauss.capacity
    if models.actors is None or models.actors.xyz.shape[0] == 0:
        return b
    o, a = models.actors.xyz.shape[:2]
    return b + o * a


def actor_extents(arrays: SceneArrays, box_scale: float = 1.0):
    """Per-actor spatial extent max(l*1.5/box_scale, w*1.5/box_scale, h)/2:
    the actor's learning-rate scale and densify extent."""
    b = arrays.actor_bbox
    return torch.maximum(torch.maximum(b[:, 0] * 1.5 / box_scale,
                                       b[:, 1] * 1.5 / box_scale),
                         b[:, 2]) / 2.0


def _uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    """U[0, 1) draws of the training symmetry flip (tests replace this
    helper to feed the JAX package's draws)."""
    return torch.rand(shape, generator=generator, device=device)


@dataclasses.dataclass
class ComposedScene:
    means3d: torch.Tensor             # [N, 3]
    colors: torch.Tensor              # [N, 3]
    opacity: torch.Tensor             # [N]
    scales: torch.Tensor              # [N, 3]
    rotations: torch.Tensor           # [N, 4] normalized
    semantics: Optional[torch.Tensor]  # [N, C]
    mask: torch.Tensor                # [N] bool


def safe_normalize(v: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return v * torch.rsqrt(torch.clamp(n2, min=1e-24))


def scene_normals(scene: ComposedScene, cam_center) -> torch.Tensor:
    """World normals: the rotation column of the smallest scale axis,
    flipped toward the camera."""
    rmat = quaternion_to_matrix(scene.rotations)
    amin = torch.argmin(scene.scales, dim=-1)
    normals = torch.gather(rmat, 2, amin[:, None, None].expand(-1, 3, 1))[..., 0]
    dirs = safe_normalize(scene.means3d - cam_center)
    dot = torch.sum(-dirs * normals, dim=-1, keepdim=True)
    return torch.where(dot >= 0, normals, -normals)


def sky_sphere_xyz(xyz, center, radius):
    """Sky Gaussians drifting inside 2x the scene sphere are pushed back
    out to the 2r shell."""
    diff = xyz - center
    d = torch.sqrt(torch.clamp(torch.sum(diff * diff, -1, keepdim=True),
                               min=1e-12))
    ratio = d / torch.clamp(2.0 * radius, min=1e-6)
    inside = ratio < 1.0
    safe = torch.where(inside, torch.clamp(ratio, min=1e-3),
                       torch.ones_like(ratio))
    return torch.where(inside, center + diff / safe, xyz)


def compose(models: SceneModels, meta: SceneMeta, arrays: SceneArrays,
            camera, active_sh_degree: int,
            flip: torch.Generator | None = None,
            include_background: bool = True, include_objects: bool = True,
            train_mode: bool = False) -> ComposedScene:
    """Flatten all sub-models into single arrays for one camera. In train
    mode with `meta.flip_prob > 0`, the `flip` generator draws each actor
    Gaussian's symmetry flip. Under a profiler the call is the span
    `scene.compose`; each call advances `compose_counts`."""
    with span("scene.compose"):
        scene = _compose(models, meta, arrays, camera, active_sh_degree,
                         flip, include_background, include_objects,
                         train_mode)
    compose_counts["frames"] += 1
    compose_counts["slots"] += scene.means3d.shape[0]
    if include_objects and meta.num_actors > 0:
        compose_counts["actors"] += models.actors.xyz.shape[0]
    return scene


def _compose(models, meta, arrays, camera, active_sh_degree, flip,
             include_background, include_objects,
             train_mode) -> ComposedScene:
    parts = {k: [] for k in ("xyz", "color", "op", "scale", "rot", "sem",
                             "mask")}
    cam_center = camera.cam_center

    if include_background:
        bk = models.background
        xyz = bk.xyz
        rot = G.get_rotation(bk)
        if meta.use_pose_correction and models.pose_correction is not None:
            pid = models.pose_correction.correction_id(camera)
            xyz = correct_gaussian_xyz(models.pose_correction, pid, xyz)
            rot = correct_gaussian_rotation(models.pose_correction, pid, rot)
            rot = rot / torch.linalg.norm(rot, dim=-1, keepdim=True)
        dirs = safe_normalize(xyz - cam_center)
        color, _ = sh_to_rgb_clamped(active_sh_degree, G.get_features(bk),
                                     dirs)
        parts["xyz"].append(xyz)
        parts["color"].append(color)
        parts["op"].append(G.get_opacity(bk)[:, 0])
        parts["scale"].append(G.get_scaling(bk))
        parts["rot"].append(rot)
        parts["mask"].append(G.active_mask(bk, models.bkgd_aux))
        if meta.num_classes:
            parts["sem"].append(G.get_semantic(bk, meta.semantic_mode))

    if include_objects and meta.num_actors > 0:
        ac = models.actors
        o_cnt, a_cap = ac.xyz.shape[:2]
        dev = ac.xyz.device
        alive = (camera.timestamp >= arrays.actor_start_ts) & (
            camera.timestamp <= arrays.actor_end_ts)
        act_mask = (torch.arange(a_cap, device=dev)[None, :]
                    < models.actors_aux.n_active[:, None])
        val_ts = None
        if camera.meta is not None and camera.meta.get("val_interp_ts"):
            val_ts = torch.as_tensor(camera.meta["val_interp_ts"],
                                     dtype=torch.float32, device=dev)
        trans, rots = object_poses(models.actor_pose, camera.timestamp,
                                   val_ts)
        ego = camera.ego_pose
        ego_q = matrix_to_quaternion(ego[:3, :3])
        rots = quaternion_multiply(ego_q[None], rots)
        trans = trans @ ego[:3, :3].T + ego[:3, 3]

        xyz_l = ac.xyz
        rot_l = ac.rotation / torch.linalg.norm(ac.rotation, dim=-1,
                                                keepdim=True)
        if train_mode and meta.flip_prob > 0 and flip is not None:
            fl = _uniform((o_cnt, a_cap), flip, dev) < meta.flip_prob
            fl = fl & (~arrays.actor_deformable[:, None])
            sign = torch.ones(3, device=dev)
            sign[FLIP_AXIS] = -1.0
            xyz_l = torch.where(fl[..., None], xyz_l * sign, xyz_l)
            q = torch.tensor(FLIP_QUAT, dtype=rot_l.dtype, device=dev)
            rot_l = torch.where(fl[..., None], quaternion_multiply(
                q.expand(rot_l.shape), rot_l), rot_l)
        rmat = quaternion_to_matrix(rots)
        xyz_w = torch.einsum("oij,oaj->oai", rmat, xyz_l) + trans[:, None, :]
        rot_w = quaternion_multiply(rots[:, None, :].expand(rot_l.shape),
                                    rot_l)
        rot_w = rot_w / torch.clamp(
            torch.linalg.norm(rot_w, dim=-1, keepdim=True), min=1e-12)

        denom = torch.clamp(arrays.actor_end_frame - arrays.actor_start_frame,
                            min=1)
        tnorm = (camera.frame - arrays.actor_start_frame) / denom
        basis = idft_basis(tnorm * meta.fourier_scale, meta.fourier_dim)
        f_dc = torch.sum(ac.features_dc * basis[:, None, :, None],
                         dim=2)[:, :, None, :]
        feats = torch.cat([f_dc, ac.features_rest], dim=2)
        dirs = safe_normalize(xyz_w - cam_center)
        obj_deg = min(active_sh_degree, meta.obj_sh_degree)
        color, _ = sh_to_rgb_clamped(obj_deg, feats, dirs)
        mask = act_mask & alive[:, None]

        def flat(x):
            return x.reshape((o_cnt * a_cap,) + tuple(x.shape[2:]))

        parts["xyz"].append(flat(xyz_w))
        parts["color"].append(flat(color))
        parts["op"].append(flat(G.get_opacity(ac)[..., 0]))
        parts["scale"].append(flat(G.get_scaling(ac)))
        parts["rot"].append(flat(rot_w))
        parts["mask"].append(flat(mask))
        if meta.num_classes:
            logits = ac.semantic[..., 0]
            if meta.semantic_mode == "probabilities":
                logits = torch.sigmoid(logits)
            onehot = torch.nn.functional.one_hot(
                arrays.actor_class.long(), meta.num_classes).to(logits.dtype)
            parts["sem"].append(flat(onehot[:, None, :] * logits[..., None]))

    if (include_background and meta.include_sky_gaussians
            and models.sky_gauss is not None):
        sk = models.sky_gauss
        xyz = sky_sphere_xyz(sk.xyz, arrays.sphere_center,
                             arrays.sphere_radius)
        scale = torch.minimum(G.get_scaling(sk), arrays.sphere_radius)
        dirs = safe_normalize(xyz - cam_center)
        color, _ = sh_to_rgb_clamped(active_sh_degree, G.get_features(sk),
                                     dirs)
        parts["xyz"].append(xyz)
        parts["color"].append(color)
        parts["op"].append(G.get_opacity(sk)[:, 0])
        parts["scale"].append(scale)
        parts["rot"].append(G.get_rotation(sk))
        parts["mask"].append(G.active_mask(sk, models.sky_gauss_aux))
        if meta.num_classes:
            parts["sem"].append(G.get_semantic(sk, meta.semantic_mode))

    return ComposedScene(
        means3d=torch.cat(parts["xyz"]),
        colors=torch.cat(parts["color"]),
        opacity=torch.cat(parts["op"]),
        scales=torch.cat(parts["scale"]),
        rotations=torch.cat(parts["rot"]),
        semantics=torch.cat(parts["sem"]) if parts["sem"] else None,
        mask=torch.cat(parts["mask"]),
    )


def submodel_slices(models: SceneModels, include_background=True):
    """(name, start, size) ranges of the flattened arrays: the background,
    each actor slot block `obj_<o>`, then the sky Gaussians."""
    out = []
    ofs = 0
    if include_background:
        b = models.background.capacity
        out.append(("background", 0, b))
        ofs = b
    if models.actors is not None and models.actors.xyz.shape[0]:
        o_cnt, a_cap = models.actors.xyz.shape[:2]
        for o in range(o_cnt):
            out.append((f"obj_{o}", ofs + o * a_cap, a_cap))
        ofs += o_cnt * a_cap
    if models.sky_gauss is not None and include_background:
        out.append(("sky", ofs, models.sky_gauss.capacity))
    return out
