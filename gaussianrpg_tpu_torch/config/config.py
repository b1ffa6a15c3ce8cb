"""Hierarchical YAML configuration system.

Counterpart of `gaussianrpg_tpu/config/config.py`, the same code but for
the YAML reader: PyYAML's `safe_load` becomes `yaml_subset.safe_load`,
which reads the subset of YAML that the configuration files and the
command line overrides use and resolves scalars as PyYAML does, so the
port runs where PyYAML is not installed.

The JAX package re-implements the reference's vendored-yacs setup
(`lib/config/yacs.py`, `lib/config/config.py:9-158`,
`lib/utils/cfg_utils.py:79-99`): an attribute-dict config with recursive
`parent_cfg` chaining, dotted-key CLI overrides (`KEY VALUE` pairs), and
derived output paths. Unlike the reference, nothing happens at import time —
`load_config()` is an explicit call — and the schema lives in
DEFAULT_CONFIG below instead of a global singleton.
"""
from __future__ import annotations

import argparse
import copy
import os
from typing import Any

from .yaml_subset import safe_load


class CfgNode(dict):
    """dict with attribute access (a minimal yacs.CfgNode)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def get(self, key, default=None):
        return super().get(key, default)

    @staticmethod
    def from_dict(d: dict) -> "CfgNode":
        node = CfgNode()
        for k, v in d.items():
            node[k] = CfgNode.from_dict(v) if isinstance(v, dict) else v
        return node

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, CfgNode) else v
                for k, v in self.items()}

    def clone(self) -> "CfgNode":
        return CfgNode.from_dict(copy.deepcopy(self.to_dict()))


def merge(base: CfgNode, other: dict) -> CfgNode:
    """Recursive merge of `other` into a copy of `base` (yacs
    merge_from_other_cfg semantics; unknown keys are allowed, matching the
    reference's scene-specific extra keys like `traj_file_path`)."""
    out = base.clone()

    def _merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), CfgNode):
                _merge(dst[k], v)
            else:
                dst[k] = CfgNode.from_dict(v) if isinstance(v, dict) else v

    _merge(out, other)
    return out


DEFAULT_CONFIG = {
    "task": "street_gaussian",
    "exp_name": "default",
    "workspace": "output",
    "mode": "train",
    "source_path": "",
    "model_path": "",
    "resume": True,
    "loaded_iter": -1,
    "resolution": -1,
    "resolution_scales": [1],
    "ip": "127.0.0.1",
    "port": 6009,
    "debug_from": -1,
    "detect_anomaly": False,
    "seed": 0,
    "data": {
        "type": "Waymo",
        "white_background": False,
        "use_semantic": False,
        "num_classes": 0,
        "selected_frames": [],
        "cameras": [0],
        "extent": 20.0,
        "use_colmap": False,
        "box_scale": 1.0,
        "split_test": -1,
        "split_train": -1,
    },
    "model": {
        "gaussian": {
            "sh_degree": 3,
            "fourier_dim": 1,
            "fourier_scale": 1.0,
            "flip_prob": 0.0,
            "semantic_mode": "logits",
        },
        "nsg": {
            "include_bkgd": True,
            "include_obj": True,
            "include_sky": False,
            # trainable sky-sphere Gaussians (gaussian_model_sky.py
            # alternative to the cubemap)
            "include_sky_gaussians": False,
            "opt_track": True,
        },
        "sky_capacity": 16384,
        "use_color_correction": False,
        "use_pose_correction": False,
        "color_correction": {"mode": "image", "use_mlp": False},
        "pose_correction": {"mode": "image"},
    },
    "train": {
        "iterations": 30000,
        "test_iterations": [7000, 30000],
        "save_iterations": [30000],
        "checkpoint_iterations": [30000],
        "debug_from": -1,
    },
    "optim": {
        "position_lr_init": 1.6e-4,
        "position_lr_final": 1.6e-6,
        "position_lr_delay_mult": 0.01,
        "position_lr_max_steps": 30000,
        "feature_lr": 2.5e-3,
        "opacity_lr": 0.05,
        "scaling_lr": 5e-3,
        "rotation_lr": 1e-3,
        "semantic_lr": 1e-3,
        "percent_dense": 0.01,
        "percent_big_ws": 0.1,
        "lambda_l1": 1.0,
        "lambda_dssim": 0.2,
        "lambda_sky": 0.0,
        "lambda_sky_scale": [],
        "lambda_semantic": 0.0,
        "lambda_reg": 0.0,
        "lambda_depth_lidar": 0.0,
        "lambda_color_correction": 0.0,
        "lambda_pose_correction": 0.0,
        "lambda_scale_flatten": 0.0,
        "lambda_opacity_sparse": 0.0,
        "lambda_normal_mono": 0.0,
        "densification_interval": 100,
        "opacity_reset_interval": 3000,
        "densify_from_iter": 500,
        "densify_until_iter": 15000,
        "densify_grad_threshold": 2e-4,
        "densify_grad_abs_bkgd": False,
        "densify_grad_abs_obj": False,
        "min_opacity": 0.005,
        "track_position_lr_init": 5e-4,
        "track_position_lr_final": 1e-4,
        "track_position_lr_delay_mult": 0.01,
        "track_position_max_steps": 30000,
        "track_rotation_lr_init": 1e-4,
        "track_rotation_lr_final": 1e-5,
        "track_rotation_lr_delay_mult": 0.01,
        "track_rotation_max_steps": 30000,
        "sky_lr": 1e-2,
        "color_correction_lr_init": 5e-4,
        "color_correction_lr_final": 5e-5,
        "pose_correction_lr_init": 5e-6,
        "pose_correction_lr_final": 1e-6,
    },
    "render": {
        "convert_SHs_python": False,
        "compute_cov3D_python": False,
        "debug": False,
        "scaling_modifier": 1.0,
        "render_normal": False,
        "fps": 10,
        "capacity": 1 << 21,
        # blend tiling: 16x16 = exact CUDA-parity; 64x32 measured ~1.9x
        # faster frames on street scenes (PERF.md); tile_x*tile_y % 128 == 0
        "tile_x": 16,
        "tile_y": 16,
        # 128-pair sub-chunks per blend grid step (capacity must divide by
        # sub_chunks*128; amortizes the kernel's per-step floor)
        "sub_chunks": 1,
        # right-size the pair capacity at scene load by probing a few
        # frames (renderer.probe_scene_capacity; the CUDA analog sizes
        # binning buffers from the real pair count before every launch,
        # rasterizer_impl.cu:155-193). `capacity` above becomes the
        # fallback when probing is off; overflow grow-and-retry remains
        # the mid-run safety net either way.
        "autosize": True,
        "save_video": True,
        "save_image": True,
        "coord": "world",
    },
    "eval": {
        "skip_train": False,
        "skip_test": False,
        "eval_train": True,
        "eval_test": True,
        # in-repo JAX LPIPS (utils/lpips.py; reference metrics.py:81):
        # point at a torchvision backbone state_dict + richzhang lin
        # weights to enable — inference is pure JAX, torch converts once
        "lpips": {
            "backbone_path": "",
            "lin_path": "",
            "net_type": "vgg",
        },
    },
    "sim": {
        "traj_file_path": "",
        "separate_perception": False,
        # fused single-dispatch inline perception (sim/pipeline.py) when
        # a JAX YOLO checkpoint is configured; False falls back to the
        # two-dispatch render->detector path
        "fused_perception": True,
        "yolov5_weights_path": "",
        "dynamic_freq": 50.0,
        "image_freq": 10.0,
        "collision_threshold": 5.5,
        "brake_distance": 15.0,
        "simulation_time": 15.0,
    },
}


def load_yaml_chain(path: str) -> dict:
    """Load a YAML with recursive `parent_cfg` merging
    (`cfg_utils.make_cfg:79-99`)."""
    with open(path) as f:
        data = safe_load(f.read()) or {}
    if "parent_cfg" in data:
        parent_path = data.pop("parent_cfg")
        if not os.path.isabs(parent_path):
            for base in (os.path.dirname(path), os.getcwd()):
                cand = os.path.join(base, parent_path)
                if os.path.exists(cand):
                    parent_path = cand
                    break
        parent = load_yaml_chain(parent_path)

        def _m(dst, src):
            for k, v in src.items():
                if isinstance(v, dict) and isinstance(dst.get(k), dict):
                    _m(dst[k], v)
                else:
                    dst[k] = v
        _m(parent, data)
        return parent
    return data


def _parse_value(s: str) -> Any:
    try:
        return safe_load(s)
    except Exception:
        return s


def apply_overrides(cfg: CfgNode, opts: list[str]) -> CfgNode:
    """Apply `KEY VALUE` pairs with dotted keys (yacs merge_from_list)."""
    assert len(opts) % 2 == 0, "opts must be KEY VALUE pairs"
    for key, val in zip(opts[::2], opts[1::2]):
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], CfgNode):
                node[p] = CfgNode()
            node = node[p]
        node[parts[-1]] = _parse_value(val)
    return cfg


def derive_paths(cfg: CfgNode) -> CfgNode:
    """Derived output dirs (`cfg_utils.parse_cfg:5-77`)."""
    if not cfg.model_path:
        cfg.model_path = os.path.join(cfg.workspace, cfg.task, cfg.exp_name)
    cfg.trained_model_dir = os.path.join(cfg.model_path, "trained_model")
    cfg.point_cloud_dir = os.path.join(cfg.model_path, "point_cloud")
    cfg.record_dir = os.path.join(cfg.model_path, "record")
    return cfg


def load_config(path: str | None = None, opts: list[str] | None = None,
                mode: str | None = None) -> CfgNode:
    cfg = CfgNode.from_dict(DEFAULT_CONFIG)
    if path:
        cfg = merge(cfg, load_yaml_chain(path))
    if opts:
        cfg = apply_overrides(cfg, list(opts))
    if mode:
        cfg.mode = mode
    return derive_paths(cfg)


def make_argparser(description: str) -> argparse.ArgumentParser:
    """CLI mirroring `lib/config/config.py:146-152`."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--mode", type=str, default=None)
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p
