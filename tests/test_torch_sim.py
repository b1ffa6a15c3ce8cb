"""The port's closed loop (tape -> render -> box-projection detector ->
AEB -> dynamics) on the CPU, the same properties as tests/test_sim.py:94,
plus a tick-for-tick comparison with the JAX loop; and the package rules:
importing every module leaves JAX and the JAX package unloaded, and the
entry points refuse to run without CUDA unless given device="cpu"."""
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from gaussianrpg_tpu_torch.apps import simulate as tsim
from gaussianrpg_tpu_torch.sim.loop import run_closed_loop

from .torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)

LOOP_KW = dict(brake_distance=18.0, collision_threshold=4.0,
               simulation_time=3.0, max_ticks=220, cam_height=1.1)


def test_closed_loop_brakes_before_collision():
    """Full loop at 128x80 rendered by the port: with AEB the ego must not
    collide."""
    tape, render_fn, detector, cam0, gt, v2c = tsim._synthetic_setup(
        width=128, height=80, device="cpu")
    frames = []

    def render(cam):
        img = render_fn(cam)
        frames.append(img)
        return img

    result = run_closed_loop(tape, render, detector, cam0, gt,
                             ranger_extrinsic=v2c, **LOOP_KW)
    assert result.frames_rendered > 5
    assert result.verdict in ("success", "timeout")
    assert any(e["brake"] != 0.0 for e in result.log), "AEB never braked"
    assert result.min_gt_distance > 4.0
    assert all(f.shape == (3, 80, 128) and np.isfinite(f).all()
               for f in frames)
    assert max(float(f.mean()) for f in frames) > 0.05   # not blank


def test_closed_loop_matches_jax_loop():
    """Detection is geometric, so the loop's trajectory does not depend on
    the pixels: the port's nodes, tape, detector and loop must reproduce
    the JAX loop tick for tick (frames replaced by blanks on both
    sides)."""
    pytest.importorskip("jax")
    from gaussianrpg_tpu.apps import simulate as jsim
    from gaussianrpg_tpu.sim.loop import run_closed_loop as j_loop

    blank = np.zeros((3, 80, 128), np.float32)
    jt, _, jdet, jcam0, jgt, jv2c = jsim._synthetic_setup(128, 80)
    a = j_loop(jt, lambda c: blank, jdet, jcam0, jgt, ranger_extrinsic=jv2c,
               **LOOP_KW)
    tt, _, tdet, tcam0, tgt, tv2c = tsim._synthetic_setup(
        128, 80, n_background=200, bkgd_capacity=256, device="cpu")
    assert tt == jt
    b = run_closed_loop(tt, lambda c: blank, tdet, tcam0, tgt,
                        ranger_extrinsic=tv2c, **LOOP_KW)
    assert (b.verdict, b.ticks, b.frames_rendered) == (
        a.verdict, a.ticks, a.frames_rendered)
    assert b.min_gt_distance == pytest.approx(a.min_gt_distance, abs=1e-6)
    for ea, eb in zip(a.log, b.log):
        assert (eb["tick"], eb["n_det"], eb["brake"]) == (
            ea["tick"], ea["n_det"], ea["brake"])
        assert eb["velocity"] == pytest.approx(ea["velocity"], abs=1e-6)


def test_simulate_cli_prints_verdict_line(capsys):
    tsim.main(["--synthetic", "--width", "64", "--height", "48",
               "--simulation-time", "1.0", "--device", "cpu"])
    import json
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"verdict", "ticks", "frames", "min_gt_distance",
                         "render_fps", "wall_time"}
    assert line["verdict"] == "success" and line["frames"] > 5


def test_port_imports_no_jax():
    """Every module of the port, the data-preparation apps and the
    multi-device layer among them, imports in a fresh interpreter without
    loading jax, flax, the JAX package or Pillow (which the card lacks)."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import gaussianrpg_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "gaussianrpg_tpu", "PIL"))
        assert not bad, bad
        prep = ["data.native", "data.waymo_proto", "utils.waymo_record",
                "parallel.sharded", "parallel.distributed",
                "parallel.collectives"] + [
            "apps." + a for a in (
                "waymo_converter", "generate_lidar_depth",
                "generate_sky_mask", "kitti_prep", "colmap_convert",
                "colmap_triangulate", "generate_mono_depth",
                "generate_mono_normal", "scaling_bench")]
        missing = [m for m in prep if pkg.__name__ + "." + m not in names]
        assert not missing, missing
        assert len(names) >= 20, names
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_need_cuda_unless_told_cpu(monkeypatch):
    """Without CUDA the entry points raise unless device="cpu" is given;
    nothing falls back silently."""
    from gaussianrpg_tpu_torch.ops.rasterize import rasterize
    from gaussianrpg_tpu_torch.render.camera import make_camera
    from gaussianrpg_tpu_torch.utils.synthetic import make_scene

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_scene(n_background=100, bkgd_capacity=128, n_actors=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_camera(np.eye(3), np.zeros(3), None, 32, 32, fovx=1.0,
                    fovy=1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.main(["--synthetic", "--width", "32", "--height", "32"])
    cam = make_camera(np.eye(3), np.zeros(3), None, 32, 32, fovx=1.0,
                      fovy=1.0, device="cpu")
    means = torch.tensor([[0.0, 0.0, 4.0]])
    with pytest.raises(RuntimeError, match="CUDA"):
        rasterize(means, torch.tensor([0.5]), camera=cam,
                  bg_color=torch.zeros(3), colors=torch.ones(1, 3),
                  scales=torch.full((1, 3), 0.1))
    out = rasterize(means, torch.tensor([0.5]), camera=cam,
                    bg_color=torch.zeros(3), colors=torch.ones(1, 3),
                    scales=torch.full((1, 3), 0.1), capacity=1024,
                    device="cpu")
    assert float(out.alpha.max()) > 0.1
