"""The port's configuration system held against the JAX package on the
CPU: every `configs/*.yaml` loads to the same tree, the parent chain and
the overrides (tests/test_data_io.py:46), command line scalars resolved as
PyYAML resolves them, unsupported YAML raising, and the port's config, PNG
reading, Waymo scene, scene builder and checkpoints running with PyYAML
and Pillow blocked (the port must run where neither is installed)."""
import glob
import subprocess
import sys
import textwrap

import pytest
import yaml

from gaussianrpg_tpu_torch.config import config as tcfg
from gaussianrpg_tpu_torch.config.yaml_subset import (YamlSubsetError,
                                                       safe_load)

from .torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)

CONFIGS = sorted(glob.glob("configs/*.yaml"))


@pytest.mark.parametrize("path", CONFIGS)
def test_configs_load_as_in_jax(path):
    from gaussianrpg_tpu.config.config import load_config

    assert tcfg.load_config(path).to_dict() == load_config(path).to_dict()
    with open(path) as f:
        text = f.read()
    assert safe_load(text) == yaml.safe_load(text)


def test_config_parent_chain_and_overrides(tmp_path):
    """tests/test_data_io.py:46 for the port."""
    parent = tmp_path / "parent.yaml"
    parent.write_text("exp_name: base\noptim:\n  feature_lr: 0.01\n")
    child = tmp_path / "child.yaml"
    child.write_text(
        f"parent_cfg: {parent}\nexp_name: child\n"
        "model:\n  gaussian:\n    sh_degree: 2\n")
    cfg = tcfg.load_config(str(child), opts=["optim.opacity_lr", "0.123"])
    assert cfg.exp_name == "child"
    assert cfg.optim.feature_lr == 0.01
    assert cfg.model.gaussian.sh_degree == 2
    assert cfg.optim.opacity_lr == 0.123
    assert cfg.optim.scaling_lr == 5e-3
    assert cfg.trained_model_dir.endswith("child/trained_model")


OVERRIDES = ["1e-3", "1.0e-3", "0.0002", "1.0e3", "-.5e+3", "yes", "no",
             "on", "off", "Off", "true", "True", "TRUE", "tRUE", "y", "~",
             "null", "Null", "", "0x10", "-0x1F", "010", "08", "0b101",
             "0o10", "1:30", "1_000", "[0, 19]", "[]", "[a, 'b c', [1, 2.5]]",
             '""', "''", "'it''s'", '"a\\tb"', "abc", "a b", "-1", "+3",
             ".5", "5.", "+.inf", "-.inf", ".NaN", "a: 1"]


@pytest.mark.parametrize("s", OVERRIDES)
def test_override_scalars_resolve_as_pyyaml(s):
    """`_parse_value` (a KEY VALUE override) equals `yaml.safe_load`, type
    included."""
    got, want = tcfg._parse_value(s), yaml.safe_load(s)
    if want != want:                     # NaN
        assert got != got
    else:
        assert (got, type(got)) == (want, type(want))


@pytest.mark.parametrize("text", [
    "- a\n- b", "a: {b: 1}", "a: &x 1", "a: *x", "a: !!str 1",
    "a: |\n  text", "a: >\n  text", "---\na: 1", "a: 2002-12-14",
    "a: [1,\n  2]", "a:\n\tb: 1", "a: b: c", "a: 1\n  b: 2",
    "a: \"unterminated"])
def test_unsupported_yaml_raises(text):
    with pytest.raises(YamlSubsetError):
        safe_load(text)


def test_comments_and_nesting():
    text = ("# top\na:   # after a key\n  b: 1   # after a value\n"
            "  c:\n    d: [1, 2]  # list\n  e: 'x # not a comment'\n"
            "f: \"\"\ng:\n")
    assert safe_load(text) == yaml.safe_load(text)


def test_port_runs_without_pyyaml_and_pillow(tmp_path):
    """In an interpreter where `import yaml` and `import PIL` fail: every
    config loads, a PNG reads, the Waymo scene loads (images resized, the
    initial PLYs built from pointcloud.npz), the scene builds, and a
    checkpoint saves and loads."""
    from .torch_parity import write_test_scene

    write_test_scene(tmp_path / "scene")
    code = textwrap.dedent(f"""
        import sys
        sys.modules["yaml"] = None
        sys.modules["PIL"] = None
        import glob, torch
        torch.set_num_threads(1)
        from gaussianrpg_tpu_torch.config.config import load_config
        from gaussianrpg_tpu_torch.data.image_io import read_png
        from gaussianrpg_tpu_torch.data.waymo import WaymoScene
        from gaussianrpg_tpu_torch.models.scene_builder import (
            build_scene_from_waymo)
        from gaussianrpg_tpu_torch.models.scene_io import (
            load_checkpoint, save_checkpoint)
        from gaussianrpg_tpu_torch.train.trainer import init_train_state
        for p in sorted(glob.glob("configs/*.yaml")):
            load_config(p)
        root = {str(tmp_path / "scene")!r}
        assert read_png(root + "/images/000000_0.png").shape == (96, 128, 3)
        cfg = load_config("configs/waymo_149_1cam.yaml", [
            "source_path", root, "data.selected_frames", "[0, 5]",
            "resolution", "2", "model.actor_capacity", "256"])
        scene = WaymoScene(root, selected_frames=[0, 5], resolution=2)
        cams = scene.build_cameras("train", device="cpu")
        planes = scene.load_batch_planes(0, 0, (48, 64))
        assert cams[0][1].shape == (3, 48, 64) and "sky_mask" in planes
        models, meta, arrays, names = build_scene_from_waymo(
            scene, cfg, device="cpu")
        state = init_train_state(models)
        save_checkpoint(root + "/iteration_1.npz", state, 1, 0)
        back, step, _ = load_checkpoint(root + "/iteration_1.npz", state)
        assert step == 1 and torch.equal(back.models.background.xyz,
                                         models.background.xyz)
        assert "yaml" not in [m for m in sys.modules if sys.modules[m]]
        assert not any(m.startswith("PIL") and sys.modules[m]
                       for m in sys.modules)
        print("ok", names)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")
