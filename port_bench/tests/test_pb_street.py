"""The street cell (`loop_street600k_aeb`): its entries in BENCHMARK.json,
a CPU run of its driver at a small size, faults in the program that its
check catches, and its four controls (the reference's splat fields and
poses in bfloat16, SH degree 1, the actors' Fourier time held at 0, no
sky) each outside a limit, here at the small size and on the card at
the cell's own (`python -m pytest -m cuda port_bench/tests`)."""
import copy
import json
from pathlib import Path

import pytest

from port_bench import calibrate_street, compare, core

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = calibrate_street.CELL
SEED = 2**31 + 17


def small_overrides() -> dict:
    """The street cell at 192x128 with 4,000 background Gaussians, 256 a
    vehicle, a 16^2 sky, two 1 s episodes a cycle."""
    _, cfg = core.cell_files(CELL)
    sc = copy.deepcopy(cfg["scene"])
    sc.update(gaussians=4000, width=192, height=128)
    sc["ground"]["count"], sc["facades"]["count"] = 2000, 1500
    c = copy.deepcopy(cfg["config"])
    c["model"]["actor_capacity"] = 512
    return dict(scene=sc, config=c,
                sky_cubemap=dict(cfg["sky_cubemap"], resolution=16),
                episode_s=1.0, lateral_offsets_m=[-0.5, 0.5], samples=2,
                trace={"warmup_frames": 1, "frames": 2})


@pytest.fixture
def small():
    return small_overrides()


def run(small, **kw):
    return core.run_cell(CELL, SEED, 0.01, False, "cpu", overrides=small,
                         **kw)


def test_entries_are_new_and_complete():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    w = cells[CELL]
    assert (w["config"], w["traffic"], w["chips"]) == (
        "street600k_w149", CELL, 1)
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert cfg["reduced"] == [] and cfg["file"].endswith(
        "street600k_w149.json")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for name in ("loop_frame_ms", "loop_frame_p95_ms"):
        assert e2e[name]["workloads"] == ["loop_frozen600k_yolo", CELL]
    mine = [m for m in BENCH["per_layer"] if CELL in m["workloads"]]
    assert [m["name"] for m in mine] == [
        "compose_device_ms.street", "rasterize_device_ms.street",
        "sky_device_ms.street", "scatter_device_ms.street",
        "cummax_roofline.street", "blend_fwd_roofline.street", "street_mfu"]
    assert all(m["workloads"] == [CELL] and m["moves"] == "loop_frame_ms"
               for m in mine)
    wl, c = core.cell_files(CELL)
    assert wl["driver"] == "street_loop" and set(wl["limits"]) == {
        "image_max_gap", "image_mean_gap", "box_gap_px",
        "decision_mismatches"}
    gc = c["config"]["model"]["gaussian"]
    assert (gc["sh_degree"], gc["fourier_dim"]) == (3, 5)
    assert c["config"]["render"]["tile_x"] == 16


def test_small_run_is_correct(small, capfd):
    out = run(small)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == 2 * 11
    err = capfd.readouterr().err
    assert "braked first at frame 2" in err


def test_controls_each_fail_a_limit(small):
    limits = core.cell_files(CELL)[0]["limits"]
    rec = calibrate_street.readings(SEED, 0.01, "cpu", small)
    ok, checks = compare.judge(rec["program"], limits)
    assert ok, checks
    assert set(rec["controls"]) == {"bfloat16", "sh1", "fourier_t0",
                                    "no_sky"}
    for name, nums in rec["controls"].items():
        ok, checks = compare.judge(dict(nums, decision_mismatches=0),
                                   limits)
        assert not ok, (name, checks)


def test_fourier_time_on_dynamics_ticks_is_caught(small, monkeypatch):
    """A loop that hands the scene its 50 Hz tick as the image frame (the
    actors' Fourier colour runs five times too fast) fails the image
    limits."""
    from gaussianrpg_tpu_torch.sim import loop

    orig = loop._camera_from_pose
    first = core.cell_files(CELL)[1]["config"]["data"]["selected_frames"][0]

    def on_ticks(template, pose, frame, timestamp):
        return orig(template, pose, (frame - first) * 5, timestamp)

    monkeypatch.setattr(loop, "_camera_from_pose", on_ticks)
    out = run(small)
    assert not out["correct"]
    assert out["checks"]["image_mean_gap"]["value"] > \
        out["checks"]["image_mean_gap"]["limit"]


def test_ranging_scaled_by_one_and_a_half_is_caught(small, monkeypatch):
    """The fault the frozen cell lets pass: a ranger that reads 1.5 times
    the distance brakes late, and the decisions differ."""
    from gaussianrpg_tpu_torch.sim import nodes

    orig = nodes.GroundPlaneRanger.distance

    def far(self, box):
        r, lat = orig(self, box)
        return 1.5 * r, lat

    monkeypatch.setattr(nodes.GroundPlaneRanger, "distance", far)
    out = run(small)
    assert not out["correct"]
    assert out["checks"]["decision_mismatches"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [21, 2**31 + 21])
def test_controls_fail_and_program_passes_at_full_size(cuda_card, seed):
    limits = core.cell_files(CELL)[0]["limits"]
    rec = calibrate_street.readings(seed, 0.1, overrides={"episode_s": 2.0})
    ok, checks = compare.judge(rec["program"], limits)
    assert ok, checks
    for name, nums in rec["controls"].items():
        ok, checks = compare.judge(dict(nums, decision_mismatches=0),
                                   limits)
        assert not ok, (name, checks)
