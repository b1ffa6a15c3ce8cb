"""`correct` comes out false when the timed path is broken underneath: a
run at a tiny size on the CPU, skipping the look for a card, with one
fault planted in the port each time (a stale frame, a moved candidate,
NMS that drops a detection, a brake command of the wrong tier), and with the control (the plain reference one
precision step down) in the port's place."""
from port_bench import calibrate, compare, core
from conftest import CELL


def run(tiny):
    return core.run_cell(CELL, 2**31 + 9, 0.01, False, "cpu",
                         overrides=tiny)


def test_sound_run_is_correct(tiny, one_thread, capfd):
    out = run(tiny)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 12 and out["failed"] == 0
    assert list(out["checks"]) == list(core.cell_files(CELL)[0]["limits"])
    # the check has detections and brake commands to compare
    err = capfd.readouterr().err
    assert "NMS kept 0.00" not in err and "braked on 0 of" not in err


def decisions_fail(out):
    return not out["correct"] and \
        out["checks"]["decision_mismatches"]["value"] > 0


def test_nms_that_drops_a_detection_is_caught(tiny, one_thread,
                                              monkeypatch):
    from gaussianrpg_tpu_torch.sim import pipeline

    real = pipeline.nms_boxes

    def dropping(*a, **kw):
        return real(*a, **kw)[:-1]

    monkeypatch.setattr(pipeline, "nms_boxes", dropping)
    assert decisions_fail(run(tiny))


def test_brake_of_the_wrong_tier_is_caught(tiny, one_thread, monkeypatch):
    from gaussianrpg_tpu_torch.sim.nodes import AebController

    real = AebController.on_objects

    def weak(self, objects):
        cmd = real(self, objects)
        return -10.0 if cmd == -13.5 else cmd

    monkeypatch.setattr(AebController, "on_objects", weak)
    assert decisions_fail(run(tiny))


def test_stale_frame_is_caught(tiny, one_thread, monkeypatch):
    """The render returns the state it had: the previous frame again."""
    from gaussianrpg_tpu_torch.ops import rasterize as R

    real, last = R.rasterize, {}

    def stale(*a, **kw):
        out = last.get("out") or real(*a, **kw)
        last["out"] = out
        return out

    monkeypatch.setattr(R, "rasterize", stale)
    assert not run(tiny)["correct"]


def test_altered_candidate_is_caught(tiny, one_thread, monkeypatch):
    """One answer altered where it is produced: a candidate moved 4 px."""
    from gaussianrpg_tpu_torch.sim import pipeline

    real = pipeline.topk_candidates

    def altered(*a, **kw):
        out = real(*a, **kw).clone()
        out[3, 0] += 4.0
        return out

    monkeypatch.setattr(pipeline, "topk_candidates", altered)
    out = run(tiny)
    assert not out["correct"]
    assert out["checks"]["cand_box_gap"]["value"] > \
        out["checks"]["cand_box_gap"]["limit"]


def test_control_is_not_correct(tiny, one_thread):
    """The control, put in the port's place, fails the limits."""
    limits = core.cell_files(CELL)[0]["limits"]
    rec = calibrate.readings(CELL, 2**31 + 13, 0.01, "cpu", tiny)
    ok, _ = compare.judge(rec["program"], limits)
    assert ok
    control = dict(rec["control"], decision_mismatches=0)
    ok, checks = compare.judge(control, limits)
    assert not ok, checks
