"""The port's closed loop through the fused inline-perception path on the
CPU: a real braking event (tests/test_sim.py's
`test_braking_event_through_fused_pipeline`) driven by render -> device
letterbox -> red-blob predictor -> top-K -> host NMS -> ranging -> AEB ->
dynamics, whose empty-perception control collides; and the `perceive_fn`
loop held tick for tick against the JAX loop with the same deterministic
perception on both sides."""
import pytest

from gaussianrpg_tpu_torch.apps import simulate as tsim
from gaussianrpg_tpu_torch.sim.detector import (VEHICLE_CLASSES,
                                                normalized_boxes)
from gaussianrpg_tpu_torch.sim.loop import run_closed_loop
from gaussianrpg_tpu_torch.sim.pipeline import (finish_detections,
                                                make_fused_step)
from gaussianrpg_tpu_torch.utils.synthetic import (red_blob_predict,
                                                   red_lead_setup)

from .torch_parity import one_cpu_thread  # noqa: F401  (autouse fixture)

H, W = 80, 128
BRAKE_KW = dict(brake_distance=15.0, collision_threshold=5.0,
                simulation_time=3.5, cam_height=1.3)


def test_braking_event_through_fused_pipeline():
    tape, render_rgb, cam0, gt, v2c = red_lead_setup(W, H, device="cpu")
    step, gain, pad = make_fused_step(
        render_rgb, None, None, (H, W), size=(48, 80), k=8,
        classes=VEHICLE_CLASSES, predict_fn=red_blob_predict)

    def perceive(cam):
        det = finish_detections(step(cam), gain, pad, (H, W),
                                conf_thres=0.4)
        return normalized_boxes(det, H, W)

    result = run_closed_loop(tape, None, None, cam0, gt, perceive_fn=perceive,
                             ranger_extrinsic=v2c, **BRAKE_KW)
    assert len(result.frame_seconds) == result.frames_rendered > 5
    assert any(e["n_det"] > 0 for e in result.log), "no fused detections"
    assert any(e["brake"] != 0.0 for e in result.log), \
        "fused pipeline never triggered the AEB brake"
    assert result.verdict == "success", result.verdict
    assert result.min_gt_distance > 5.0
    assert result.log[-1]["velocity"] < 0.5, "ego did not stop"

    # control: no perception -> the same scenario must collide
    control = run_closed_loop(tape, None, None, cam0, gt,
                              perceive_fn=lambda cam: [],
                              ranger_extrinsic=v2c, **BRAKE_KW)
    assert control.verdict == "collision", control.verdict


def test_perceive_fn_loop_matches_jax_loop():
    """Both loops perceive through `perceive_fn` alone (render_fn and
    detector None) with the box-projection detector's geometric boxes, so
    the trajectory does not depend on pixels: the port must reproduce the
    JAX loop tick for tick, braking included."""
    pytest.importorskip("jax")
    from gaussianrpg_tpu.apps import simulate as jsim
    from gaussianrpg_tpu.sim.loop import run_closed_loop as j_loop

    kw = dict(brake_distance=18.0, collision_threshold=4.0,
              simulation_time=3.0, max_ticks=220, cam_height=1.1)
    jt, _, jdet, jcam0, jgt, jv2c = jsim._synthetic_setup(128, 80)
    a = j_loop(jt, None, None, jcam0, jgt, ranger_extrinsic=jv2c,
               perceive_fn=lambda c: jdet.detect(None, c), **kw)
    tt, _, tdet, tcam0, tgt, tv2c = tsim._synthetic_setup(
        128, 80, n_background=200, bkgd_capacity=256, device="cpu")
    assert tt == jt
    b = run_closed_loop(tt, None, None, tcam0, tgt, ranger_extrinsic=tv2c,
                        perceive_fn=lambda c: tdet.detect(None, c), **kw)
    assert any(e["brake"] != 0.0 for e in a.log)
    assert (b.verdict, b.ticks, b.frames_rendered) == (
        a.verdict, a.ticks, a.frames_rendered)
    assert len(b.frame_seconds) == b.frames_rendered
    assert b.min_gt_distance == pytest.approx(a.min_gt_distance, abs=1e-6)
    assert len(a.log) == len(b.log)
    for ea, eb in zip(a.log, b.log):
        assert (eb["tick"], eb["n_det"], eb["brake"]) == (
            ea["tick"], ea["n_det"], ea["brake"])
        assert eb["velocity"] == pytest.approx(ea["velocity"], abs=1e-6)
