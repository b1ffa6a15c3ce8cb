"""The whole closed-loop frame: the frame's counted FLOPs, YOLOv5's
convolutions (`rooflines/yolov5.py`) and kernel B's operations on the
traced frames' live pair-pixels (`rooflines/blend_fwd.py`, the mean a
frame), over `loop_frame_ms` of this run's window times the card's FP32
peak, in %."""


def read(ctx):
    peaks = ctx["peaks"]
    if peaks is None:
        return None
    counts = ctx["counts"]
    blend = ctx["roofline"]("blend_fwd")
    flops = ctx["roofline"]("yolov5").flops(ctx["cfg"]["yolo"]) \
        + sum(blend.ops(c) for c in counts) / len(counts)
    return 100.0 * flops / (ctx["e2e"]["loop_frame_ms"] * 1e-3
                            * peaks["fp32_flops_per_s"])
