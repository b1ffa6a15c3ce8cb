"""The whole frame of GaussianRPG's loop on the composite scene: the
frame's counted FLOPs over `loop_frame_ms` of this run's window times the
card's FP32 peak, in %. Counted: YOLOv5s's convolutions at its input size
(`rooflines/yolov5.py`), kernel B's operations on the traced frames' live
pair-pixels (`rooflines/blend_fwd.py`, the mean a frame), the compose's
SH and transform work on the slots the program composed a traced frame
(its counter `scene_graph.compose_counts`) and the sky's lookup and
composite (`rooflines/street.py`). Nothing without the peaks, the counts
or the counter."""


def read(ctx):
    peaks, counts = ctx["peaks"], ctx["counts"]
    c = ctx["trace"].get("counters", {}).get("compose", {})
    if peaks is None or not counts or not c.get("frames"):
        return None
    cfg = ctx["cfg"]
    blend = ctx["roofline"]("blend_fwd")
    street = ctx["roofline"]("street")
    a_cap = cfg["config"]["model"]["actor_capacity"]
    flops = (ctx["roofline"]("yolov5").flops(cfg["yolo"])
             + sum(blend.ops(k) for k in counts) / len(counts)
             + street.compose_flops(cfg, c["slots"] / c["frames"],
                                    a_cap * c["actors"] / c["frames"])
             + street.sky_flops(cfg))
    return 100.0 * flops / (ctx["e2e"]["loop_frame_ms"] * 1e-3
                            * peaks["fp32_flops_per_s"])
