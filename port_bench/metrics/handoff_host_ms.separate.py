"""The separate-perception hand-off on the host: the host time of the
program's `ros2.rgb8` spans (the simulator node's float image to the
message's 8-bit bytes, `ros2/simulator.rgb8_bytes`) and `ros2.decode`
spans (the detector node's bytes back to a float image,
`ros2/object_detector.decode_rgb8`) in the traced stretch, on the host
thread, in ms a traced frame. Nothing when the trace holds neither."""


def read(ctx):
    t = ctx["trace"]
    us = t.get("handoff_us")
    return us * 1e-3 / t["frames"] if us else None
