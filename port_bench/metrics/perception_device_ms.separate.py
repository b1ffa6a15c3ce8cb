"""The separate path's detector (`sim/detector.YoloDetector.detect`,
`sim/yolo.YoloDetector`: the host letterbox's copy to the card, YOLOv5s in
cuDNN FP32, the predictions' copy back): the device time of the work
launched inside the program's `detector.yolo` spans in the traced stretch
(the union of the device records whose launches fall inside them on the
host thread, by correlation id), in ms a traced frame. Nothing when the
trace holds no such span."""


def read(ctx):
    t = ctx["trace"]
    us = t.get("detector_us")
    return us * 1e-3 / t["frames"] if us else None
