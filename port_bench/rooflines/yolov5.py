"""YOLOv5's convolutions on one letterboxed frame: multiply-add FLOPs (two
a product) of every conv of the configuration's graph at its input size
(`reference.yolo.conv_flops`); activations, pooling and the decode are
not counted. YOLOv5s v6.0 at 640x640 gives Ultralytics' published 16.5
GFLOPs."""
from port_bench.reference import yolo


def flops(yc: dict) -> float:
    lays = yolo.layers(yc["depth_multiple"], yc["width_multiple"],
                       yc["num_classes"])
    return float(yolo.conv_flops(lays, *yc["input_hw"]))
