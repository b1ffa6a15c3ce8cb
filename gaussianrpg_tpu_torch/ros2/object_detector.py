"""Object-detector node for separate perception: front_image -> YOLOv5 ->
ground-plane ranging -> objects.

Counterpart of `ros2/src/dummy_controllers/dummy_controllers/
object_detector.py`:

    python -m gaussianrpg_tpu_torch.ros2.object_detector \\
        [yolov5_weights_path] [--device cuda]

The port's `sim.detector.YoloDetector` reads the checkpoint (default
`yolov5s.pt`) when the node is built, so an unreadable one raises there;
there is no other detector to fall back to. The ranger is the reference
node's: Waymo FRONT intrinsics at 1600x1066 and its vehicle->camera
matrix, hard-coded.
"""
import sys

import numpy as np

from ..apps.ros2_nodes import pop_option, pose_array, spin_node
from ..sim.nodes import GroundPlaneRanger
from ..utils.spans import span

K_FRONT = np.array([[1734.5911 / 1.2, 0.0, 1600 / 2.0],
                    [0.0, 1734.5911 / 1.2, 1066 / 2.0],
                    [0.0, 0.0, 1.0]])
V2C = np.array([[0.0, -1.0, 0.0, 0.0], [0.0, 0.0, -1.0, 0.0],
                [1.0, 0.0, 0.0, -1.544], [0.0, 0.0, 0.0, 1.0]])


def front_ranger() -> GroundPlaneRanger:
    return GroundPlaneRanger(width=1600, height=1066, K=K_FRONT,
                             extrinsic=V2C, cam_height=2.115)


def decode_rgb8(msg) -> np.ndarray:
    """An rgb8 Image message -> [3, H, W] float32 in [0, 1]; the span
    `ros2.decode` under a profiler."""
    with span("ros2.decode"):
        rgb = np.frombuffer(msg.data, np.uint8).reshape(
            msg.height, msg.width, 3).transpose(2, 0, 1) / 255.0
        return rgb.astype(np.float32)


def make_node():
    """The node, configured from sys.argv (needs rclpy)."""
    from geometry_msgs.msg import PoseArray
    from rclpy.node import Node
    from sensor_msgs.msg import Image

    from ..sim.detector import YoloDetector

    class ObjectDetector(Node):
        def __init__(self):
            super().__init__("object_detector")
            argv = sys.argv[1:]
            device = pop_option(argv, "--device")
            weights = argv[0] if argv else "yolov5s.pt"
            self.det = YoloDetector(weights_path=weights, device=device)
            self.det._ensure()      # read the checkpoint now: raise here
            self.ranger = front_ranger()
            self.pub = self.create_publisher(PoseArray, "objects", 10)
            self.create_subscription(Image, "front_image", self.on_image,
                                     10)

        def on_image(self, msg):
            boxes = self.det.detect(decode_rgb8(msg), None)
            self.pub.publish(pose_array(boxes, self.ranger, msg.header))

    return ObjectDetector()


def main(args=None):
    spin_node(make_node, args)


if __name__ == "__main__":
    main()
