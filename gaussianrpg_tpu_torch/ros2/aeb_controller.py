"""AEB controller node: the closest object within the lateral gate is the
CIPV; the ego's velocity comes from differencing cam_pose; a tiered brake
goes out on control_cmd (linear.x, m/s^2) only when it is non-zero.

Counterpart of `ros2/src/dummy_controllers/dummy_controllers/
AEB_controller.py`:

    python -m gaussianrpg_tpu_torch.ros2.aeb_controller [brake_distance]
"""
import sys

from ..apps.ros2_nodes import spin_node
from ..sim.nodes import AebController as AebCore
from .evaluation import stamp_seconds


def make_node():
    """The node, configured from sys.argv (needs rclpy)."""
    from geometry_msgs.msg import (PoseArray, PoseWithCovarianceStamped,
                                   TwistStamped)
    from rclpy.node import Node

    class Controller(Node):
        def __init__(self):
            super().__init__("aeb_controller")
            brake_distance = float(sys.argv[1]) if len(sys.argv) > 1 \
                else 24.0
            self.core = AebCore(brake_distance=brake_distance)
            self.pub = self.create_publisher(TwistStamped, "control_cmd", 10)
            self.create_subscription(PoseArray, "objects", self.on_objects,
                                     10)
            self.create_subscription(PoseWithCovarianceStamped, "cam_pose",
                                     self.on_pose, 10)

        def on_objects(self, msg):
            objs = [(p.position.x, p.position.y) for p in msg.poses]
            brake = self.core.on_objects(objs)
            if brake != 0.0:
                cmd = TwistStamped()
                cmd.header = msg.header
                cmd.twist.linear.x = float(brake)
                self.pub.publish(cmd)

        def on_pose(self, msg):
            self.core.on_pose(float(msg.pose.pose.position.z),
                              stamp_seconds(msg.header))

    return Controller()


def main(args=None):
    spin_node(make_node, args)


if __name__ == "__main__":
    main()
