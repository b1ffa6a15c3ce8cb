"""ROS2 wrappers for the simulator nodes.

Counterpart of `gaussianrpg_tpu/apps/ros2_nodes.py`: re-exposes the
in-process loop (sim/nodes.py) over the reference's topic contract:

  cam_pose    PoseWithCovarianceStamped  (covariance[0] carries the tick idx)
  front_image Image                      (separate-perception mode)
  objects     PoseArray                  (position.x = range, .y = lateral)
  control_cmd TwistStamped               (linear.x = brake m/s^2)
  cam_2_cipv  Float64

Needs rclpy and the message packages of a sourced ROS2 environment; they
are imported only inside the functions that build a node, so every module
imports without them. The five nodes of the launch graph are the modules
of `gaussianrpg_tpu_torch/ros2/`; the headless in-process loop
(sim/loop.py) is the other way to run the same nodes.
"""
from __future__ import annotations

import numpy as np

RCLPY_MISSING = (
    "rclpy is not importable: source a ROS2 environment (its setup.bash) "
    "to run the node graph, or use gaussianrpg_tpu_torch.sim.loop."
    "run_closed_loop (in process) instead")


def require_rclpy() -> bool:
    """Whether rclpy can be imported."""
    try:
        import rclpy  # noqa: F401
        return True
    except ImportError:
        return False


def rclpy_module():
    """The rclpy module; a RuntimeError when it cannot be imported."""
    if not require_rclpy():
        raise RuntimeError(RCLPY_MISSING)
    import rclpy
    return rclpy


def pop_option(argv: list, flag: str):
    """Remove `flag VALUE` from `argv` and return VALUE (None if absent)."""
    if flag not in argv:
        return None
    i = argv.index(flag)
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


def spin_node(make_node, args=None):
    """A node process's body: `rclpy.init`, the node from `make_node()`,
    spin until a callback raises SystemExit (a verdict) or rclpy shuts
    down; the node is destroyed and rclpy shut down however the spin
    ends."""
    rclpy = rclpy_module()
    rclpy.init(args=args)
    try:
        node = make_node()
        try:
            rclpy.spin(node)
        except SystemExit:
            pass
        finally:
            node.destroy_node()
    finally:
        rclpy.shutdown()


def pose_array(boxes, ranger, header=None):
    """A PoseArray of the boxes' ground-plane ranges (position.x = range,
    .y = lateral); boxes the ranger cannot range ((0, 0): bottom above the
    horizon, or behind the camera) are left out, as the loop leaves them
    out."""
    from geometry_msgs.msg import Pose, PoseArray

    arr = PoseArray()
    if header is not None:
        arr.header = header
    for box in boxes:
        rng_, lat = ranger.distance(box)
        if rng_ > 0:
            pose = Pose()
            pose.position.x = float(rng_)
            pose.position.y = float(lat)
            arr.poses.append(pose)
    return arr


def run_simulator_node(tape, render_fn, detector, camera_template,
                       gt_tracklets, **loop_kwargs):
    """ROS2 graph entry: publishes cam_pose at the tape's dynamic rate
    (50 Hz), renders every `sync`-th tick (10 Hz), publishes objects and
    consumes control_cmd. Counterpart of the JAX package's
    `run_simulator_node`: the header stamps are left unset, as there;
    `gt_tracklets` and `loop_kwargs` are accepted and unused."""
    rclpy = rclpy_module()
    from geometry_msgs.msg import (PoseArray, PoseWithCovarianceStamped,
                                   TwistStamped)
    from rclpy.node import Node
    from scipy.spatial.transform import Rotation

    from ..sim.loop import ImageTicks
    from ..sim.nodes import CarDynamics, GroundPlaneRanger

    class SimulatorNode(Node):
        def __init__(self):
            super().__init__("gaussian_rpg")
            self.dyn = CarDynamics(tape=tape)
            self.images = ImageTicks(tape, camera_template)
            self.pub_pose = self.create_publisher(
                PoseWithCovarianceStamped, "cam_pose", 10)
            self.pub_obj = self.create_publisher(PoseArray, "objects", 10)
            self.sub_cmd = self.create_subscription(
                TwistStamped, "control_cmd", self.on_cmd, 10)
            # the template's tensors are on its device: numpy explicitly
            self.ranger = GroundPlaneRanger(
                K=camera_template.K.cpu().numpy(),
                extrinsic=np.linalg.inv(
                    camera_template.extrinsic.cpu().numpy()),
                width=camera_template.width,
                height=camera_template.height)
            self.timer = self.create_timer(self.dyn.dt, self.tick)

        def on_cmd(self, msg):
            self.dyn.on_control(msg.twist.linear.x)

        def tick(self):
            pose = self.dyn.tick()
            idx = self.dyn.idx - 1
            msg = PoseWithCovarianceStamped()
            msg.header.frame_id = "map"
            p = msg.pose.pose
            p.position.x, p.position.y, p.position.z = (
                float(v) for v in pose["position"])
            quat = Rotation.from_matrix(
                np.asarray(pose["rotation_matrix"])).as_quat()
            (p.orientation.x, p.orientation.y, p.orientation.z,
             p.orientation.w) = quat.tolist()
            msg.pose.covariance[0] = float(idx)
            self.pub_pose.publish(msg)

            cam = self.images.camera(idx, pose, self.dyn.timestamp)
            if cam is not None:
                img = np.asarray(render_fn(cam))
                self.pub_obj.publish(pose_array(
                    detector.detect(img, cam), self.ranger))

    rclpy.init()
    node = SimulatorNode()
    try:
        rclpy.spin(node)
    finally:
        node.destroy_node()
        rclpy.shutdown()
