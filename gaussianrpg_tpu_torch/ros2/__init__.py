"""The simulator's ROS2 node graph, one module a node.

Counterparts of the colcon nodes under `ros2/src/` (which import the JAX
package), each run as `python -m gaussianrpg_tpu_torch.ros2.<node>` in a
sourced ROS2 environment, no colcon build needed:

  simulator       MainFrame: 50 Hz dynamics, 10 Hz render; publishes
                  cam_pose and objects (inline perception) or front_image
                  (separate perception); consumes control_cmd
  groundtruth     cam_pose -> cam_2_cipv (true distance to the lead)
  evaluation      cam_pose, cam_2_cipv -> the verdict (the process exits)
  aeb_controller  objects, cam_pose -> control_cmd (brakes only)
  object_detector front_image -> objects (separate perception)

`simulator_launch.sh` and `simulator_launch_separate.sh` beside them start
the graph with the arguments of `ros2/scripts/simulator_launch*.sh`. Each
module imports without rclpy; its `main(args=None)` raises RuntimeError
when rclpy is missing, and reads its arguments from `sys.argv` as the
reference nodes do.
"""
