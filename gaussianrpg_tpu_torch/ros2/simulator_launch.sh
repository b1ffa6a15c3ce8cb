#!/bin/bash
# Closed-loop launch of the port's node graph, inline perception (the
# arguments of ros2/scripts/simulator_launch.sh):
#   $1 cams_tape.json   $2 track_info.txt  $3 start_frame  $4 cipv_id
#   $5 config yaml      $6 simulation_time $7 collision_threshold
#   $8 brake_distance
# Needs a sourced ROS2 environment (rclpy and the geometry_msgs, std_msgs
# and sensor_msgs packages); no colcon build: each node is
# `python3 -m gaussianrpg_tpu_torch.ros2.<node>` (set PYTHON to another
# interpreter). Every process is named python, so each is ended by the PID
# it got at spawn; the evaluation node's exit ends the run.
set -u
if [ $# -lt 8 ]; then
    echo "usage: $0 tape track_info start_frame cipv_id config" \
         "simulation_time collision_threshold brake_distance" >&2
    exit 2
fi
script_dir=$(dirname "$(readlink -f "$0")")
repo_dir=$(dirname "$(dirname "$script_dir")")
export PYTHONPATH="$repo_dir${PYTHONPATH:+:$PYTHONPATH}"
py=${PYTHON:-python3}
pids=()
stop() { kill -9 "${pids[@]}" 2>/dev/null; wait 2>/dev/null; }
trap 'stop; exit 130' INT TERM

rviz="$repo_dir/ros2/rviz2/gaussian_rpg.rviz"
if command -v rviz2 >/dev/null && [ -f "$rviz" ]; then
    rviz2 -d "$rviz" &
    pids+=($!)
fi
"$py" -m gaussianrpg_tpu_torch.ros2.aeb_controller "$8" &
pids+=($!)
"$py" -m gaussianrpg_tpu_torch.ros2.evaluation "$6" "$7" &
eval_pid=$!
pids+=($eval_pid)
"$py" -m gaussianrpg_tpu_torch.ros2.groundtruth "$1" "$2" "$3" "$4" &
pids+=($!)
"$py" -m gaussianrpg_tpu_torch.ros2.simulator --config "$5" \
    sim.traj_file_path "$1" &
pids+=($!)

wait "$eval_pid"
echo "Simulation process ends."
stop
