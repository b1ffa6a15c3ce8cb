"""The closed loop's imaging schedule (`sim/loop.ImageTicks`), which
`run_closed_loop` and both ROS2 simulator nodes share: a camera on every
`dynamic_freq / image_freq`-th tick, showing image frame
`frame0 + idx // sync` at the tick's pose and time, and None between."""
import numpy as np
import torch

from gaussianrpg_tpu_torch.render.camera import make_camera
from gaussianrpg_tpu_torch.sim.loop import ImageTicks


def test_a_camera_on_image_ticks_and_none_between():
    K = np.array([[100.0, 0, 64], [0, 100.0, 40], [0, 0, 1]])
    template = make_camera(R=np.eye(3), T=np.zeros(3), K=K, width=128,
                           height=80, frame=7, image_id=3, cam_id=1,
                           device="cpu")
    images = ImageTicks({"dynamic_freq": 40, "image_freq": 10}, template)
    assert (images.sync, images.frame0) == (4, 7)
    shown = []
    for idx in range(13):
        ego = np.eye(4, dtype=np.float32)
        ego[2, 3] = 0.1 * idx
        pose = {"rotation_matrix": np.eye(3),
                "position": [0.0, 0.0, -0.1 * idx], "ego_pose": ego}
        cam = images.camera(idx, pose, 0.025 * idx)
        if idx % 4:
            assert cam is None, idx
            continue
        shown.append(idx)
        assert int(cam.frame) == 7 + idx // 4
        assert float(cam.timestamp) == np.float32(0.025 * idx)
        assert torch.equal(cam.ego_pose, torch.as_tensor(ego))
        assert torch.equal(cam.K, template.K)
        assert (cam.width, cam.height, cam.cam_id, int(cam.image_id)) == (
            128, 80, 1, 3)
    assert shown == [0, 4, 8, 12]
