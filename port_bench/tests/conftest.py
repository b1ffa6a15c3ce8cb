"""Shared set-up of the benchmark's tests: the checkout's root on the
path, and the cell shrunk to a size the CPU runs in seconds."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELL = "loop_frozen600k_yolo"


def tiny_overrides() -> dict:
    """The loop cell at 320x214 with 6,000 Gaussians, YOLOv5s at 64x96
    finding 12 objects where the ego stops, two 0.5 s episodes a cycle."""
    from port_bench import core

    _, cfg = core.cell_files(CELL)
    sc = copy.deepcopy(cfg["scene"])
    sc.update(gaussians=6000, width=320, height=214)
    sc["ground"]["count"], sc["facades"]["count"] = 3000, 2000
    return dict(scene=sc, yolo=dict(cfg["yolo"], input_hw=[64, 96],
                                    objects_at_stop=12),
                episode_s=0.5, lateral_offsets_m=[-0.5, 0.5],
                trace={"warmup_frames": 1, "frames": 2})


@pytest.fixture
def tiny():
    return tiny_overrides()


@pytest.fixture
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
