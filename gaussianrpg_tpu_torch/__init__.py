"""gaussianrpg_tpu_torch — the closed-loop driving simulator of
`gaussianrpg_tpu` ported to PyTorch, with hand-written CUDA kernels for one
NVIDIA H100 (sm_90a).

The JAX package `gaussianrpg_tpu` is the reference this port is held
against; the port imports nothing from it (nor `jax`). Layout mirrors it so
each counterpart is easy to find:

  ops/       projection, SH, binning, and the kernel wrappers
             (ops/scan.py, ops/blend.py; CUDA sources in csrc/)
  models/    Gaussian parameter containers + composite scene graph
  render/    cameras + composite renderer
  sim/       closed-loop simulator: tape, dynamics, AEB, detectors,
             YOLOv5 (sim/yolo.py) and the fused render -> letterbox ->
             YOLOv5 -> top-K step (sim/pipeline.py)
  train/     losses and the train step
  parallel/  multi-device rendering and training over torch.distributed
             (tile strips, primitive shards, summed gradients)
  utils/     device selection, synthetic scenes
  apps/      CLI entry points (simulate, train, render, scaling_bench, ...)

Entry points run on CUDA unless the caller passes `device="cpu"`; on the
CPU every kernel wrapper uses its plain PyTorch version.
"""

__version__ = "0.1.0"
