"""Plain PyTorch references of what the benchmark's cells run: a tile
Gaussian rasterizer (`raster`) and YOLOv5 v6.0 (`yolo`). They import
neither JAX, nor `gaussianrpg_tpu`, nor anything of
`gaussianrpg_tpu_torch`, and take only the benchmark's own inputs."""
