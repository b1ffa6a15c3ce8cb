"""Multi-device rendering and training over `torch.distributed`: one
process per rank (NCCL between cards, gloo for CPU runs), tile strips over
a `data` axis and primitive shards over a `model` axis."""
