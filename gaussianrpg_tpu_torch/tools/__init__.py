"""The port's microbenchmarks, counterparts of the repo's `tools/` Pallas
microbenchmarks, one module per tool and each with its own hand-written
kernel in `csrc/`:

  gather_fold   row gather through a per-row staged chunk (gather_rows.cu)
  blend_floor   kernels B and C on real, all-execute and floor inputs, and
                three stripped forms of kernel B (blend_floor.cu)
  floor_bench   grid-step floor of the blend layout (step_floor.cu)
  floor_bench2  dynamic against static block indices (step_floor.cu)
  mm_orient     the backward's moment contraction, two orientations
                (mm_orient.cu)

and, with no counterpart there, `scan_bench` (kernel A at the main path's
capacities, beside other builds of `cummax.cu`) and `bwd_ablate`.

Each module has the CUDA wrapper of its kernel (launch counter `launches`;
`gather_fold` re-exports the rasterizer's, whose counter is
`ops.gather.launches`), the plain PyTorch version of the same function,
`run(device=None, small=False) -> dict` and `main()`:

    python -m gaussianrpg_tpu_torch.tools.<name> [--device cpu] [--small]

runs on the card by default (CUDA-event times, full size); `--device cpu`
runs the plain versions at the small size, timed by the host clock.
"""
