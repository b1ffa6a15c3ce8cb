"""The benchmark of the PyTorch/CUDA port (`gaussianrpg_tpu_torch`).

One run measures one cell of `BENCHMARK.json` and prints one JSON line:

    python3 port_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Everything that belongs to one cell, configuration or per-layer metric is
a file found by its name: `workloads/<cell>.json` (traffic parameters,
the driver that reads them, the limits of the correctness check),
`configs/<config>.json` (sizes and precision), `metrics/<metric>.py`
(a reader of the traced run), `rooflines/<kernel>.py` (operations and
bytes a kernel needs). `reference/` is the plain PyTorch version that
decides `correct`; it imports nothing of the port.
"""
