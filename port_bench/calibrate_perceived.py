"""The readings the limits of the cells where YOLOv5s perceives a frame
the reference renders are held to, on the card:

    python3 port_bench/calibrate_perceived.py --workload <cell> \\
        --seeds 1 2 3 ... [--seconds 0.1] [--episode-s 2] \\
        [--out calibrate_perceived.jsonl]

for `loop_street600k_yolo` and `loop_frozen600k_separate`. For each
seed, in one process, as `calibrate_street.py` does: the cell's set-up
and one short window of whole episodes, then the compared numbers of the
program against the plain reference (the lower readings) and of each
control against the same reference (the upper readings): the
reference's YOLOv5s in bfloat16 (weights and activations) and with TF32
on, both on the reference's own images, and for the street cell the
reference's scene at SH degree 1 in place of 3. One JSON line a seed.
The benchmark's own runs never run this.
"""
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from port_bench import core  # noqa: E402
from port_bench.reference.street import Form  # noqa: E402

CONTROLS = {"bfloat16_yolo": dict(dtype=torch.bfloat16),
            "tf32_yolo": dict(tf32=True)}
STREET_CONTROLS = {"sh1": dict(form=Form(sh_degree=1))}


def readings(cell, seed, seconds, device="cuda", overrides=None) -> dict:
    """Program and control numbers of one seed."""
    run, _, _ = core.make_cell(cell, seed, device, overrides)
    t0 = time.perf_counter()
    run.setup()
    t1 = time.perf_counter()
    e2e = run.window(seconds)
    run.release()
    t2 = time.perf_counter()
    program, _, _ = run.check()
    t3 = time.perf_counter()
    ref = run.reference_outputs()
    controls = dict(CONTROLS)
    if "street" in cell:
        controls.update(STREET_CONTROLS)
    nums = {name: run.numbers(run.reference_outputs(**kw), ref)
            for name, kw in controls.items()}
    return dict(seed=seed, program=program, controls=nums,
                frame_ms=e2e["loop_frame_ms"], setup_s=t1 - t0,
                window_s=t2 - t1, check_s=t3 - t2)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.1)
    p.add_argument("--episode-s", type=float, default=None,
                   help="shorter episodes than the workload's")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_perceived: no CUDA card", file=sys.stderr)
        return 2
    print(core.smi_line(), flush=True)
    for seed in a.seeds:
        rec = readings(a.workload, seed, a.seconds,
                       overrides=None if a.episode_s is None
                       else {"episode_s": a.episode_s})
        line = json.dumps(rec)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
