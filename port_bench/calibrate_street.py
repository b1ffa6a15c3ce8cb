"""The readings the street cell's correctness limits are set from, on the
card:

    python3 port_bench/calibrate_street.py --seeds 1 2 3 ... \\
        [--seconds 0.1] [--episode-s 2] \\
        [--out chiprun_out/calibrate_street.jsonl]

For each seed, in one process: the cell's set-up and one short window of
whole episodes, as a run makes them, then the compared numbers of the
program against the plain reference (the lower readings) and of four
controls against the same reference (the upper readings): the
reference's splat fields and actor poses rounded to bfloat16 (the
precision step below the configuration's float32), the reference with
SH degree 1 in place of 3, with the actors' Fourier time held at 0, and
without the sky. One JSON line a seed. The benchmark's own runs never
run this.
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

CELL = "loop_street600k_aeb"
CONTROLS = {"bfloat16": Form(field_dtype=torch.bfloat16),
            "sh1": Form(sh_degree=1),
            "fourier_t0": Form(freeze_fourier=True),
            "no_sky": Form(sky=False)}


def readings(seed, seconds, device="cuda", overrides=None) -> dict:
    """Program and control numbers of one seed."""
    run, _, _ = core.make_cell(CELL, seed, device, overrides)
    t0 = time.perf_counter()
    run.setup()
    t1 = time.perf_counter()
    e2e = run.window(seconds)
    run.release()
    t2 = time.perf_counter()
    program, _, _ = run.check()
    t3 = time.perf_counter()
    ref = run.reference_outputs()
    controls = {name: run.numbers(run.reference_outputs(form), ref)
                for name, form in CONTROLS.items()}
    return dict(seed=seed, program=program, controls=controls,
                frame_ms=e2e["loop_frame_ms"], setup_s=t1 - t0,
                window_s=t2 - t1, check_s=t3 - t2)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.1)
    p.add_argument("--episode-s", type=float, default=None,
                   help="shorter episodes than the workload's")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_street: no CUDA card", file=sys.stderr)
        return 2
    print(core.smi_line(), flush=True)
    for seed in a.seeds:
        rec = readings(seed, a.seconds, overrides=None if a.episode_s is None
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
