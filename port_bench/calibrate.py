"""The readings the correctness limits are set from, on the card:

    python3 port_bench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--out chiprun_out/calibrate.jsonl]

For each seed, in one process: the cell's set-up and one short window of
whole episodes, as a run makes them, then the compared numbers of the
program against the plain reference (the lower readings) and of two
controls against the same reference (the upper readings). The control is
the reference put in the program's place one precision step down: TF32
for its matmuls and convolutions, and each splat's 2D fields rounded to
bfloat16 before the blend. The perception control is the reference's
YOLOv5 alone with TF32 on, on the reference's exact FP32 images: what a
program that let only its convolutions round would read. One JSON line a
seed. The benchmark's own runs never run this.
"""
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from port_bench import core  # noqa: E402


@contextlib.contextmanager
def tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def control_outputs(run):
    """The reference's outputs in the control's precision."""
    with tf32():
        return run.reference_outputs(field_dtype=torch.bfloat16)


def perception_control(run, ref: dict) -> dict:
    """The candidates' numbers of the reference's YOLOv5 in TF32 on the
    reference's own FP32 images (`ref`)."""
    with tf32():
        out = run.reference_perception(ref["images"])
    nums = run.numbers(dict(images=ref["images"], cands=out["cands"]), ref)
    return {k: nums[k] for k in ("cand_conf_gap", "cand_box_gap")}


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
    control = run.numbers(control_outputs(run), ref)
    return dict(seed=seed, program=program, control=control,
                perception_control=perception_control(run, ref),
                frame_ms=e2e["loop_frame_ms"], setup_s=t1 - t0,
                window_s=t2 - t1, check_s=t3 - t2)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.1)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    print(core.smi_line(), flush=True)
    for seed in a.seeds:
        rec = readings(a.workload, seed, a.seconds)
        line = json.dumps(rec)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
