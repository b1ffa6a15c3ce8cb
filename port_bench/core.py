"""One run of one cell: argument parsing, the cell's files, the driver,
the per-layer readers, the correctness verdict and the result line."""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from . import compare

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "gaussianrpg_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(cell: str) -> tuple[dict, dict]:
    """(workload, configuration) of a cell, found by name."""
    wl = load_json(HERE / "workloads" / f"{cell}.json")
    cfg = load_json(HERE / "configs" / f"{wl['config']}.json")
    return wl, cfg


def cell_metrics(bench: dict, cell: str, section: str) -> list[dict]:
    """The metrics of `section` that this cell reports."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "port_bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def roofline(kernel: str):
    """The operation and byte counts of a kernel (`rooflines/<kernel>.py`)."""
    return load_module(HERE / "rooflines" / f"{kernel}.py")


def peaks(kind: str) -> dict | None:
    """The published peaks of the card named `kind`, or None."""
    for key, p in load_json(HERE / "peaks.json").items():
        if key in kind:
            return p
    return None


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def smi_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (`gaussianrpg_tpu_torch` is not `gaussianrpg_tpu`)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in BANNED)


def configure(device: str) -> None:
    """Process settings every run shares: FP32 without TF32, the port's
    kernel builds in a fixed directory of the checkout, few host
    threads."""
    import torch

    os.environ["GRPG_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)


def make_cell(cell: str, seed: int, device: str,
              overrides: dict | None = None):
    """(the cell's driver object, workload, configuration); `overrides`
    (tests) replace entries of the workload and configuration files."""
    wl, cfg = cell_files(cell)
    for key, val in (overrides or {}).items():
        (cfg if key in cfg else wl)[key] = val
    configure(device)
    driver = importlib.import_module(f"port_bench.drivers.{wl['driver']}")
    return driver.Cell(cfg, wl, seed, device), wl, cfg


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             age0: float = 0.0, overrides: dict | None = None) -> dict:
    """Run one cell and return the result line's object."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_json(ROOT / "BENCHMARK.json")
    run, wl, cfg = make_cell(cell, seed, device, overrides)
    run.setup()
    setup_s = age0 + time.perf_counter() - t_start
    e2e = run.window(seconds)
    e2e["setup_s"] = setup_s
    traced = run.traced() if trace else None
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    counts = run.counts(traced["stretch"]) if traced else None
    run.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers, attempted, failed = run.check()
    ok, checks = compare.judge(numbers, wl["limits"])

    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": ok, "attempted": attempted, "failed": failed,
           "metrics": {}, "device": dev}
    if trace:
        ctx = dict(trace=traced, counts=counts, e2e=e2e, cfg=cfg,
                   peaks=peaks(kind), roofline=roofline)
        for m in cell_metrics(bench, cell, "per_layer"):
            reader = load_module(HERE / "metrics" / f"{m['name']}.py")
            value = reader.read(ctx)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        s = traced["summary"]
        dev["busy_s"] = s["busy_us"] * 1e-6
        dev["window_s"] = traced["window_s"]
        out["breakdown"] = {"device_ops": s["device_ops"],
                            "idle_gaps": s["idle_gaps"]}
    else:
        for m in cell_metrics(bench, cell, "end_to_end"):
            out["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
    out["checks"] = checks
    return out


def main(argv, t_start: float, age0: float) -> int:
    p = argparse.ArgumentParser(description="Run one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    wl, _ = cell_files(a.workload)

    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < wl.get("chips", 1):
        print(f"port_bench: {a.workload} needs {wl.get('chips', 1)} CUDA "
              "card(s); none found", file=sys.stderr)
        return 2
    print(f"port_bench: {smi_line()}", file=sys.stderr)
    out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
                   t_start, age0)
    found = banned_modules()
    if found:
        print("port_bench: JAX modules loaded in the measuring process: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0
