"""The floor kernels (`csrc/step_floor.cu`) beside other builds of their
source, in one process on the card.

    python -m gaussianrpg_tpu_torch.tools.floor_sweep [--against NAME=PATH ...]
        [--reps N] [--out FILE]

Builds: the package's (as the wrappers load it), and with `--against
NAME=PATH` another tree's `step_floor.cu`, for example the parent commit's
unpacked from a `git archive` (a build without
`grpg_step_floor_scratch_bytes`, the earlier two-pass kernel, gets its
[n_steps] float32 step sums for scratch). Every build is checked on every
variant of both tools at full size, with a seeded mixed valid pattern,
against the float64 plain version (1e-5 of the written blocks' max), then
each variant is timed on the tools' own inputs by `_timing.device_ms`, the
builds in turns (a, b, ..., b, a). Also printed: each variant's byte bound
(`bytes_needed` at 3.35 TB/s), the card's launch floor
(`torch.cuda._sleep(0)` under the same timer), what one PyTorch call takes
to move the same bytes (`yardsticks`), the card's name and power limit,
and the kernels and memsets one call of each build launches
(`_timing.kernel_trace`). Needs the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from ..ops import cuda_build
from . import floor_bench as fb
from . import floor_bench2 as fb2
from ._timing import (PEAK_BYTES_PER_S, cycling, device_ms, kernel_trace,
                      launch_floor_ms, scaled, smi_line)

TOOLS_RTOL = 1e-5


class Build:
    """One compiled step_floor source, called through its two C entries
    with the wrappers' arguments; outputs and scratch allocated once a
    caller, the scratch zeroed once and each call given the next epoch,
    as the wrappers do (the two-pass kernel takes no epoch)."""

    def __init__(self, name: str, lib: ctypes.CDLL, log: str = ""):
        self.name = name
        self.regs = [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln]
        self.lib = lib
        self.two_pass = not hasattr(lib, "grpg_step_floor_scratch_bytes")
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        e = [] if self.two_pass else [u]
        lib.grpg_floor_bench.argtypes = [p, p, i, i, i, p, *e, p, i, i, p]
        lib.grpg_floor_bench2.argtypes = [p, p, i, p, p, i, i, i, p, *e, p,
                                          i, i, p]
        lib.grpg_floor_bench.restype = lib.grpg_floor_bench2.restype = i
        if not self.two_pass:
            lib.grpg_step_floor_scratch_bytes.argtypes = [i, i]
            lib.grpg_step_floor_scratch_bytes.restype = ctypes.c_longlong

    def _scratch(self, n_steps, block, device):
        """(words, next epoch: a function giving the call's epoch argument
        as a list, empty for the two-pass kernel)."""
        n = (4 * n_steps if self.two_pass
             else self.lib.grpg_step_floor_scratch_bytes(n_steps, block))
        count = [0]

        def epoch():
            count[0] += 1
            return [] if self.two_pass else [count[0]]

        return torch.zeros(n, dtype=torch.uint8, device=device), epoch

    def floor_bench(self, gdata, cm, *, block, dyn_out, n_tiles, n_pix):
        n_steps = cm.shape[0]
        words, epoch = self._scratch(n_steps, block, gdata.device)
        out = torch.empty((n_tiles, fb.NFO, n_pix), device=gdata.device)

        def call(g=gdata):
            err = self.lib.grpg_floor_bench(
                g.data_ptr(), cm.data_ptr(), n_steps, block, int(dyn_out),
                words.data_ptr(), *epoch(), out.data_ptr(), fb.NFO * n_pix,
                n_tiles, torch.cuda.current_stream().cuda_stream)
            cuda_build.check(err, f"{self.name} floor_bench")
            return out

        return call

    def floor_bench2(self, gdata, cm, ins, *, dyn_in, dyn_out, n_tiles,
                     n_pix):
        n_steps = cm.shape[0]
        words, epoch = self._scratch(n_steps, fb2.BLOCK, gdata.device)
        out = torch.empty((n_tiles if dyn_out else n_steps, fb.NFO, n_pix),
                          device=gdata.device)
        ptrs = [x.data_ptr() for x in ins] + [None] * (2 - len(ins))

        def call(g=gdata):
            err = self.lib.grpg_floor_bench2(
                g.data_ptr(), cm.data_ptr(), n_steps, ptrs[0], ptrs[1],
                len(ins), int(dyn_in), int(dyn_out), words.data_ptr(),
                *epoch(), out.data_ptr(), fb.NFO * n_pix, n_tiles,
                torch.cuda.current_stream().cuda_stream)
            cuda_build.check(err, f"{self.name} floor_bench2")
            return out

        return call


def builds(against=()) -> list[Build]:
    """The package's build, then the others, compiled in parallel."""
    return [Build(*b) for b in cuda_build.with_others("step_floor", against,
                                                       "floor_sweep")]


def check(b: Build) -> dict:
    """A build's errors relative to the written blocks' max on every
    variant of both tools (`mixed_errors`, the checks of `chip_smoke.py`
    phase `tools`)."""
    errs = {f"floor_bench {name}": rel for name, (_, rel) in fb.mixed_errors(
        lambda *args, **kw: b.floor_bench(*args, **kw)()).items()}
    errs.update({f"floor_bench2 {name}": rel for name, (_, rel) in
                 fb2.mixed_errors(
                     lambda *args, **kw: b.floor_bench2(*args, **kw)())
                 .items()})
    torch.cuda.synchronize()
    return errs


def tool_calls(b: Build) -> dict:
    """No-argument calls of a build on each variant's tool inputs (as the
    tools' `run()` times them), with each variant's bound."""
    calls = {}
    size = fb.FULL
    zeros = torch.zeros((size["capacity"], fb.NF), device="cuda")
    kw = dict(n_tiles=size["n_tiles"], n_pix=size["n_pix"])
    for name in fb.VARIANTS:
        n_steps, block, valid, dyn = fb.variant_shape(name, False)
        cm = fb.chunk_meta(n_steps, valid, size["n_tiles"], "cuda")
        g = zeros[:n_steps * block]
        fn = b.floor_bench(g, cm, block=block, dyn_out=dyn, **kw)
        calls[f"floor_bench {name}"] = (
            cycling(fn, [(x,) for x in scaled(g)]),
            fb.bytes_needed(cm, block=block, dyn_out=dyn, **kw))
    size2, cm, ones, planes = fb2.tool_inputs("cuda", False)
    planes_c = torch.ones((size2["n_steps"], fb.NFO, size2["n_pix"]),
                          device="cuda")
    for name, (n_in, dyn_in, dyn_out) in fb2.VARIANTS.items():
        ins = [planes if dyn_in else planes_c] * n_in
        kw2 = dict(dyn_in=dyn_in, dyn_out=dyn_out,
                   n_tiles=size2["n_tiles"], n_pix=size2["n_pix"])
        fn = b.floor_bench2(ones, cm, ins, **kw2)
        calls[f"floor_bench2 {name}"] = (
            cycling(fn, [(x,) for x in scaled(ones)]),
            fb2.bytes_needed(cm, n_in, **kw2))
    return calls


def yardsticks(reps: int = 20) -> dict:
    """Device ms of one PyTorch call moving the floor benches' bytes: a
    sum reading the tools' gdata (75.5 MB, what A2 reads), a fill writing
    the 850 output blocks (34.8 MB, what A writes), and a copy of that
    output. Rates the card reaches for those bytes outside any kernel of
    the port; not a `library_ms` (no one call computes a floor bench)."""
    size = fb.FULL
    g = torch.ones((size["capacity"], fb.NF), device="cuda")
    out = torch.empty((size["n_tiles"], fb.NFO, size["n_pix"]),
                      device="cuda")
    out2 = torch.empty_like(out)
    return dict(read_gdata_sum_ms=device_ms(lambda: g.sum(), reps),
                write_out_fill_ms=device_ms(lambda: out.fill_(1.0), reps),
                copy_out_ms=device_ms(lambda: out2.copy_(out), reps))


def compare(bs: list[Build], reps: int = 20) -> dict:
    """Each variant timed for every build, in turns a, b, ..., b, a, with
    its bound; the launch floor read before and after."""
    calls = {b.name: tool_calls(b) for b in bs}
    floor = [launch_floor_ms()]
    names = list(calls[bs[0].name])
    times = {b.name: {n: [] for n in names} for b in bs}
    for b in bs + bs[::-1]:
        for n in names:
            times[b.name][n].append(device_ms(calls[b.name][n][0], reps))
    floor.append(launch_floor_ms())
    bounds = {n: calls[bs[0].name][n][1] / PEAK_BYTES_PER_S * 1e3
              for n in names}
    return dict(ms=times, bound_ms=bounds, launch_floor_ms=floor)


def traces(b: Build) -> dict:
    """The kernels and memsets one call of each variant launches
    (profiler trace)."""
    return {n: [dict(name=k["name"][:80], cat=k["cat"],
                     launches=k["launches_per_call"], ms=k["ms_per_call"],
                     grid=k.get("grid"))
                for k in kernel_trace(fn, reps=3,
                                      cats=("kernel", "gpu_memset"))]
            for n, (fn, _) in tool_calls(b).items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", nargs="*", default=[],
                    help="NAME=PATH of another step_floor.cu")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="write the result as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("floor_sweep needs a CUDA card")
    res = dict(card=smi_line(), device=torch.cuda.get_device_name(0))
    bs = builds(args.against)
    res["ptxas"] = {b.name: b.regs for b in bs}
    print(json.dumps(dict(card=res["card"], ptxas=res["ptxas"])),
          flush=True)
    res["rel_err"] = {b.name: check(b) for b in bs}
    res["ok"] = all(e <= TOOLS_RTOL for errs in res["rel_err"].values()
                    for e in errs.values())
    print(json.dumps(dict(rel_err=res["rel_err"], ok=res["ok"])),
          flush=True)
    res.update(compare(bs, args.reps))
    res["yardsticks"] = yardsticks(args.reps)
    res["trace"] = {b.name: traces(b) for b in bs}
    for n in res["bound_ms"]:
        print(json.dumps(dict(variant=n, bound_ms=res["bound_ms"][n], **{
            b.name: res["ms"][b.name][n] for b in bs})), flush=True)
    print(json.dumps(dict(launch_floor_ms=res["launch_floor_ms"],
                          **res["yardsticks"])), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
