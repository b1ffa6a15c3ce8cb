"""Kernel A (the fused cummax, `ops/scan.py`) at the main path's sizes.

`measure` holds `scan.fused_cummax` bit for bit against its plain version
on the patterns the binning and the card tests give it, and times it
beside the plain version and `torch.cummax` on a binning-like marker
array; `chip_smoke.py` calls it at the frozen scene's, the closed loop's
and the trainer's capacities. On the card, `main` also times other builds
of the kernel's source beside the package's, on the same inputs, in one
process:

    python -m gaussianrpg_tpu_torch.tools.scan_bench [--p P ...] [--k K ...]
        [--against NAME=PATH ...] [--device cpu]

`--against NAME=PATH` compiles another tree's source, for example the
parent commit's `gaussianrpg_tpu_torch/csrc/cummax.cu` unpacked from a
`git archive`, or an edited copy (another tile size). Every build has
the C entry `grpg_fused_cummax(ins, outs, k, p, scratch, stream)`; a
build without `grpg_fused_cummax_scratch_bytes` (the
earlier three-pass kernel) gets its k * P / 4096 int32 block totals.
Each build is checked bit for bit against `torch.cummax` and then timed
in turns, forwards and back (a, b, ..., b, a), by `_timing.device_ms`.
"""
from __future__ import annotations

import argparse
import ctypes
import json

import torch

from ..ops import cuda_build, scan
from ..utils.device import resolve_device
from ._timing import PEAK_BYTES_PER_S, kernel_trace, time_ms, timer_name

INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1
TRAIN_CAPACITY = 32_309_248   # the synthetic trainer's pair capacity
FROZEN_CAPACITY = 4_194_304   # the frozen scene's at 16x16


def marks(p: int, n: int, gen, device) -> torch.Tensor:
    """A binning marker array: ids 1..n scattered (max) at n sorted random
    positions of P zeros, as `binning._scatter_max` writes them."""
    pos = torch.sort(torch.randint(0, p, (n,), generator=gen,
                                   device=device)).values
    m = torch.zeros(p, dtype=torch.int32, device=device)
    return m.scatter_reduce_(0, pos, torch.arange(
        1, n + 1, dtype=torch.int32, device=device), "amax")


def patterns(p: int, k: int, gen, device) -> dict:
    """k arrays of length P for each pattern: uniform random int32, marker
    arrays, all INT_MIN, strictly decreasing, the maximum first and the
    maximum last (the rest random below it)."""
    def rand():
        return torch.randint(INT_MIN, INT_MAX, (p,), dtype=torch.int32,
                             generator=gen, device=device)

    def with_max_at(i):
        x = torch.clamp(rand(), max=INT_MAX - 1)
        x[i] = INT_MAX
        return x

    dec = INT_MAX - torch.arange(p, dtype=torch.int64, device=device)
    return {
        "random": [rand() for _ in range(k)],
        "marks": [marks(p, max(p // 50, 1), gen, device) for _ in range(k)],
        "int_min": [torch.full((p,), INT_MIN, dtype=torch.int32,
                               device=device) for _ in range(k)],
        "decreasing": [(dec - j).to(torch.int32) for j in range(k)],
        "max_first": [with_max_at(0) for _ in range(k)],
        "max_last": [with_max_at(p - 1) for _ in range(k)],
    }


def max_abs_err(got, ref) -> int:
    return max(int((a.long() - b.long()).abs().max()) for a, b in
               zip(got, ref))


def measure(p: int, k: int, device=None, n_marks: int = 600_000,
            reps: int = 20) -> dict:
    """Kernel A at k arrays of length P: its largest error against the
    plain version over `patterns` (0: bit for bit), then device ms of the
    kernel (memset included), the plain version and `torch.cummax` on
    [k, P], all on k marker arrays of `n_marks` ids; the bound (8 k P
    bytes at the HBM rate) and, on the card, the kernels one call launches
    from a profiler trace."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {name: max_abs_err(scan.fused_cummax(xs),
                              scan.fused_cummax_plain(xs))
            for name, xs in patterns(p, k, gen, dev).items()}
    xs = [marks(p, n_marks, gen, dev) for _ in range(k)]
    stacked = torch.stack(xs)
    slow = max(1, reps // 4)   # the plain versions take ~2.7 ms a 1M
    rec = dict(p=p, k=k, device=str(dev), timer=timer_name(dev),
               max_abs_err=max(errs.values()), errors=errs,
               tolerance="exact",
               ms=time_ms(lambda: scan.fused_cummax(xs), dev, reps),
               plain_ms=time_ms(lambda: scan.fused_cummax_plain(xs), dev,
                                slow),
               library_ms=time_ms(lambda: torch.cummax(stacked, dim=1),
                                  dev, slow),
               bound_ms=8 * k * p / PEAK_BYTES_PER_S * 1e3,
               bound_by="bytes")
    if dev.type == "cuda":
        trace = kernel_trace(lambda: scan.fused_cummax(xs), reps=reps)
        rec.update(trace=trace, trace_ms=sum(t["ms_per_call"]
                                             for t in trace))
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    return rec


class Build:
    """One compiled cummax source, called through its C entry; `regs`
    holds ptxas's register and spill lines for it."""

    def __init__(self, name: str, lib: ctypes.CDLL, log: str = ""):
        self.name = name
        self.regs = [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln]
        if hasattr(lib, "grpg_fused_cummax_scratch_bytes"):
            self.fn, self.scratch_bytes = scan.bind(lib)
        else:
            # the earlier three-pass kernel (PR 4's): the same entry, with
            # k * P / 4096 int32 block totals for scratch
            self.fn = lib.grpg_fused_cummax
            self.fn.argtypes = scan.bind(
                cuda_build.library("cummax"))[0].argtypes
            self.fn.restype = ctypes.c_int
            self.scratch_bytes = lambda k, p: 4 * k * (p // 4096)

    def caller(self, xs):
        """A no-argument call of this build on xs (outputs and scratch
        allocated once)."""
        k, p = len(xs), xs[0].shape[0]
        outs = [torch.empty_like(x) for x in xs]
        scratch = torch.empty(self.scratch_bytes(k, p), dtype=torch.uint8,
                              device=xs[0].device)
        ins = (ctypes.c_void_p * k)(*[x.data_ptr() for x in xs])
        ptrs = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])

        def call():
            stream = torch.cuda.current_stream().cuda_stream
            cuda_build.check(self.fn(ins, ptrs, k, p, scratch.data_ptr(),
                                     stream), f"{self.name} launch")
            return outs

        return call


def builds(against) -> list[Build]:
    """The package's kernel (as `scan.fused_cummax` loads it), then one
    build per NAME=PATH in `against`, compiled in parallel."""
    return [Build(*b) for b in cuda_build.with_others("cummax", against,
                                                       "scan_bench")]


def compare(bs: list[Build], p: int, k: int, n_marks: int = 600_000,
            reps: int = 20) -> dict:
    """Each build checked bit for bit against torch.cummax on k marker
    arrays and k random arrays, then timed on the marker arrays in turns,
    forwards and back; returns both readings of each, and the time of a
    device copy of the same k arrays (`copy_`: what moving those bytes
    takes the card outside any scan)."""
    gen = torch.Generator(device="cuda").manual_seed(p + k)
    xs = [marks(p, n_marks, gen, "cuda") for _ in range(k)]
    rand = patterns(p, k, gen, "cuda")["random"]
    exact = {}
    for b in bs:
        exact[b.name] = all(
            max_abs_err(b.caller(arrays)(), scan.fused_cummax_plain(arrays))
            == 0 for arrays in (xs, rand))
    calls = {b.name: b.caller(xs) for b in bs}
    times = {b.name: [] for b in bs}
    for b in bs + bs[::-1]:
        times[b.name].append(time_ms(calls[b.name], torch.device("cuda"),
                                     reps))
    outs = [torch.empty_like(x) for x in xs]
    copy_ms = time_ms(lambda: [o.copy_(x) for o, x in zip(outs, xs)],
                      torch.device("cuda"), reps)
    return dict(p=p, k=k, exact=exact, ms=times, copy_ms=copy_ms,
                bound_ms=8 * k * p / PEAK_BYTES_PER_S * 1e3)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--p", type=int, nargs="+",
                    default=[TRAIN_CAPACITY, FROZEN_CAPACITY])
    ap.add_argument("--k", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--against", nargs="*", default=[],
                    help="NAME=PATH of another cummax.cu")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = []
    if dev.type == "cpu":
        # the plain version at a small size (patterns and checks only)
        for k in args.k:
            res.append(measure(65536 * 2, k, dev, n_marks=500, reps=1))
    else:
        bs = builds(args.against)
        for b in bs:
            print(json.dumps(dict(build=b.name, ptxas=b.regs)), flush=True)
        for p in args.p:
            for k in args.k:
                res.append(compare(bs, p, k))
    for r in res:
        print(json.dumps(r), flush=True)
    return res


if __name__ == "__main__":
    main()
