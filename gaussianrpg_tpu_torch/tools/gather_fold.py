"""Row gather through a staged chunk: counterpart of `tools/gather_fold.py`.

The JAX tool asks whether the blend kernel could gather its own pair rows
(one DMA per row into a chunk scratch) instead of reading a materialized
`gdata [P, 16]`, and times that gather against XLA's take. The same
question on the card: `gather_rows` launches `csrc/gather_rows.cu` (one
block per 128-row chunk, rows staged in shared memory by `cp.async`, the
front end a blend kernel that gathers its own rows would have), timed
against `torch.index_select`, which the port's eval pair gather ran until
it moved to this kernel (`ops/rasterize._take8`; training still runs it).
The kernel's wrapper and its launch counter live in `ops/gather.py`, whose
`gather_rows` and `gather_rows_plain` this module re-exports. Besides the
tool's random rows it gathers the 16x16 frozen frame's real `pair_src`
from the depth-sorted field table.

    python -m gaussianrpg_tpu_torch.tools.gather_fold [--device cpu] [--small]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.gather import gather_rows, gather_rows_plain  # noqa: F401
from ..utils.device import resolve_device
from . import _scene
from ._timing import cycling, kernel_trace, scaled, time_ms, timer_name

NF = 16
FULL = dict(n_rows=600_000, rows=1_179_648)
SMALL = dict(n_rows=6000, rows=16384)


def tool_inputs(device: torch.device, small: bool):
    """The tool's inputs (`tools/gather_fold.py:27-33`): normal fields
    [N, 16] and uniform row ids [P], seed 0."""
    size = SMALL if small else FULL
    rng = np.random.default_rng(0)
    fields = torch.as_tensor(rng.normal(0, 1, (size["n_rows"], NF)).astype(
        np.float32), device=device)
    src = torch.as_tensor(rng.integers(0, size["n_rows"], size["rows"])
                          .astype(np.int32), device=device)
    return fields, src


def frame_inputs(device: torch.device, small: bool):
    """The 16x16 frozen frame's depth-sorted field table and pair_src
    (padding slots -1), as `tools/blend_floor.py:45-60` builds them."""
    inp = _scene.sorted_pair_inputs(_scene.scene(device, small), 16, 16)
    return inp.fields_s, inp.lists.pair_src.contiguous()


def _time_both(fields, src, device, reps):
    """Kernel and index_select times on the same rows; index_select gets
    its int64 index (padding clamped to row 0) outside the timed region.
    On the card also the kernels each launches (`kernel_trace`), with the
    bytes each call must move over its device time."""
    variants = [(f, src) for f in scaled(fields)]
    src64 = torch.clamp(src, min=0).long()
    lib_variants = [(f, src64) for f, _ in variants]
    ms = time_ms(cycling(gather_rows, variants), device, reps)
    lib_ms = time_ms(cycling(_index_select, lib_variants), device, reps)
    distinct = int(torch.unique(src[src >= 0]).numel())
    rows, nf = src.shape[0], fields.shape[1]
    out = dict(n_rows=fields.shape[0], rows=rows, nf=nf,
               distinct_rows=distinct, ms=ms, library_ms=lib_ms)
    if device.type == "cuda":
        # each row read and written once, and the row ids (int32 / int64)
        for key, fn, args, id_bytes in (
                ("trace", gather_rows, variants[0], 4),
                ("library_trace", _index_select, lib_variants[0], 8)):
            kernels = kernel_trace(lambda: fn(*args))
            nbytes = rows * (2 * nf * 4 + id_bytes)
            for k in kernels:
                k["gb_per_s"] = nbytes / (k["ms_per_call"] * 1e6)
            out[key] = kernels
    return out


def _index_select(fields, src64):
    return fields.index_select(0, src64)


def run(device=None, small: bool = False) -> dict:
    """Times the gather kernel and `index_select` on the tool's random
    rows and on the 16x16 frame's pair rows."""
    dev = resolve_device(device)
    small = small or dev.type == "cpu"
    reps = 20 if dev.type == "cuda" else 2
    out = dict(device=str(dev), timer=timer_name(dev), small=small)
    out["random"] = _time_both(*tool_inputs(dev, small), dev, reps)
    out["frame_16x16"] = _time_both(*frame_inputs(dev, small), dev, reps)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    res = run(args.device, args.small)
    print(f"device {res['device']}, {res['timer']}", flush=True)
    for key in ("random", "frame_16x16"):
        r = res[key]
        for name, ms in (("index_select", r["library_ms"]),
                         ("gather_rows", r["ms"])):
            print(f"{key} {name}: {ms:.4f} ms for {r['rows']} rows "
                  f"({ms * 1e6 / r['rows']:.3f} ns/row)", flush=True)
        for trace in ("library_trace", "trace"):
            for k in r.get(trace, []):
                print(f"{key}   kernel {k['name'][:60]}: "
                      f"{k['ms_per_call']:.4f} ms/call, "
                      f"{k['gb_per_s']:.0f} GB/s, grid {k['grid']}, block "
                      f"{k['block']}, occupancy "
                      f"{k['est. achieved occupancy %']}%", flush=True)
    return res


if __name__ == "__main__":
    main()
