"""Dynamic against static block indices: counterpart of
`tools/floor_bench2.py`.

The JAX tool times, on the TPU, grids of 9216 steps of 128-row chunks with
every chunk skipped, whose output block (and 0-2 extra input blocks of
[5, 2048]) is indexed by the chunk's tile (dynamic, read from the chunk
metadata) or by the step (static): the layouts of the blend forward (A)
and backward (F) against step-major ones (B, E, G). A valid step adds the
sum of its chunk and of its input blocks to a running `acc` and writes it
to its output block. `floor_bench2` launches `csrc/step_floor.cu`, the
source it shares with `floor_bench`, once a call (no memset; the scratch
is `floor_bench.scratch`'s): a single pass over ranges of 32 steps that
carries `acc` by a decoupled look-back; where no step is valid, each
block reads its metadata and exits.

    python -m gaussianrpg_tpu_torch.tools.floor_bench2 [--device cpu] [--small]
"""
from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from ..ops import cuda_build
from ..utils.device import resolve_device
from ._timing import cycling, scaled, time_ms, timer_name
from .floor_bench import NF, NFO, chunk_meta, scratch, written_error

BLOCK = 128
FULL = dict(n_steps=9216, n_tiles=850, n_pix=2048)
SMALL = dict(n_steps=32, n_tiles=8, n_pix=128)
# name: (extra inputs, inputs indexed by tile, output indexed by tile)
VARIANTS = {
    "A dyn-out": (0, False, True),
    "B cmaj-out": (0, False, False),
    "E cmaj-out +1 dyn-in": (1, True, False),
    "F cmaj-out +2 dyn-in": (2, True, False),
    "G cmaj-out +2 cmaj-in": (2, False, False),
}

launches = 0               # kernel launches through `floor_bench2`


def standing_writes(chunk_meta, *, dyn_out: bool, n_tiles: int):
    """(steps, dst): the steps whose write stands and the output block
    each writes. Each valid step writes out[c], or out[tile] when the next
    valid step has another tile (or there is none) and the tile is below
    n_tiles (dyn_out)."""
    tile = (chunk_meta & 0xFFFFFF).long()
    valid = ((chunk_meta >> 26) & 1).bool()
    wsteps = torch.nonzero(valid)[:, 0]
    if dyn_out:
        t = tile[wsteps]
        keep = torch.cat([t[1:] != t[:-1], torch.ones_like(t[:1],
                                                           dtype=torch.bool)])
        wsteps = wsteps[keep & (t < n_tiles)]
    return wsteps, (tile[wsteps] if dyn_out else wsteps)


def bytes_needed(chunk_meta, n_in: int, *, dyn_in: bool, dyn_out: bool,
                 n_tiles: int, n_pix: int) -> int:
    """Bytes the function must move on this metadata, each once: the
    metadata, the chunks of valid steps, the input blocks they read and
    the output blocks written."""
    tile = (chunk_meta & 0xFFFFFF).long()
    valid = ((chunk_meta >> 26) & 1).bool()
    n_valid = int(valid.sum())
    n_blocks = (int(torch.unique(tile[valid & (tile < n_tiles)]).numel())
                if dyn_in else n_valid)
    _, dst = standing_writes(chunk_meta, dyn_out=dyn_out, n_tiles=n_tiles)
    return 4 * (chunk_meta.shape[0] + n_valid * BLOCK * NF
                + (n_in * n_blocks + int(torch.unique(dst).numel()))
                * NFO * n_pix)


def floor_bench2_plain(gdata, chunk_meta, ins, *, dyn_in: bool,
                       dyn_out: bool, n_tiles: int, n_pix: int):
    """Plain version: (out, written). Step c's sum is its chunk's plus its
    input blocks' (block tile, or c); acc at c is the sum over the valid
    steps up to c, written by the steps of `standing_writes` (tiles past
    n_tiles are neither read nor written). out has n_tiles blocks
    (dyn_out) or one a step."""
    n_steps = chunk_meta.shape[0]
    tile = (chunk_meta & 0xFFFFFF).long()
    valid = ((chunk_meta >> 26) & 1).bool()
    sums = gdata.reshape(n_steps, -1).sum(dim=1)
    steps = torch.arange(n_steps, device=gdata.device)
    idx = tile if dyn_in else steps
    ok = idx < n_tiles if dyn_in else torch.ones_like(valid)
    for x in ins:
        blocks = x.reshape(x.shape[0], -1).sum(dim=1)
        sums = sums + torch.where(ok, blocks[torch.where(ok, idx, 0)],
                                  torch.zeros_like(sums))
    acc = torch.cumsum(torch.where(valid, sums, torch.zeros_like(sums)), 0)
    n_out = n_tiles if dyn_out else n_steps
    out = torch.zeros((n_out, NFO, n_pix), dtype=gdata.dtype,
                      device=gdata.device)
    written = torch.zeros(n_out, dtype=torch.bool, device=gdata.device)
    wsteps, dst = standing_writes(chunk_meta, dyn_out=dyn_out,
                                  n_tiles=n_tiles)
    out[dst] = acc[wsteps][:, None, None].expand(-1, NFO, n_pix)
    written[dst] = True
    return out, written


def floor_bench2(gdata, chunk_meta, ins, *, dyn_in: bool, dyn_out: bool,
                 n_tiles: int, n_pix: int) -> torch.Tensor:
    """out ([n_tiles] if dyn_out else [n_steps], 5, n_pix) of the floor
    bench's second round (unwritten blocks hold unspecified values; mask
    them with the plain version's `written`). gdata [n_steps * 128, 16],
    chunk_meta [n_steps] int32 (tiles in contiguous steps), `ins` 0-2
    float32 arrays [n_tiles or n_steps, 5, n_pix]. CUDA tensors go through
    the kernel, CPU tensors through the plain version."""
    global launches
    n_steps = chunk_meta.shape[0]
    if gdata.dtype != torch.float32 or tuple(gdata.shape) != (
            n_steps * BLOCK, NF):
        raise ValueError(f"floor_bench2: gdata must be float32 "
                         f"[{n_steps * BLOCK}, {NF}]")
    if chunk_meta.dtype != torch.int32 or chunk_meta.dim() != 1 \
            or chunk_meta.device != gdata.device or n_steps == 0:
        raise ValueError("floor_bench2: chunk_meta must be int32 [n_steps]")
    if len(ins) > 2 or n_pix * NFO % 4 or n_tiles <= 0:
        raise ValueError("floor_bench2: 0-2 inputs, 5 * n_pix a multiple "
                         "of 4")
    n_in_blocks = n_tiles if dyn_in else n_steps
    for x in ins:
        if x.dtype != torch.float32 or x.device != gdata.device \
                or tuple(x.shape) != (n_in_blocks, NFO, n_pix):
            raise ValueError(f"floor_bench2: inputs must be float32 "
                             f"[{n_in_blocks}, {NFO}, {n_pix}]")
    if gdata.device.type == "cpu":
        return floor_bench2_plain(gdata, chunk_meta, ins, dyn_in=dyn_in,
                                  dyn_out=dyn_out, n_tiles=n_tiles,
                                  n_pix=n_pix)[0]
    if gdata.device.type != "cuda":
        raise ValueError(f"floor_bench2: unsupported device {gdata.device}")
    gdata = gdata.contiguous()
    ins = [x.contiguous() for x in ins]
    ptrs = [x.data_ptr() for x in ins] + [None] * (2 - len(ins))
    out = torch.empty((n_tiles if dyn_out else n_steps, NFO, n_pix),
                      dtype=torch.float32, device=gdata.device)
    fn = cuda_build.library("step_floor").grpg_floor_bench2
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_uint, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(gdata.device).cuda_stream
    with torch.cuda.device(gdata.device):
        words, epoch = scratch(n_steps, BLOCK, gdata.device)
        err = fn(gdata.data_ptr(), chunk_meta.data_ptr(), n_steps, ptrs[0],
                 ptrs[1], len(ins), int(dyn_in), int(dyn_out),
                 words.data_ptr(), epoch, out.data_ptr(), NFO * n_pix,
                 n_tiles, stream)
    cuda_build.check(err, "floor_bench2 launch")
    launches += 1
    return out


def mixed_errors(call, device="cuda") -> dict:
    """{variant: `written_error`} of `call` (a function of the wrapper's
    arguments) against the float64 plain version, every variant at full
    size with a seeded mixed valid pattern, uniform gdata and distinct
    uniform input arrays (G reads two step-major [9216, 5, 2048] arrays):
    the card check of `chip_smoke.py` and `floor_sweep`."""
    n_steps, n_tiles, n_pix = FULL["n_steps"], FULL["n_tiles"], FULL["n_pix"]
    gen = torch.Generator(device=device).manual_seed(8)
    valid = np.random.default_rng(9).random(n_steps) < 0.5
    cm = chunk_meta(n_steps, valid, n_tiles, device)
    gdata = torch.rand((n_steps * BLOCK, NF), generator=gen, device=device)
    errs = {}
    for name, (n_in, dyn_in, dyn_out) in VARIANTS.items():
        n_blocks = n_tiles if dyn_in else n_steps
        ins = [torch.rand((n_blocks, NFO, n_pix), generator=gen,
                          device=device) for _ in range(n_in)]
        kw = dict(dyn_in=dyn_in, dyn_out=dyn_out, n_tiles=n_tiles,
                  n_pix=n_pix)
        got = call(gdata, cm, ins, **kw)
        errs[name] = written_error(got, *floor_bench2_plain(
            gdata.double(), cm, [x.double() for x in ins], **kw))
        del ins, got
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return errs


def tool_inputs(device: torch.device, small: bool):
    """The tool's inputs (`tools/floor_bench2.py:31-37`): skip-all chunk
    metadata, gdata and the input planes all ones; the step-major planes
    ([n_steps, 5, n_pix], 377 MB at full size) only where a variant reads
    them."""
    size = SMALL if small else FULL
    cm = chunk_meta(size["n_steps"], False, size["n_tiles"], device)
    gdata = torch.ones((size["n_steps"] * BLOCK, NF), device=device)
    planes = torch.ones((size["n_tiles"], NFO, size["n_pix"]), device=device)
    return size, cm, gdata, planes


def run(device=None, small: bool = False) -> dict:
    """Times every variant on the tool's skip-all inputs."""
    dev = resolve_device(device)
    small = small or dev.type == "cpu"
    size, cm, gdata, planes = tool_inputs(dev, small)
    res = dict(device=str(dev), timer=timer_name(dev), small=small, **size)
    planes_c = None
    for name, (n_in, dyn_in, dyn_out) in VARIANTS.items():
        if n_in and not dyn_in and planes_c is None:
            planes_c = torch.ones((size["n_steps"], NFO, size["n_pix"]),
                                  device=dev)
        ins = [planes if dyn_in else planes_c] * n_in
        ms = time_ms(cycling(lambda x, i=ins, a=dyn_in, b=dyn_out:
                             floor_bench2(x, cm, i, dyn_in=a, dyn_out=b,
                                          n_tiles=size["n_tiles"],
                                          n_pix=size["n_pix"]),
                             [(x,) for x in scaled(gdata)]), dev,
                     20 if dev.type == "cuda" else 1)
        res[name] = dict(n_in=n_in, dyn_in=dyn_in, dyn_out=dyn_out, ms=ms,
                         us_per_step=ms / size["n_steps"] * 1e3)
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    res = run(args.device, args.small)
    print(f"device {res['device']}, {res['timer']}", flush=True)
    for name in VARIANTS:
        r = res[name]
        print(f"{name:24s} {r['ms']:9.4f} ms  "
              f"({r['us_per_step']:.4f} us/step)", flush=True)
    return res


if __name__ == "__main__":
    main()
