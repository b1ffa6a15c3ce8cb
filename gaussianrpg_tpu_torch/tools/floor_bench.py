"""Grid-step floor of the blend layout: counterpart of `tools/floor_bench.py`.

The JAX tool isolates the blend kernel's per-step floor on the TPU: a grid
of n_steps chunks of `block` rows of gdata [1,179,648, 16], a running
`acc` that valid chunks add their sum to, and at each last-of-tile chunk
`out[tile] = acc` (dynamic output index) or `out[0] = acc` (fixed), with
every chunk skipped or every chunk valid. `floor_bench` launches
`csrc/step_floor.cu` once a call: a single pass in which each block takes
a range of RANGE_ROWS / block steps and carries `acc` from the ranges
before it by a decoupled look-back, on a scratch kept across calls (no
memset a call; `scratch`); variants A-D4 are the tool's.

    python -m gaussianrpg_tpu_torch.tools.floor_bench [--device cpu] [--small]
"""
from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from ..ops import cuda_build
from ..utils.device import resolve_device
from ._timing import cycling, scaled, time_ms, timer_name

NF, NFO = 16, 5
BLOCKS = (128, 256, 512, 1024)
FULL = dict(capacity=1_179_648, n_tiles=850, n_pix=2048)
SMALL = dict(capacity=32 * 128, n_tiles=8, n_pix=128)
# name: (n_steps at full size, block, every chunk valid, dynamic out index)
VARIANTS = {
    "A 9216x128 skip-all dynout": (9216, 128, False, True),
    "A2 9216x128 valid-all dynout": (9216, 128, True, True),
    "B 9216x128 skip-all fixout": (9216, 128, False, False),
    "D1 4608x256 skip-all dynout": (4608, 256, False, True),
    "D2 2304x512 skip-all dynout": (2304, 512, False, True),
    "D3 1152x1024 skip-all dynout": (1152, 1024, False, True),
    "D4 2304x512 valid-all dynout": (2304, 512, True, True),
}

# gdata rows of one kernel block's range of steps (`csrc/step_floor.cu`'s
# kRangeRows): a block takes RANGE_ROWS // block steps
RANGE_ROWS = 4096

# a scratch's epochs run 1 .. EPOCHS - 1; then it is zeroed anew
EPOCHS = 2 ** 30

launches = 0               # kernel launches through `floor_bench`
_scratch: dict = {}        # (device, stream) -> (words, last epoch)


def meta_from_tiles(tiles, valid, device) -> torch.Tensor:
    """Packed chunk metadata for one tile id a step (each tile's steps one
    contiguous run): the tile, the last-of-tile bit where the next step's
    tile differs (and at the final step), and the valid bit where `valid`
    ([n_steps] bools, or one bool for all) is set."""
    tiles = np.asarray(tiles, np.int64)
    last = np.r_[tiles[1:] != tiles[:-1], True]
    valid = np.broadcast_to(np.asarray(valid, bool), tiles.shape)
    cm = tiles | (last.astype(np.int64) << 25) | (valid.astype(np.int64)
                                                  << 26)
    return torch.as_tensor(cm.astype(np.int32), device=device)


def chunk_meta(n_steps: int, valid, n_tiles: int, device) -> torch.Tensor:
    """The tool's metadata (`tools/floor_bench.py:68-76`): tiles spread
    evenly over the steps, the last-of-tile bit, and the valid bit where
    `valid` ([n_steps] bools, or one bool for all) is set."""
    return meta_from_tiles(np.arange(n_steps) * n_tiles // n_steps, valid,
                           device)


def scratch(n_steps: int, block: int, device) -> tuple[torch.Tensor, int]:
    """(words, epoch): the kernel's scratch for a call of n_steps chunks
    of `block` rows on the device's current stream (the ticket and one
    status word a range), and the call's epoch. The words are zeroed once
    and kept for the stream's later calls, each with the next epoch: a
    call leaves the ticket at 0, and the kernel reads words of an earlier
    epoch as not ready, so no call needs a memset. They are zeroed anew
    when a call needs more of them or the epochs run out."""
    fn = cuda_build.library("step_floor").grpg_step_floor_scratch_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    n = fn(n_steps, block)
    if n <= 0:
        raise ValueError(f"step_floor: no scratch size for {n_steps} steps "
                         f"of {block} rows")
    key = (torch.device(device),
           torch.cuda.current_stream(device).cuda_stream)
    words, epoch = _scratch.get(key, (None, EPOCHS))
    if words is None or words.numel() < n or epoch + 1 >= EPOCHS:
        words, epoch = torch.zeros(n, dtype=torch.uint8, device=device), 0
    _scratch[key] = (words, epoch + 1)
    return words, epoch + 1


def scratch_of(device):
    """(words, last epoch) of the scratch `scratch` keeps for the device's
    current stream, or None before its first call."""
    return _scratch.get((torch.device(device),
                         torch.cuda.current_stream(device).cuda_stream))


def _fields(cm):
    return (cm & 0xFFFFFF).long(), ((cm >> 25) & 1).bool(), \
        ((cm >> 26) & 1).bool()


def standing_writes(chunk_meta, *, dyn_out: bool, n_tiles: int):
    """(steps, dst): the steps whose write stands and the output block
    each writes. Each last-of-tile step writes out[tile] (dyn_out; tiles
    past n_tiles are not written), or the final one out[0]."""
    tile, last, _ = _fields(chunk_meta)
    sel = last & (tile < n_tiles) if dyn_out else last
    steps = torch.nonzero(sel)[:, 0]
    if not dyn_out:
        steps = steps[-1:]
    return steps, (tile[steps] if dyn_out else torch.zeros_like(steps))


def bytes_needed(chunk_meta, *, block: int, dyn_out: bool, n_tiles: int,
                 n_pix: int) -> int:
    """Bytes the function must move on this metadata, each once: the
    metadata, the chunks of valid steps and the output blocks written."""
    _, _, valid = _fields(chunk_meta)
    _, dst = standing_writes(chunk_meta, dyn_out=dyn_out, n_tiles=n_tiles)
    return 4 * (chunk_meta.shape[0] + int(valid.sum()) * block * NF
                + int(torch.unique(dst).numel()) * NFO * n_pix)


def floor_bench_plain(gdata, chunk_meta, *, block: int, dyn_out: bool,
                      n_tiles: int, n_pix: int):
    """Plain version: (out [n_tiles, 5, n_pix], written [n_tiles]). acc at
    step c is the sum of the valid chunks up to c, written by the steps of
    `standing_writes`."""
    n_steps = chunk_meta.shape[0]
    _, _, valid = _fields(chunk_meta)
    sums = gdata.reshape(n_steps, block * gdata.shape[1]).sum(dim=1)
    acc = torch.cumsum(torch.where(valid, sums, torch.zeros_like(sums)), 0)
    out = torch.zeros((n_tiles, NFO, n_pix), dtype=gdata.dtype,
                      device=gdata.device)
    written = torch.zeros(n_tiles, dtype=torch.bool, device=gdata.device)
    steps, dst = standing_writes(chunk_meta, dyn_out=dyn_out,
                                 n_tiles=n_tiles)
    out[dst] = acc[steps][:, None, None].expand(-1, NFO, n_pix)
    written[dst] = True
    return out, written


def written_error(got, ref, written) -> tuple[float, float]:
    """(max |got - ref|, that over max |ref|) on the written blocks (ref
    in float64); zeros when none is written, and the absolute error
    twice where the written blocks of ref are all zero."""
    if not bool(written.any()):
        return 0.0, 0.0
    d = float((got[written].double() - ref[written]).abs().max())
    scale = float(ref[written].abs().max())
    return d, d / scale if scale else d


def mixed_errors(call, device="cuda") -> dict:
    """{variant: `written_error`} of `call` (a function of the wrapper's
    arguments) against the float64 plain version, every variant at full
    size with a seeded mixed valid pattern and uniform gdata: the card
    check of `chip_smoke.py` and `floor_sweep`."""
    gen = torch.Generator(device=device).manual_seed(7)
    gdata = torch.rand((FULL["capacity"], NF), generator=gen, device=device)
    kw = dict(n_tiles=FULL["n_tiles"], n_pix=FULL["n_pix"])
    errs = {}
    for name in VARIANTS:
        n_steps, block, _, dyn = variant_shape(name, False)
        valid = np.random.default_rng(n_steps).random(n_steps) < 0.5
        cm = chunk_meta(n_steps, valid, FULL["n_tiles"], device)
        g = gdata[:n_steps * block]
        got = call(g, cm, block=block, dyn_out=dyn, **kw)
        errs[name] = written_error(got, *floor_bench_plain(
            g.double(), cm, block=block, dyn_out=dyn, **kw))
    return errs


def floor_bench(gdata, chunk_meta, *, block: int, dyn_out: bool,
                n_tiles: int, n_pix: int) -> torch.Tensor:
    """out [n_tiles, 5, n_pix] of the floor bench (blocks no step writes
    hold unspecified values; mask them with the plain version's
    `written`). gdata [n_steps * block, 16] float32, chunk_meta [n_steps]
    int32 whose tiles run in contiguous steps. CUDA tensors go through
    the kernel, CPU tensors through the plain version."""
    global launches
    n_steps = chunk_meta.shape[0]
    if block not in BLOCKS:
        raise ValueError(f"floor_bench: block {block} not in {BLOCKS}")
    if gdata.dtype != torch.float32 or tuple(gdata.shape) != (
            n_steps * block, NF):
        raise ValueError(f"floor_bench: gdata must be float32 "
                         f"[{n_steps * block}, {NF}]")
    if chunk_meta.dtype != torch.int32 or chunk_meta.dim() != 1 \
            or chunk_meta.device != gdata.device or n_steps == 0:
        raise ValueError("floor_bench: chunk_meta must be int32 [n_steps]")
    if n_pix * NFO % 4 or n_tiles <= 0:
        raise ValueError("floor_bench: 5 * n_pix must be a multiple of 4")
    if gdata.device.type == "cpu":
        return floor_bench_plain(gdata, chunk_meta, block=block,
                                 dyn_out=dyn_out, n_tiles=n_tiles,
                                 n_pix=n_pix)[0]
    if gdata.device.type != "cuda":
        raise ValueError(f"floor_bench: unsupported device {gdata.device}")
    gdata = gdata.contiguous()
    out = torch.empty((n_tiles, NFO, n_pix), dtype=torch.float32,
                      device=gdata.device)
    fn = cuda_build.library("step_floor").grpg_floor_bench
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_uint, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(gdata.device).cuda_stream
    with torch.cuda.device(gdata.device):
        words, epoch = scratch(n_steps, block, gdata.device)
        err = fn(gdata.data_ptr(), chunk_meta.data_ptr(), n_steps, block,
                 int(dyn_out), words.data_ptr(), epoch, out.data_ptr(),
                 NFO * n_pix, n_tiles, stream)
    cuda_build.check(err, "floor_bench launch")
    launches += 1
    return out


def variant_shape(name: str, small: bool):
    """(n_steps, block, valid_all, dyn_out) of a variant; the small size
    keeps the block and cuts the steps by 288."""
    n_steps, block, valid, dyn = VARIANTS[name]
    return (n_steps // 288 if small else n_steps), block, valid, dyn


def run(device=None, small: bool = False) -> dict:
    """Times every variant on the tool's inputs (gdata zeros)."""
    dev = resolve_device(device)
    small = small or dev.type == "cpu"
    size = SMALL if small else FULL
    gdata = torch.zeros((size["capacity"], NF), device=dev)
    res = dict(device=str(dev), timer=timer_name(dev), small=small, **size)
    for name in VARIANTS:
        n_steps, block, valid, dyn = variant_shape(name, small)
        cm = chunk_meta(n_steps, valid, size["n_tiles"], dev)
        g = gdata[:n_steps * block]
        fn = cycling(lambda x, c=cm, b=block, d=dyn: floor_bench(
            x, c, block=b, dyn_out=d, n_tiles=size["n_tiles"],
            n_pix=size["n_pix"]), [(x,) for x in scaled(g)])
        ms = time_ms(fn, dev, 20 if dev.type == "cuda" else 1)
        res[name] = dict(n_steps=n_steps, block=block, valid_all=valid,
                         dyn_out=dyn, ms=ms, us_per_step=ms / n_steps * 1e3)
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
        print(f"{name:32s} {r['ms']:9.4f} ms   "
              f"({r['us_per_step']:.4f} us/step)", flush=True)
    print({name: res[name]["ms"] for name in VARIANTS}, flush=True)
    return res


if __name__ == "__main__":
    main()
