"""Where the blend kernels' time goes: counterpart of `tools/blend_floor.py`.

The JAX tool splits the real blend forward and backward on the frozen bench
scene (64x32 tiles, capacity 1,179,648) into three inputs: the real pairs,
"all-exec" (zero pair rows: no pair contributes and no pixel stops, so
every chunk runs) and "floor" (every chunk's valid bit cleared), and times
three stripped forward kernels at the floor input. Here the three inputs
go through the port's kernels B and C (`ops/blend.py`), and
`stripped_forward` launches `csrc/blend_floor.cu`, which keeps kernel B's
structure (one block per tile over its chunk range) with the blend taken
out: `empty` (the output write), `stage` (stage and sum each chunk; the
last chunk's sum is written, as the tool's `k_meta`, and the sum over all
staged chunks goes to a per-tile `staged` entry, so that a check sees
every chunk staged), `stage_done` (the same behind kernel B's
all-pixels-done barrier, as `k_ndone`). They run at
the floor input as in the tool and at the real input, where `stage` against
kernel B says how much of B is reading its pairs. Also at 16x16 tiles (the
closed loop's tiling, capacity from `suggest_binning_sizes`).

The stripped forms stage chunks as kernel B does: two shared-memory
buffers, the bulk copy of chunk c+1 (cp.async.bulk on an mbarrier) in
flight while chunk c is consumed, so `stage` minus `empty` is the cost of
kernel B's present staging on the same inputs. One block walks a tile's
chunks in order, so the tile with the most chunks sets the kernel's tail:
`run()` records that count (`max_tile_chunks`) beside the times.

    python -m gaussianrpg_tpu_torch.tools.blend_floor [--device cpu] [--small]
"""
from __future__ import annotations

import argparse
import ctypes

import torch

from ..ops import blend, cuda_build
from ..ops.binning import G_CHUNK
from ..utils.device import resolve_device
from . import _scene
from ._timing import cuda_ms, cycling, scaled, time_ms, timer_name

VARIANTS = ("empty", "stage", "stage_done")
C_FEAT = 5                 # output planes (S = 0)
TOOL_CAPACITY = 1_179_648  # the tool's pair capacity at 64x32
VALID_BIT = 1 << 26

launches = 0               # kernel launches through `stripped_forward`


def stripped_forward_plain(variant: str, gdata, chunk_meta, *, n_tiles: int,
                           n_pix: int):
    """Plain version: (planes [n_tiles, 5, n_pix], staged [n_tiles],
    written [n_tiles]). A tile is written when it has a chunk range;
    `empty` writes zeros, `stage` and `stage_done` the sum of the tile's
    last chunk to its planes and the sum over its range's chunks to
    `staged`."""
    if variant not in VARIANTS:
        raise ValueError(f"stripped_forward: unknown variant {variant!r}")
    start, end = blend.tile_chunk_ranges(chunk_meta, n_tiles)
    written = (start >= 0) & (end > start)
    out = torch.zeros((n_tiles, C_FEAT, n_pix), dtype=gdata.dtype,
                      device=gdata.device)
    staged = torch.zeros(n_tiles, dtype=gdata.dtype, device=gdata.device)
    if variant != "empty":
        sums = gdata.reshape(-1, G_CHUNK * gdata.shape[1]).sum(dim=1)
        last = sums[torch.clamp(end - 1, min=0).long()]
        out[:] = torch.where(written, last, torch.zeros_like(last))[
            :, None, None]
        # the range's sum as a difference of float64 prefix sums
        prefix = torch.cat([sums.new_zeros(1, dtype=torch.float64),
                            sums.double().cumsum(0)])
        lo, hi = torch.clamp(start, min=0).long(), torch.clamp(
            end, min=0).long()
        staged = torch.where(written, prefix[hi] - prefix[lo],
                             torch.zeros_like(prefix[lo])).to(gdata.dtype)
    return out, staged, written


def stripped_forward(variant: str, gdata, chunk_meta, *, n_tiles: int,
                     n_pix: int):
    """(planes [n_tiles, 5, n_pix], staged [n_tiles]) of one stripped form
    of kernel B; the entries of tiles without a chunk range hold
    unspecified values (mask them with the plain version's `written`).
    CUDA tensors go through the kernel, CPU tensors through the plain
    version."""
    global launches
    if variant not in VARIANTS:
        raise ValueError(f"stripped_forward: unknown variant {variant!r}")
    if gdata.dim() != 2 or gdata.dtype != torch.float32 \
            or gdata.shape[0] % G_CHUNK or gdata.shape[1] % 4:
        raise ValueError("stripped_forward: gdata must be float32 [P, NF] "
                         f"with P a multiple of {G_CHUNK}, NF of 4")
    if (chunk_meta.dtype != torch.int32
            or tuple(chunk_meta.shape) != (gdata.shape[0] // G_CHUNK,)
            or chunk_meta.device != gdata.device):
        raise ValueError("stripped_forward: chunk_meta must be int32 "
                         "[P / 128] on gdata's device")
    if gdata.device.type == "cpu":
        return stripped_forward_plain(variant, gdata, chunk_meta,
                                      n_tiles=n_tiles, n_pix=n_pix)[:2]
    if gdata.device.type != "cuda":
        raise ValueError(f"stripped_forward: unsupported device "
                         f"{gdata.device}")
    gdata = gdata.contiguous()
    start, end = blend.tile_chunk_ranges(chunk_meta, n_tiles)
    out = torch.empty((n_tiles, C_FEAT, n_pix), dtype=torch.float32,
                      device=gdata.device)
    staged = torch.empty(n_tiles, dtype=torch.float32, device=gdata.device)
    fn = cuda_build.library("blend_floor").grpg_blend_floor
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(gdata.device).cuda_stream
    with torch.cuda.device(gdata.device):
        err = fn(VARIANTS.index(variant), gdata.data_ptr(), gdata.shape[1],
                 start.data_ptr(), end.data_ptr(), out.data_ptr(),
                 staged.data_ptr(), n_tiles, n_pix, stream)
    cuda_build.check(err, "stripped_forward launch")
    launches += 1
    return out, staged


def range_counts(start, end) -> dict:
    """Chunks in the written tiles' ranges, in all and in the longest one
    (the chain of chunks one block walks in order)."""
    n = (end - start)[(start >= 0) & (end > start)]
    return dict(chunks_in_ranges=int(n.sum()),
                max_tile_chunks=int(n.max()) if n.numel() else 0)


def tool_inputs(device: torch.device, small: bool):
    """(inputs per tiling, the tool's three (chunk_meta, gdata) inputs per
    tiling): 64x32 at the tool's capacity, 16x16 at the suggested one."""
    scene = _scene.scene(device, small)
    out = {}
    for tx, ty in ((64, 32), (16, 16)):
        cap = TOOL_CAPACITY if (tx, ty) == (64, 32) and not small else None
        inp = _scene.sorted_pair_inputs(scene, tx, ty, cap)
        cm = inp.lists.chunk_meta
        out[f"{tx}x{ty}"] = (inp, {
            "real": (cm, inp.gdata),
            "all-exec": (cm, torch.zeros_like(inp.gdata)),
            "floor": (cm & ~VALID_BIT, inp.gdata)})
    return out


def run(device=None, small: bool = False) -> dict:
    """Times kernels B and C on the three inputs and the stripped forms at
    the floor and the real input, at 64x32 and 16x16."""
    dev = resolve_device(device)
    small = small or dev.type == "cpu"
    on_card = dev.type == "cuda"
    res = dict(device=str(dev), timer=timer_name(dev), small=small)
    bg = torch.zeros(3, device=dev)
    for tiling, (inp, inputs) in tool_inputs(dev, small).items():
        lists = inp.lists
        tx, ty = lists.tile_x, lists.tile_y
        kw = dict(ntx=lists.n_tiles_x, nty=lists.n_tiles_y, tx=tx, ty=ty,
                  s_ch=0)
        n_tiles, n_pix = kw["ntx"] * kw["nty"], tx * ty
        start, end = blend.tile_chunk_ranges(lists.chunk_meta, n_tiles)
        live = (start >= 0) & (end > start)
        rec = dict(capacity=lists.capacity, chunks=lists.capacity // G_CHUNK,
                   tiles=n_tiles, tiles_written=int(live.sum()),
                   **range_counts(start, end),
                   raw_pairs=int(lists.raw_total), nf=inp.gdata.shape[1])

        def fwd(cm, g):
            return blend.blend_forward(g, cm, bg, **kw)

        def timed(key, fn, args, reps):
            rec[key] = time_ms(cycling(fn, args), dev, reps if on_card else 1)

        for tag, (cm, g) in inputs.items():
            timed(f"fwd {tag}", fwd, [(cm, x) for x in scaled(g)], 5)
        # kernel B at the floor input as issued: the host's pace of its
        # wrapper (`tile_chunk_ranges`, the launch) against the device's
        cm, g = inputs["floor"]
        floor_args = [(cm, x) for x in scaled(g)]
        rec["fwd floor issued"] = (cuda_ms(cycling(fwd, floor_args), 5)
                                   if on_card else rec["fwd floor"])
        for variant in VARIANTS:
            for tag in ("floor", "real"):
                cm, g = inputs[tag]
                timed(f"{variant} {tag}",
                      lambda c, x, v=variant: stripped_forward(
                          v, x, c, n_tiles=n_tiles, n_pix=n_pix),
                      [(cm, x) for x in scaled(g)], 10)
        planes = fwd(*inputs["real"])
        dout = torch.ones_like(planes)

        def bwd(cm, g):
            return blend.blend_backward(g, cm, bg, planes, dout,
                                        stat_width=inp.width,
                                        stat_height=inp.height, **kw)

        for tag, (cm, g) in inputs.items():
            timed(f"bwd {tag}", bwd, [(cm, x) for x in scaled(g)], 3)
        res[tiling] = rec
        del planes, dout, inputs
    return res


LINES = [("fwd real", "fwd real"),
         ("fwd all-exec (zero gdata)", "fwd all-exec"),
         ("fwd floor (all-invalid cm)", "fwd floor"),
         ("fwd floor, as issued", "fwd floor issued"),
         ("variant empty body", "empty floor"),
         ("variant meta+valid only", "stage floor"),
         ("variant + n_done check", "stage_done floor"),
         ("variant real kernel (floor cm)", "fwd floor"),
         ("variant empty body (real cm)", "empty real"),
         ("variant meta+valid (real cm)", "stage real"),
         ("variant + n_done (real cm)", "stage_done real"),
         ("bwd real", "bwd real"),
         ("bwd all-exec (zero gdata)", "bwd all-exec"),
         ("bwd floor (all-invalid cm)", "bwd floor")]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    res = run(args.device, args.small)
    print(f"device {res['device']}, {res['timer']}", flush=True)
    for tiling in ("64x32", "16x16"):
        r = res[tiling]
        print(f"{tiling}: chunks={r['chunks']} tiles={r['tiles']} "
              f"written={r['tiles_written']} "
              f"chunks_in_ranges={r['chunks_in_ranges']} "
              f"max_tile_chunks={r['max_tile_chunks']}", flush=True)
        for label, key in LINES:
            print(f"{tiling} {label:34s} {r[key]:9.4f} ms", flush=True)
    return res


if __name__ == "__main__":
    main()
