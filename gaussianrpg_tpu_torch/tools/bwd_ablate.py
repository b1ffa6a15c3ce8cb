"""Where kernel C's time goes: counterpart of `tools/bwd_ablate.py`.

The JAX tool times the blend backward with parts of its body switched off
(`pallas_blend.BWD_ABLATE`); its "nograd" form keeps the replay and the
per-pixel terms and drops the per-pair reductions. Here that form is a
compile-time variant of kernel C (`csrc/blend_bwd.cu`, entry
`grpg_blend_bwd_nograd`), which `ops/blend.blend_backward` never reaches:
the same chunk walk, replay and per-pixel gradient terms, no reductions,
zero gradient rows. `nograd_backward` launches it. Both forms run on the
frozen bench scene's depth-sorted pair rows at 64x32 and 16x16 tiles
(capacity from `suggest_binning_sizes`), on kernel B's planes and a seeded
random cotangent; full minus nograd is what the reductions cost.

    python -m gaussianrpg_tpu_torch.tools.bwd_ablate [--device cpu] [--small]
"""
from __future__ import annotations

import argparse

import torch

from ..ops import blend
from ..ops.binning import G_CHUNK
from ..utils.device import resolve_device
from . import _scene
from ._timing import cycling, scaled, time_ms, timer_name

launches = 0               # kernel launches through `nograd_backward`


def nograd_backward(gdata, chunk_meta, bg, out, dout, *, ntx: int, nty: int,
                    tx: int, ty: int, s_ch: int, stat_width: int,
                    stat_height: int) -> torch.Tensor:
    """Kernel C without its reductions: [P_pad, NF] zero rows, computed on
    the card by the replay and the per-pixel terms of `blend_backward`.
    CPU tensors get the plain version (zero rows). Keywords: those of
    `blend.blend_backward`."""
    global launches
    name = "grpg_blend_bwd_nograd"
    n_tiles = ntx * nty
    blend.check_backward(gdata, chunk_meta, bg, out, dout, n_tiles=n_tiles,
                         tx=tx, ty=ty, s_ch=s_ch, name=name)
    if gdata.device.type == "cpu":
        return torch.zeros_like(gdata)
    if gdata.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {gdata.device}")
    grad = blend._launch_backward(name, gdata, chunk_meta, bg, out, dout,
                                  n_tiles=n_tiles, ntx=ntx, tx=tx, ty=ty,
                                  s_ch=s_ch, stat_width=stat_width,
                                  stat_height=stat_height)
    launches += 1
    return grad


def run(device=None, small: bool = False) -> dict:
    """Times kernel C and its no-reduction form (and kernel B beside them)
    at 64x32 and 16x16 tiles; the no-reduction rows are checked for
    zeros."""
    dev = resolve_device(device)
    small = small or dev.type == "cpu"
    res = dict(device=str(dev), timer=timer_name(dev), small=small)
    scene = _scene.scene(dev, small)
    gen = torch.Generator().manual_seed(0)
    for tx, ty in ((64, 32), (16, 16)):
        inp = _scene.sorted_pair_inputs(scene, tx, ty)
        lists, gdata = inp.lists, inp.gdata
        cm = lists.chunk_meta
        kw = dict(ntx=lists.n_tiles_x, nty=lists.n_tiles_y, tx=tx, ty=ty,
                  s_ch=0)
        bg = torch.zeros(3, device=dev)
        planes = blend.blend_forward(gdata, cm, bg, **kw)
        dout = torch.randn(planes.shape, generator=gen).to(dev)
        bkw = dict(kw, stat_width=inp.width, stat_height=inp.height)
        args = [(x,) for x in scaled(gdata)]
        reps = 5 if dev.type == "cuda" else 1
        rec = dict(capacity=lists.capacity, chunks=lists.capacity // G_CHUNK,
                   raw_pairs=int(lists.raw_total))
        rec["fwd"] = time_ms(cycling(
            lambda g: blend.blend_forward(g, cm, bg, **kw), args), dev, reps)
        rec["full"] = time_ms(cycling(
            lambda g: blend.blend_backward(g, cm, bg, planes, dout, **bkw),
            args), dev, reps)
        rec["nograd"] = time_ms(cycling(
            lambda g: nograd_backward(g, cm, bg, planes, dout, **bkw),
            args), dev, reps)
        rec["reductions_share"] = (1.0 - rec["nograd"] / rec["full"]
                                   if rec["full"] > 0 else 0.0)
        rows = nograd_backward(gdata, cm, bg, planes, dout, **bkw)
        rec["nograd_rows_zero"] = not bool(rows.any())
        res[f"{tx}x{ty}"] = rec
        del planes, dout, rows, inp, lists, gdata
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    res = run(args.device, args.small)
    print(f"device {res['device']}, {res['timer']}", flush=True)
    for tiling in ("64x32", "16x16"):
        r = res[tiling]
        print(f"{tiling}: chunks={r['chunks']} pairs={r['raw_pairs']}",
              flush=True)
        for key in ("fwd", "full", "nograd"):
            print(f"{tiling} {key:6s} {r[key]:9.4f} ms", flush=True)
        print(f"{tiling} reductions' share {r['reductions_share']:.4f} "
              f"(nograd rows zero: {r['nograd_rows_zero']})", flush=True)
    return res


if __name__ == "__main__":
    main()
