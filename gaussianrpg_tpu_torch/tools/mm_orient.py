"""The backward's moment contraction in two orientations: counterpart of
`tools/mm_orient.py`.

The JAX tool times, on the TPU's matrix unit, 9216 grid steps of
acc += (st + x) . ba at f32 HIGHEST with st [512, 2048] = 0.5 and
ba = 0.25, in form A (4G, P) x (P, C) -> [512, 16], form B
(C, P) x (4G, P)^T -> [16, 512], and B followed by a transpose (B+T): the
contraction of `pallas_blend._mm_pp`. `mm_orient` launches
`csrc/mm_orient.cu`, a register-tiled FP32 contraction (no tensor cores)
whose orientation sets the layout of ba and of the result. Step s reads
its own x[s] (all the tool's value), so every step's product is computed.
`mm_orient_library` (9216 `addmm_` calls into one accumulator, TF32 off)
is the yardstick; the port never calls it.

    python -m gaussianrpg_tpu_torch.tools.mm_orient [--device cpu] [--small]
"""
from __future__ import annotations

import argparse
import ctypes

import torch

from ..ops import cuda_build
from ..utils.device import resolve_device
from ._timing import cycling, scaled, time_ms, timer_name

FORMS = ("A", "B", "B+T")
C = 16
ROWS_PER_BLOCK, P_PER_BLOCK = 64, 128    # csrc/mm_orient.cu's block tile
FULL = dict(g4=512, p=2048, n_steps=9216)
SMALL = dict(g4=64, p=256, n_steps=4)

launches = 0               # kernel launches through `mm_orient`


def ba_shape(form: str, p: int):
    return (p, C) if form == "A" else (C, p)


def out_shape(form: str, g4: int):
    return (C, g4) if form == "B" else (g4, C)


def mm_orient_plain(form: str, st, ba, x) -> torch.Tensor:
    """Plain version: sum over steps s of (st + x[s]) . ba in the form's
    orientation, one step at a time."""
    if form not in FORMS:
        raise ValueError(f"mm_orient: unknown form {form!r}")
    acc = torch.zeros(out_shape(form, st.shape[0]), dtype=st.dtype,
                      device=st.device)
    for s in range(x.shape[0]):
        xs = st + x[s]
        if form == "A":
            acc += xs @ ba
        elif form == "B":
            acc += ba @ xs.T
        else:
            acc += (ba @ xs.T).T
    return acc


def mm_orient_library(form: str, st, ba, x) -> torch.Tensor:
    """One `addmm_` a step into one accumulator (the timing yardstick)."""
    acc = torch.zeros(out_shape("A" if form == "A" else "B", st.shape[0]),
                      dtype=st.dtype, device=st.device)
    for s in range(x.shape[0]):
        if form == "A":
            acc.addmm_(st + x[s], ba)
        else:
            acc.addmm_(ba, (st + x[s]).T)
    return acc.T.contiguous() if form == "B+T" else acc


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 t rounded to TF32 (10 mantissa bits, to nearest, ties
    away from zero), the operands a tensor-core TF32 product reads."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_orient_tf32(form: str, st, ba, x) -> torch.Tensor:
    """The plain version as a TF32 tensor-core kernel would compute it:
    each step's operands (st + x[s]) and ba rounded to TF32, products and
    sums in float64. A control: it must fail the limit the kernel is held
    to against the float64 plain version."""
    ba_r = tf32_round(ba).double()
    acc = torch.zeros(out_shape(form, st.shape[0]), dtype=torch.float64,
                      device=st.device)
    for s in range(x.shape[0]):
        xs = tf32_round(st + x[s]).double()
        acc += xs @ ba_r if form == "A" else ba_r @ xs.T
    return acc.T.contiguous() if form == "B+T" else acc


def _check(form, st, ba, x):
    if form not in FORMS:
        raise ValueError(f"mm_orient: unknown form {form!r}")
    if st.dim() != 2 or any(t.dtype != torch.float32 for t in (st, ba, x)):
        raise TypeError("mm_orient: float32 st [G4, P], ba, x [n_steps]")
    g4, p = st.shape
    if tuple(ba.shape) != ba_shape(form, p) or x.dim() != 1 \
            or x.shape[0] == 0:
        raise ValueError(f"mm_orient: ba must be {ba_shape(form, p)}, x "
                         "[n_steps]")
    if not (st.device == ba.device == x.device):
        raise ValueError("mm_orient: tensors on different devices")


def mm_orient(form: str, st, ba, x) -> torch.Tensor:
    """sum_s (st + x[s]) . ba: [G4, 16] for A and B+T, [16, G4] for B.
    st [G4, P] (G4 a multiple of 64, P of 128 on the card), ba [P, 16]
    (A) or [16, P] (B, B+T), x [n_steps], float32. CUDA tensors go through
    the kernel, CPU tensors through the plain version."""
    global launches
    _check(form, st, ba, x)
    if st.device.type == "cpu":
        return mm_orient_plain(form, st, ba, x)
    if st.device.type != "cuda":
        raise ValueError(f"mm_orient: unsupported device {st.device}")
    g4, p = st.shape
    if g4 % ROWS_PER_BLOCK or p % P_PER_BLOCK:
        raise ValueError(f"mm_orient: G4 must be a multiple of "
                         f"{ROWS_PER_BLOCK}, P of {P_PER_BLOCK}")
    st, ba, x = st.contiguous(), ba.contiguous(), x.contiguous()
    n_steps = x.shape[0]
    # split the steps over as many blocks as fill the card once
    base = (g4 // ROWS_PER_BLOCK) * (p // P_PER_BLOCK)
    sms = torch.cuda.get_device_properties(st.device).multi_processor_count
    n_split = max(1, min(n_steps, sms // base))
    partial = torch.empty(n_split * (p // P_PER_BLOCK) * g4 * C,
                          dtype=torch.float32, device=st.device)
    out = torch.empty(out_shape(form, g4), dtype=torch.float32,
                      device=st.device)
    fn = cuda_build.library("mm_orient").grpg_mm_orient
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(st.device).cuda_stream
    with torch.cuda.device(st.device):
        err = fn(FORMS.index(form), st.data_ptr(), ba.data_ptr(),
                 x.data_ptr(), n_steps, g4, p, n_split, partial.data_ptr(),
                 out.data_ptr(), stream)
    cuda_build.check(err, "mm_orient launch")
    launches += 1
    return out


def tool_inputs(form: str, device: torch.device, small: bool):
    """The tool's operands: st = 0.5, ba = 0.25 and x[s] = 1."""
    size = SMALL if small else FULL
    st = torch.full((size["g4"], size["p"]), 0.5, device=device)
    ba = torch.full(ba_shape(form, size["p"]), 0.25, device=device)
    x = torch.ones(size["n_steps"], device=device)
    return st, ba, x


def run(device=None, small: bool = False) -> dict:
    """Times each form's kernel and its `addmm_` yardstick."""
    dev = resolve_device(device)
    small = small or dev.type == "cpu"
    on_card = dev.type == "cuda"
    res = dict(device=str(dev), timer=timer_name(dev), small=small,
               **(SMALL if small else FULL))
    for form in FORMS:
        st, ba, x = tool_inputs(form, dev, small)
        variants = [(st, ba, xv) for xv in scaled(x)]
        ms = time_ms(cycling(lambda *a, f=form: mm_orient(f, *a), variants),
                     dev, 3 if on_card else 1)
        lib_ms = time_ms(cycling(
            lambda *a, f=form: mm_orient_library(f, *a), variants), dev, 1)
        res[form] = dict(ms=ms, library_ms=lib_ms,
                         us_per_step=ms / res["n_steps"] * 1e3)
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    res = run(args.device, args.small)
    print(f"device {res['device']}, {res['timer']}", flush=True)
    for form in FORMS:
        r = res[form]
        print(f"{form:5s} {r['ms']:9.4f} ms  ({r['us_per_step']:.4f} "
              f"us/step); addmm_ {r['library_ms']:9.4f} ms", flush=True)
    return res


if __name__ == "__main__":
    main()
