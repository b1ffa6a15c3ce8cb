"""The rasterizer's eval primitive stage on the card: one launch of the
hand-written `csrc/primitive_fields.cu` (one thread a Gaussian, every
intermediate in registers) writes the whole of `rasterize.FieldSet`.

`rasterize.primitive_fields` routes by what the call holds: a call on the
card that autograd does not record and that passes neither train hook
(`engages`) comes here; every other call, training and every CPU tensor,
runs the PyTorch composition (`rasterize.primitive_fields_plain`). The two
share no logic: the kernel repeats the composition's arithmetic in its
order, and its outputs equal the composition's bit for bit on the card
(the card tests of `tests/test_torch_primitive_fields.py`). A call the
kernel does not take (a dtype, shape or device) raises.

The camera's view and projection matrices are read from the device
tensors the call holds, so a replay of the render's CUDA graph that copies
in a new camera is seen; the image size, tangents, tile size and scale
modifier are launch arguments (the graph keys them).
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .blend import NF_BASE

launches = 0              # kernel launches through `primitive_fields`
CARD = "cuda"             # the device type the kernel runs on
# each per-Gaussian input's shape after its N rows (semantics: any width)
WIDTHS = dict(means3d=(3,), opacities=(), colors=(3,), scales=(3,),
              rotations=(4,), cov3d_precomp=(6,))


def _round_up(x, m):
    return (x + m - 1) // m * m


def engages(means3d, recorded, hooks) -> bool:
    """Whether a `primitive_fields` call takes the kernel: its Gaussians
    on the card, no train hook given, and autograd recording none of the
    `recorded` tensors (None entries are skipped)."""
    if means3d.device.type != CARD or any(h is not None for h in hooks):
        return False
    return not (torch.is_grad_enabled()
                and any(t is not None and t.requires_grad
                        for t in recorded))


def _check(n, tensors, view, proj, mask):
    """Raise on what the kernel does not take: a float input not float32,
    a shape other than [N, *WIDTHS[name]] ([N, S] for semantics), a
    camera matrix not float32 [4, 4], a mask not bool [N], or a tensor off
    means3d's device."""
    dev = tensors["means3d"].device
    named = dict(tensors, viewmatrix=view, projmatrix=proj)
    for name, t in named.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"primitive_fields: {name} must be float32, "
                            f"not {t.dtype}")
        want = WIDTHS.get(name)
        shape = tuple(t.shape)
        ok = (shape == (4, 4) if name in ("viewmatrix", "projmatrix")
              else shape[:1] == (n,) and (len(shape) == 2 if want is None
                                         else shape[1:] == want))
        if not ok:
            raise ValueError(f"primitive_fields: {name} has shape {shape}")
        if t.device != dev:
            raise ValueError(f"primitive_fields: {name} on {t.device}, "
                             f"means3d on {dev}")
    if mask is not None:
        if mask.dtype != torch.bool:
            raise TypeError("primitive_fields: active_mask must be bool")
        if tuple(mask.shape) != (n,) or mask.device != dev:
            raise ValueError(f"primitive_fields: active_mask must be [{n}] "
                             f"on {dev}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(means3d, opacities, colors, semantics, scales, rotations,
            cov3d, mask, view, proj, *, nf, s_ch, width, height, tile_x,
            tile_y, focal_x, focal_y, lim_x, lim_y, scale_modifier, tight):
    global launches
    n = means3d.shape[0]
    dev = means3d.device
    fields = torch.empty((n, nf), dtype=torch.float32, device=dev)
    rect_min = torch.empty((n, 2), dtype=torch.int32, device=dev)
    rect_max = torch.empty((n, 2), dtype=torch.int32, device=dev)
    radii = torch.empty(n, dtype=torch.int32, device=dev)
    depths = torch.empty(n, dtype=torch.float32, device=dev)
    means2d = torch.empty((n, 2), dtype=torch.float32, device=dev)
    fn = cuda_build.library("primitive_fields").grpg_primitive_fields
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, p, p, p, i, p, p, p, ctypes.c_longlong, i, i,
                   i, i, i, f, f, f, f, f, i, p, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(_ptr(means3d), _ptr(scales), _ptr(rotations), _ptr(cov3d),
                 _ptr(opacities), _ptr(colors), _ptr(semantics), s_ch,
                 _ptr(mask), _ptr(view), _ptr(proj), n, nf, width, height,
                 tile_x, tile_y, focal_x, focal_y, lim_x, lim_y,
                 scale_modifier, int(tight), _ptr(fields), _ptr(rect_min),
                 _ptr(rect_max), _ptr(radii), _ptr(depths), _ptr(means2d),
                 stream)
    cuda_build.check(err, "primitive_fields launch")
    if n:                     # the C entry launches nothing for no rows
        launches += 1
    return fields, rect_min, rect_max, radii, depths, means2d


def primitive_fields(means3d, opacities, *, camera, colors, semantics,
                     scales, rotations, cov3d_precomp, scale_modifier,
                     active_mask, tile_x, tile_y, tight_rect):
    """(fields [N, NF], rect_min [N, 2], rect_max [N, 2], radii [N],
    depths [N], means2d [N, 2]) of `rasterize.FieldSet`, from one kernel
    launch. `opacities` [N], `colors` [N, 3] (spherical harmonics already
    evaluated), `semantics` [N, S] or None, `scales` [N, 3] and
    `rotations` [N, 4] or `cov3d_precomp` [N, 6], `active_mask` [N] bool
    or None; all float32 on the card with the camera's matrices."""
    n = means3d.shape[0]
    s_ch = 0 if semantics is None else semantics.shape[-1]
    if cov3d_precomp is not None:
        scales = rotations = None
    tensors = dict(means3d=means3d, opacities=opacities, colors=colors,
                   semantics=semantics, scales=scales, rotations=rotations,
                   cov3d_precomp=cov3d_precomp)
    _check(n, tensors, camera.viewmatrix, camera.projmatrix, active_mask)
    if means3d.device.type != CARD:
        raise ValueError(f"primitive_fields: the kernel runs on {CARD}, "
                         f"not {means3d.device}")
    W, H = camera.width, camera.height
    lim_x = camera.lim_tan_fovx
    lim_y = camera.lim_tan_fovy
    args = [None if t is None else t.contiguous() for t in (
        means3d, opacities, colors, semantics, scales, rotations,
        cov3d_precomp, active_mask, camera.viewmatrix, camera.projmatrix)]
    return _launch(
        *args, nf=_round_up(NF_BASE + s_ch, 8), s_ch=s_ch, width=W,
        height=H, tile_x=tile_x, tile_y=tile_y,
        focal_x=W / (2.0 * camera.tan_fovx),
        focal_y=H / (2.0 * camera.tan_fovy),
        lim_x=1.3 * (lim_x if lim_x is not None else camera.tan_fovx),
        lim_y=1.3 * (lim_y if lim_y is not None else camera.tan_fovy),
        scale_modifier=float(scale_modifier), tight=tight_rect)
