"""YOLOv5 v6.0 in plain PyTorch (`F.conv2d`), from the published model
file (github.com/ultralytics/yolov5, tag v6.0, `models/yolov5s.yaml` and
`models/common.py`): Conv = conv (batch norm folded in) + SiLU, C3,
SPPF, nearest upsampling, the Detect head's sigmoid decode with the
default anchors; the letterbox, and the top-K prefilter the fused
perception path keeps (confidence obj x class, the best class over all,
zeroed outside the kept classes).

Weights are a flat list of (weight [cout, cin, k, k], bias [cout]) in
`conv_shapes` order: each layer's convs, a C3 as cv1, cv2, cv3 and then
its bottlenecks' cv1, cv2; SPPF cv1, cv2; the three Detect convs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# (kind, from, channels, repeats or kernel, stride / shortcut)
BACKBONE = [("conv", -1, 64, 6, 2), ("conv", -1, 128, 3, 2),
            ("c3", -1, 128, 3, True), ("conv", -1, 256, 3, 2),
            ("c3", -1, 256, 6, True), ("conv", -1, 512, 3, 2),
            ("c3", -1, 512, 9, True), ("conv", -1, 1024, 3, 2),
            ("c3", -1, 1024, 3, True), ("sppf", -1, 1024, 5, None)]
HEAD = [("conv", -1, 512, 1, 1), ("up", -1, None, None, None),
        ("cat", (-1, 6), None, None, None), ("c3", -1, 512, 3, False),
        ("conv", -1, 256, 1, 1), ("up", -1, None, None, None),
        ("cat", (-1, 4), None, None, None), ("c3", -1, 256, 3, False),
        ("conv", -1, 256, 3, 2), ("cat", (-1, 14), None, None, None),
        ("c3", -1, 512, 3, False), ("conv", -1, 512, 3, 2),
        ("cat", (-1, 10), None, None, None), ("c3", -1, 1024, 3, False),
        ("detect", (17, 20, 23), None, None, None)]
STRIDES = (8, 16, 32)
ANCHORS = ((10, 13, 16, 30, 33, 23), (30, 61, 62, 45, 59, 119),
           (116, 90, 156, 198, 373, 326))


def _width(c, width_multiple):
    return int(math.ceil(c * width_multiple / 8) * 8)


def layers(depth_multiple: float, width_multiple: float, nc: int):
    """Resolved layers: (kind, from, cin, cout, n or k, stride/shortcut)."""
    out, ch = [], [3]
    for kind, frm, c, n, s in BACKBONE + HEAD:
        if kind in ("conv", "c3", "sppf"):
            cout = _width(c, width_multiple)
            reps = max(round(n * depth_multiple), 1) if kind == "c3" else n
            out.append((kind, frm, ch[-1], cout, reps, s))
            ch.append(cout)
        elif kind == "up":
            out.append((kind, frm, ch[-1], ch[-1], None, None))
            ch.append(ch[-1])
        elif kind == "cat":
            cin = sum(ch[-1] if f == -1 else ch[f + 1] for f in frm)
            out.append((kind, frm, cin, cin, None, None))
            ch.append(cin)
        else:
            out.append((kind, frm, [ch[f + 1] for f in frm], (nc + 5) * 3,
                        None, None))
            ch.append(0)
    return out


def conv_shapes(lays):
    """(cout, cin, k, stride) of every conv, in the weights' order."""
    shapes = []
    for kind, _, cin, cout, n, s in lays:
        if kind == "conv":
            shapes.append((cout, cin, n, s))
        elif kind == "c3":
            h = cout // 2
            shapes += [(h, cin, 1, 1), (h, cin, 1, 1), (cout, 2 * h, 1, 1)]
            shapes += [(h, h, 1, 1), (h, h, 3, 1)] * n
        elif kind == "sppf":
            h = cin // 2
            shapes += [(h, cin, 1, 1), (cout, 4 * h, 1, 1)]
        elif kind == "detect":
            shapes += [(cout, c, 1, 1) for c in cin]
    return shapes


def conv_flops(lays, h: int, w: int) -> int:
    """Multiply-add FLOPs (two a product) of every conv on one h x w image;
    activations, pooling and the decode are not counted."""
    total, sizes = 0, [(h, w)]
    for kind, frm, cin, cout, n, s in lays:
        hw = sizes[-1]
        if kind in ("conv", "c3", "sppf"):
            for co, ci, k, st in conv_shapes([(kind, frm, cin, cout, n, s)]):
                o = (-(-hw[0] // st), -(-hw[1] // st))
                total += 2 * co * ci * k * k * o[0] * o[1]
                if kind == "conv":
                    hw = o
        elif kind == "up":
            hw = (hw[0] * 2, hw[1] * 2)
        elif kind == "detect":
            for f, c in zip(frm, cin):
                fh, fw = sizes[f + 1]
                total += 2 * c * cout * fh * fw
        sizes.append(hw)
    return total


def _conv(x, wb, k, s, act=True):
    # padding k // 2, and 2 for the 6x6 stem as the model file sets it
    y = F.conv2d(x, wb[0], wb[1], stride=s, padding=(k - 1) // 2)
    return F.silu(y) if act else y


def predict(lays, weights, image: torch.Tensor, nc: int,
            raw: bool = False) -> torch.Tensor:
    """image [3, h, w] in [0, 1] -> [A, 5 + nc] rows (x, y, w, h in input
    pixels, objectness, class scores), each level's rows in (y, x,
    anchor) order; with `raw`, the Detect convs' outputs before the
    sigmoid and the decode, in the same rows."""
    it = iter(weights)
    x, outs = image[None], []
    for kind, frm, cin, cout, n, s in lays:
        if kind == "conv":
            x = _conv(x, next(it), n, s)
        elif kind == "c3":
            c1, c2, c3 = next(it), next(it), next(it)
            a = _conv(x, c1, 1, 1)
            for _ in range(n):
                b1, b2 = next(it), next(it)
                y = _conv(_conv(a, b1, 1, 1), b2, 3, 1)
                a = a + y if s else y
            x = _conv(torch.cat([a, _conv(x, c2, 1, 1)], 1), c3, 1, 1)
        elif kind == "sppf":
            c1, c2 = next(it), next(it)
            x = _conv(x, c1, 1, 1)
            y1 = F.max_pool2d(x, n, 1, n // 2)
            y2 = F.max_pool2d(y1, n, 1, n // 2)
            y3 = F.max_pool2d(y2, n, 1, n // 2)
            x = _conv(torch.cat([x, y1, y2, y3], 1), c2, 1, 1)
        elif kind == "up":
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        elif kind == "cat":
            x = torch.cat([x if f == -1 else outs[f] for f in frm], 1)
        else:
            rows = []
            for lvl, f in enumerate(frm):
                feat = _conv(outs[f], next(it), 1, 1, act=False)[0]
                _, fh, fw = feat.shape
                t = feat.view(3, nc + 5, fh, fw).permute(2, 3, 0, 1)
                if raw:                                      # [h, w, 3, no]
                    rows.append(t.reshape(-1, nc + 5))
                    continue
                t = torch.sigmoid(t)
                gy, gx = torch.meshgrid(
                    torch.arange(fh, device=feat.device, dtype=feat.dtype),
                    torch.arange(fw, device=feat.device, dtype=feat.dtype),
                    indexing="ij")
                grid = torch.stack([gx, gy], -1)[:, :, None, :]
                anchor = torch.tensor(ANCHORS[lvl], dtype=feat.dtype,
                                      device=feat.device).view(1, 1, 3, 2)
                xy = (t[..., :2] * 2 - 0.5 + grid) * STRIDES[lvl]
                wh = (t[..., 2:4] * 2) ** 2 * anchor
                rows.append(torch.cat([xy, wh, t[..., 4:]], -1)
                            .reshape(-1, nc + 5))
            return torch.cat(rows, 0)
        outs.append(x)
    raise ValueError("no detect layer")


def letterbox_geometry(hw, out_hw):
    """(gain, (h, w) of the shrunk image, (left, top) of its corner)."""
    h, w = hw
    gain = min(out_hw[0] / h, out_hw[1] / w)
    uh, uw = int(round(h * gain)), int(round(w * gain))
    left = int(round((out_hw[1] - uw) / 2 - 0.1))
    top = int(round((out_hw[0] - uh) / 2 - 0.1))
    return gain, (uh, uw), (left, top)


def letterbox(img: torch.Tensor, out_hw, color: float = 0.447):
    """[3, H, W] -> ([3, h, w] the image clamped to [0, 1], shrunk by
    antialiased bilinear resampling to fit, centred on `color`), gain,
    (left, top)."""
    gain, (uh, uw), (left, top) = letterbox_geometry(img.shape[1:], out_hw)
    small = F.interpolate(img.clamp(0, 1)[None], (uh, uw), mode="bilinear",
                          align_corners=False, antialias=True)[0]
    out = torch.full((3, *out_hw), color, dtype=img.dtype, device=img.device)
    out[:, top:top + uh, left:left + uw] = small
    return out, gain, (left, top)


def top_candidates(pred: torch.Tensor, k: int, classes) -> torch.Tensor:
    """[K, 6] (x, y, w, h, conf, class) of the K most confident rows."""
    scores = pred[:, 5:] * pred[:, 4:5]
    conf, cls = scores.max(1)
    keep = torch.zeros(scores.shape[1], dtype=torch.bool, device=pred.device)
    keep[list(classes)] = True
    conf = torch.where(keep[cls], conf, torch.zeros_like(conf))
    top = torch.topk(conf, k)
    return torch.cat([pred[top.indices, :4], top.values[:, None],
                      cls[top.indices, None].to(pred.dtype)], 1)
