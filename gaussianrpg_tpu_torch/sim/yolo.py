"""YOLOv5 inference in PyTorch (the simulator's perception).

Counterpart of `gaussianrpg_tpu/sim/yolo.py`: the v6.0 graph (depth 0.33 /
width 0.50 for yolov5s) resolved from the same layer tables, the same
seeded random initialization, the same decode and the same host-side pre-
and post-processing. The graph is an `nn.Module` of `nn.Conv2d` layers
(BN folded into the weights at load time, SiLU after each), run in NCHW;
the public functions keep the JAX package's layouts: images [N, H, W, 3]
in [0, 1], parameters as the JAX tree of HWIO weights, predictions
[N, A, 5 + nc] whose rows are in (y, x, anchor) order per detect level.

Nothing here reaches a Pallas kernel in the JAX package (XLA computes its
convolutions), so the port's layers are torch ops (cuDNN on the card).
NMS and coordinate mapping run on the host in numpy, as there; the
letterbox is one torch function (`letterbox_tensor`) for a frame on the
host (`letterbox`) or on the card (sim/pipeline.letterbox_device).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from ..utils.spans import span

# yolov5 v6.0 graph: (module, from, args); base channels before the width
# multiple, C3 repeats before the depth multiple
_BACKBONE = [
    ("conv", -1, 64, 6, 2),    # 0  P1/2
    ("conv", -1, 128, 3, 2),   # 1  P2/4
    ("c3", -1, 128, 3, True),
    ("conv", -1, 256, 3, 2),   # 3  P3/8
    ("c3", -1, 256, 6, True),
    ("conv", -1, 512, 3, 2),   # 5  P4/16
    ("c3", -1, 512, 9, True),
    ("conv", -1, 1024, 3, 2),  # 7  P5/32
    ("c3", -1, 1024, 3, True),
    ("sppf", -1, 1024, 5),     # 9
]
_HEAD = [
    ("conv", -1, 512, 1, 1),           # 10
    ("upsample", -1),                  # 11
    ("concat", (-1, 6)),               # 12
    ("c3", -1, 512, 3, False),         # 13
    ("conv", -1, 256, 1, 1),           # 14
    ("upsample", -1),                  # 15
    ("concat", (-1, 4)),               # 16
    ("c3", -1, 256, 3, False),         # 17 P3
    ("conv", -1, 256, 3, 2),           # 18
    ("concat", (-1, 14)),              # 19
    ("c3", -1, 512, 3, False),         # 20 P4
    ("conv", -1, 512, 3, 2),           # 21
    ("concat", (-1, 10)),              # 22
    ("c3", -1, 1024, 3, False),        # 23 P5
    ("detect", (17, 20, 23)),          # 24
]
STRIDES = (8, 16, 32)
DEFAULT_ANCHORS = np.array(
    [[[10, 13], [16, 30], [33, 23]],
     [[30, 61], [62, 45], [59, 119]],
     [[116, 90], [156, 198], [373, 326]]], np.float32)

# COCO class ids the AEB pipeline keeps (person, bicycle, car, motorcycle,
# bus, truck)
COCO_VEHICLE_PERSON = (0, 1, 2, 3, 5, 7)


def _ch(c, width):
    return max(8, int(np.ceil(c * width / 8) * 8))


def _depth(n, depth):
    return max(int(round(n * depth)), 1)


def spec_yolov5(num_classes: int = 80, depth: float = 0.33,
                width: float = 0.50):
    """Resolved per-layer spec: a list of dicts with static shapes."""
    layers = []
    ch = [3]
    for item in _BACKBONE + _HEAD:
        kind = item[0]
        if kind == "conv":
            _, frm, c, k, s = item
            c = _ch(c, width)
            layers.append(dict(kind=kind, frm=frm, cin=ch[frm if frm >= 0
                                                         else len(ch) + frm],
                               cout=c, k=k, s=s))
            ch.append(c)
        elif kind == "c3":
            _, frm, c, n, shortcut = item
            c = _ch(c, width)
            layers.append(dict(kind=kind, frm=frm,
                               cin=ch[frm if frm >= 0 else len(ch) + frm],
                               cout=c, n=_depth(n, depth),
                               shortcut=shortcut))
            ch.append(c)
        elif kind == "sppf":
            _, frm, c, k = item
            c = _ch(c, width)
            layers.append(dict(kind=kind, frm=frm, cin=ch[-1], cout=c, k=k))
            ch.append(c)
        elif kind == "upsample":
            layers.append(dict(kind=kind, frm=-1))
            ch.append(ch[-1])
        elif kind == "concat":
            _, frms = item
            cin = sum(ch[f + 1] if f >= 0 else ch[len(ch) + f]
                      for f in frms)
            layers.append(dict(kind=kind, frms=frms))
            ch.append(cin)
        elif kind == "detect":
            _, frms = item
            layers.append(dict(kind=kind, frms=frms, nc=num_classes,
                               cins=[ch[f + 1] for f in frms]))
            ch.append(0)
    return layers


# ---------------------------------------------------------------------------
# the graph


class _Conv(nn.Module):
    """Conv (BN folded in) + SiLU, yolov5 autopad (k=6 stem: p=2)."""

    def __init__(self, cin, cout, k, s=1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, (k - 1) // 2, bias=True)
        self.act = act

    def forward(self, x):
        y = self.conv(x)
        return F.silu(y) if self.act else y


class _Bottleneck(nn.Module):
    def __init__(self, c, shortcut):
        super().__init__()
        self.cv1 = _Conv(c, c, 1)
        self.cv2 = _Conv(c, c, 3)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class _C3(nn.Module):
    def __init__(self, cin, cout, n, shortcut):
        super().__init__()
        c_ = cout // 2
        self.cv1 = _Conv(cin, c_, 1)
        self.cv2 = _Conv(cin, c_, 1)
        self.cv3 = _Conv(2 * c_, cout, 1)
        self.m = nn.ModuleList(_Bottleneck(c_, shortcut) for _ in range(n))

    def forward(self, x):
        a = self.cv1(x)
        for m in self.m:
            a = m(a)
        return self.cv3(torch.cat([a, self.cv2(x)], dim=1))


class _SPPF(nn.Module):
    def __init__(self, cin, cout, k):
        super().__init__()
        c_ = cin // 2
        self.cv1 = _Conv(cin, c_, 1)
        self.cv2 = _Conv(4 * c_, cout, 1)
        self.k = k

    def forward(self, x):
        x = self.cv1(x)
        # max_pool2d pads with -inf, as the JAX reduce_window does
        y1 = F.max_pool2d(x, self.k, 1, self.k // 2)
        y2 = F.max_pool2d(y1, self.k, 1, self.k // 2)
        y3 = F.max_pool2d(y2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


class _Detect(nn.Module):
    """The three 1x1 output convs and the decode to (xywh in input pixels,
    obj, class scores). `anchors` [3, 3, 2] are in pixels."""

    def __init__(self, cins, nc):
        super().__init__()
        self.no = nc + 5
        self.m = nn.ModuleList(nn.Conv2d(c, self.no * 3, 1) for c in cins)
        self.register_buffer("anchors", torch.tensor(DEFAULT_ANCHORS))

    def forward(self, feats):
        preds = []
        for i, (conv, x) in enumerate(zip(self.m, feats)):
            feat = conv(x)
            n, _, h, w = feat.shape
            # channel a * no + j -> [n, h, w, anchor, no]: rows in
            # (y, x, anchor) order, as the JAX NHWC reshape gives them
            sig = torch.sigmoid(
                feat.view(n, 3, self.no, h, w).permute(0, 3, 4, 1, 2))
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=feat.dtype, device=feat.device),
                torch.arange(w, dtype=feat.dtype, device=feat.device),
                indexing="ij")
            grid = torch.stack([gx, gy], dim=-1)[:, :, None, :]
            anchors = self.anchors[i].reshape(1, 1, 3, 2)
            xy = (sig[..., 0:2] * 2.0 - 0.5 + grid) * float(STRIDES[i])
            wh = (sig[..., 2:4] * 2.0) ** 2 * anchors
            pred = torch.cat([xy, wh, sig[..., 4:]], dim=-1)
            preds.append(pred.reshape(n, h * w * 3, self.no))
        return torch.cat(preds, dim=1)


class YoloV5(nn.Module):
    """The graph of `spec`: image [N, H, W, 3] in [0, 1] -> decoded
    predictions [N, A, 5 + nc] with xywh in input pixels."""

    def __init__(self, spec):
        super().__init__()
        self.spec = spec
        mods = []
        for lay in spec:
            kind = lay["kind"]
            if kind == "conv":
                mods.append(_Conv(lay["cin"], lay["cout"], lay["k"],
                                  lay["s"]))
            elif kind == "c3":
                mods.append(_C3(lay["cin"], lay["cout"], lay["n"],
                                lay["shortcut"]))
            elif kind == "sppf":
                mods.append(_SPPF(lay["cin"], lay["cout"], lay["k"]))
            elif kind == "detect":
                mods.append(_Detect(lay["cins"], lay["nc"]))
            else:
                mods.append(nn.Identity())
        self.layers = nn.ModuleList(mods)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = image.permute(0, 3, 1, 2).contiguous()
        outputs = []
        for lay, mod in zip(self.spec, self.layers):
            kind = lay["kind"]
            if kind == "upsample":
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            elif kind == "concat":
                x = torch.cat([x if f == -1 else outputs[f]
                               for f in lay["frms"]], dim=1)
            elif kind == "detect":
                return mod([outputs[f] for f in lay["frms"]])
            else:
                x = mod(x)
            outputs.append(x)
        raise ValueError("spec has no detect layer")


def forward(spec, params: YoloV5, image: torch.Tensor) -> torch.Tensor:
    """image [N, H, W, 3] in [0, 1] -> decoded predictions [N, A, 5 + nc]
    (`params` is the graph built for `spec`)."""
    with torch.no_grad():
        return params(image)


# ---------------------------------------------------------------------------
# parameters: the JAX tree (HWIO weights, biases, anchors in pixels)


def _conv_params(rng, cin, cout, k):
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32) \
        * np.sqrt(2.0 / (k * k * cin))
    return {"w": w, "b": np.zeros((cout,), np.float32)}


def init_param_tree(spec, seed: int = 0):
    """Random (BN-fused form) parameters as numpy arrays in the JAX tree
    layout: the same draws as the JAX package's `init_params`."""
    rng = np.random.default_rng(seed)
    params: list[Any] = []
    for lay in spec:
        kind = lay["kind"]
        if kind == "conv":
            params.append(_conv_params(rng, lay["cin"], lay["cout"],
                                       lay["k"]))
        elif kind == "c3":
            c_ = lay["cout"] // 2
            params.append({
                "cv1": _conv_params(rng, lay["cin"], c_, 1),
                "cv2": _conv_params(rng, lay["cin"], c_, 1),
                "cv3": _conv_params(rng, 2 * c_, lay["cout"], 1),
                "m": [{"cv1": _conv_params(rng, c_, c_, 1),
                       "cv2": _conv_params(rng, c_, c_, 3)}
                      for _ in range(lay["n"])],
            })
        elif kind == "sppf":
            c_ = lay["cin"] // 2
            params.append({
                "cv1": _conv_params(rng, lay["cin"], c_, 1),
                "cv2": _conv_params(rng, c_ * 4, lay["cout"], 1),
            })
        elif kind == "detect":
            no = lay["nc"] + 5
            params.append({
                "m": [_conv_params(rng, cin, no * 3, 1)
                      for cin in lay["cins"]],
                "anchors": DEFAULT_ANCHORS.copy(),
            })
        else:
            params.append({})
    return params


def _set_conv(conv: nn.Conv2d, p):
    w = np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)   # HWIO->OIHW
    conv.weight.copy_(torch.tensor(w))
    conv.bias.copy_(torch.tensor(np.asarray(p["b"], np.float32)))


def model_from_params(spec, params, device=None) -> YoloV5:
    """The port's graph for `spec` carrying a JAX-layout parameter tree
    (numpy arrays, or anything `np.asarray` reads: HWIO conv weights,
    biases, detect anchors [3, 3, 2] in pixels), in eval mode on `device`
    (CUDA unless given)."""
    dev = resolve_device(device)
    model = YoloV5(spec)
    with torch.no_grad():
        for lay, mod, p in zip(spec, model.layers, params):
            kind = lay["kind"]
            if kind == "conv":
                _set_conv(mod.conv, p)
            elif kind in ("c3", "sppf"):
                for name in ("cv1", "cv2", "cv3"):
                    if name in p:
                        _set_conv(getattr(mod, name).conv, p[name])
                for bm, bp in zip(getattr(mod, "m", ()), p.get("m", ())):
                    _set_conv(bm.cv1.conv, bp["cv1"])
                    _set_conv(bm.cv2.conv, bp["cv2"])
            elif kind == "detect":
                for conv, hp in zip(mod.m, p["m"]):
                    _set_conv(conv, hp)
                mod.anchors.copy_(torch.tensor(
                    np.asarray(p["anchors"], np.float32)))
    return model.eval().to(dev)


def init_params(spec, seed: int = 0, device=None) -> YoloV5:
    """Random (BN-fused form) graph for `spec` on `device` (CUDA unless
    given); one seed gives the JAX package's `init_params(spec, seed)`
    weights."""
    return model_from_params(spec, init_param_tree(spec, seed), device)


# ---------------------------------------------------------------------------
# pre/post-processing (host-side numpy)


def letterbox_geometry(in_hw: tuple[int, int], out_hw: tuple[int, int]):
    """(gain, (resized h, w), (left, top)): the letterbox's static
    geometry, rounded as the JAX package's letterbox rounds it."""
    h, w = in_hw
    nh, nw = out_hw
    gain = min(nh / h, nw / w)
    uh, uw = int(round(h * gain)), int(round(w * gain))
    pad = (int(round((nw - uw) / 2 - 0.1)), int(round((nh - uh) / 2 - 0.1)))
    return gain, (uh, uw), pad


def letterbox_tensor(img_chw: torch.Tensor, out_hw: tuple[int, int],
                     color: float = 0.447):
    """[3, H, W] on any device -> ([nh, nw, 3] float32 on that device, gain,
    (pad_w, pad_h)): resize keeping aspect, then pad. The resize is
    antialiased bilinear, as jax.image.resize shrinks an image."""
    gain, (uh, uw), (left, top) = letterbox_geometry(
        tuple(img_chw.shape[1:]), out_hw)
    resized = F.interpolate(img_chw[None], (uh, uw),
                            mode="bilinear", align_corners=False,
                            antialias=True)[0]
    out = torch.full((3, *out_hw), color, dtype=torch.float32,
                     device=img_chw.device)
    out[:, top:top + uh, left:left + uw] = resized
    return out.permute(1, 2, 0), gain, (left, top)


def letterbox(img: np.ndarray, new_shape=(640, 640), color=0.447
              ) -> tuple[np.ndarray, float, tuple[float, float]]:
    """Host form of `letterbox_tensor`: img [H, W, 3] float in [0,1] ->
    (image [nh, nw, 3], gain, (pad_w, pad_h))."""
    src = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    out, gain, pad = letterbox_tensor(src.permute(2, 0, 1), new_shape,
                                      color)
    return np.ascontiguousarray(out.numpy()), gain, pad


def scale_coords(boxes_xyxy: np.ndarray, gain: float, pad: tuple,
                 orig_hw: tuple) -> np.ndarray:
    """Map boxes from letterboxed coords back to the original image."""
    b = boxes_xyxy.copy()
    b[:, [0, 2]] = (b[:, [0, 2]] - pad[0]) / gain
    b[:, [1, 3]] = (b[:, [1, 3]] - pad[1]) / gain
    b[:, [0, 2]] = b[:, [0, 2]].clip(0, orig_hw[1])
    b[:, [1, 3]] = b[:, [1, 3]].clip(0, orig_hw[0])
    return b


def nms_boxes(xyxy: np.ndarray, conf: np.ndarray, cls: np.ndarray,
              iou_thres=0.45, max_det=300) -> np.ndarray:
    """Greedy per-class NMS over pre-filtered boxes -> [M, 6] (xyxy, conf,
    cls). The shared core of non_max_suppression and the fused pipeline's
    host tail (sim/pipeline.py)."""
    if xyxy.shape[0] == 0:
        return np.zeros((0, 6), np.float32)
    order = conf.argsort()[::-1][:max_det * 4]
    xyxy, conf, cls = xyxy[order], conf[order], cls[order]
    # class offset so that NMS is per class
    off = cls.astype(np.float32) * 7680.0
    shifted = xyxy + off[:, None]
    sel = []
    areas = (shifted[:, 2] - shifted[:, 0]) * (shifted[:, 3] - shifted[:, 1])
    idx = np.arange(len(shifted))
    while idx.size and len(sel) < max_det:
        i = idx[0]
        sel.append(i)
        if idx.size == 1:
            break
        rest = idx[1:]
        x1 = np.maximum(shifted[i, 0], shifted[rest, 0])
        y1 = np.maximum(shifted[i, 1], shifted[rest, 1])
        x2 = np.minimum(shifted[i, 2], shifted[rest, 2])
        y2 = np.minimum(shifted[i, 3], shifted[rest, 3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        iou = inter / (areas[i] + areas[rest] - inter + 1e-9)
        idx = rest[iou <= iou_thres]
    sel = np.asarray(sel, int)
    return np.concatenate(
        [xyxy[sel], conf[sel, None], cls[sel, None].astype(np.float32)],
        axis=1)


def xywh_to_xyxy(boxes: np.ndarray) -> np.ndarray:
    xyxy = np.empty((boxes.shape[0], 4), np.float32)
    xyxy[:, 0] = boxes[:, 0] - boxes[:, 2] / 2
    xyxy[:, 1] = boxes[:, 1] - boxes[:, 3] / 2
    xyxy[:, 2] = boxes[:, 0] + boxes[:, 2] / 2
    xyxy[:, 3] = boxes[:, 1] + boxes[:, 3] / 2
    return xyxy


def non_max_suppression(pred: np.ndarray, conf_thres=0.25, iou_thres=0.45,
                        classes=None, max_det=300) -> np.ndarray:
    """pred [A, 5+nc] (xywh, obj, cls...) -> [M, 6] (xyxy, conf, cls)."""
    obj = pred[:, 4]
    cls_conf = pred[:, 5:] * obj[:, None]
    cls = cls_conf.argmax(1)
    conf = cls_conf.max(1)
    keep = conf > conf_thres
    if classes is not None:
        keep &= np.isin(cls, classes)
    if not keep.any():
        return np.zeros((0, 6), np.float32)
    return nms_boxes(xywh_to_xyxy(pred[keep, :4]), conf[keep], cls[keep],
                     iou_thres, max_det)


# ---------------------------------------------------------------------------
# torch checkpoint conversion (BN fused)


def _fuse(conv_w, bn_w, bn_b, bn_m, bn_v, eps=1e-3):
    scale = bn_w / np.sqrt(bn_v + eps)
    w = conv_w * scale[:, None, None, None]
    b = bn_b - bn_m * scale
    return {"w": w.transpose(2, 3, 1, 0), "b": b}     # OIHW -> HWIO


def load_torch_checkpoint(path: str, num_classes: int = 80, device=None):
    """(spec, graph on `device`, CUDA unless given) from a standard YOLOv5
    checkpoint (.pt with an fp32 state_dict, or the full pickled model),
    BN fused into the conv weights. The checkpoint is unpickled: load only
    files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    sd = model.float().state_dict() if hasattr(model, "state_dict") else {
        k: v.float() for k, v in model.items()}
    sd = {k: v.numpy() for k, v in sd.items()}

    def fused(prefix):
        return _fuse(sd[f"{prefix}.conv.weight"],
                     sd[f"{prefix}.bn.weight"], sd[f"{prefix}.bn.bias"],
                     sd[f"{prefix}.bn.running_mean"],
                     sd[f"{prefix}.bn.running_var"])

    spec = spec_yolov5(num_classes)
    params: list[Any] = []
    for i, lay in enumerate(spec):
        base = f"model.{i}"
        kind = lay["kind"]
        if kind == "conv":
            params.append(fused(base))
        elif kind == "c3":
            params.append({
                "cv1": fused(f"{base}.cv1"),
                "cv2": fused(f"{base}.cv2"),
                "cv3": fused(f"{base}.cv3"),
                "m": [{"cv1": fused(f"{base}.m.{j}.cv1"),
                       "cv2": fused(f"{base}.m.{j}.cv2")}
                      for j in range(lay["n"])],
            })
        elif kind == "sppf":
            params.append({"cv1": fused(f"{base}.cv1"),
                           "cv2": fused(f"{base}.cv2")})
        elif kind == "detect":
            heads = [{"w": sd[f"{base}.m.{j}.weight"].transpose(2, 3, 1, 0),
                      "b": sd[f"{base}.m.{j}.bias"]} for j in range(3)]
            anchors = sd.get(f"{base}.anchors")
            # checkpoint anchors are in strides; the decode wants pixels
            anchors = (DEFAULT_ANCHORS.copy() if anchors is None else
                       anchors * np.asarray(STRIDES, np.float32)[:, None,
                                                                 None])
            params.append({"m": heads, "anchors": anchors})
        else:
            params.append({})
    return spec, model_from_params(spec, params, device)


class YoloDetector:
    """YOLOv5 detector: image [H, W, 3] -> [M, 6] xyxy/conf/cls boxes in
    original-image pixels. Letterbox and NMS on the host, the graph on
    `device` (CUDA unless given). Under a profiler the stages record the
    spans `detector.letterbox` (with the copy to the device),
    `detector.forward` (with the predictions' copy back) and
    `detector.nms`."""

    def __init__(self, spec=None, params=None, size=(384, 640),
                 conf_thres=0.25, iou_thres=0.45,
                 classes=COCO_VEHICLE_PERSON, device=None):
        self.device = resolve_device(device)
        self.spec = spec if spec is not None else spec_yolov5()
        self.params = params if params is not None else init_params(
            self.spec, device=self.device)
        self.size = size
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.classes = np.asarray(classes) if classes is not None else None

    @classmethod
    def from_checkpoint(cls, path: str, device=None, **kw):
        spec, params = load_torch_checkpoint(path, device=device)
        return cls(spec=spec, params=params, device=device, **kw)

    def predict(self, image: np.ndarray):
        """image [H, W, 3] -> (decoded predictions [A, 5 + nc] on the host,
        letterbox gain, pad)."""
        with span("detector.letterbox"):
            boxed, gain, pad = letterbox(image, self.size)
            x = torch.from_numpy(boxed).to(self.device)[None]
        with span("detector.forward"):
            pred = forward(self.spec, self.params, x)[0].cpu().numpy()
        return pred, gain, pad

    def __call__(self, image: np.ndarray) -> np.ndarray:
        h, w = image.shape[:2]
        pred, gain, pad = self.predict(image)
        with span("detector.nms"):
            det = non_max_suppression(pred, self.conf_thres,
                                      self.iou_thres, self.classes)
            if det.shape[0]:
                det[:, :4] = scale_coords(det[:, :4], gain, pad, (h, w))
            return det
