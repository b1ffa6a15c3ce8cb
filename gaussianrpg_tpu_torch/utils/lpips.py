"""LPIPS (Learned Perceptual Image Patch Similarity) as a PyTorch module.

Counterpart of `gaussianrpg_tpu/utils/lpips.py` (reference
`lib/utils/lpipsPyTorch/`): a frozen conv backbone (AlexNet or VGG16
features) in NCHW through `nn.Conv2d` and `F.max_pool2d`,
channel-unit-normalized activations at five tap points, squared
differences reduced by the 1x1 "lin" weights, spatial mean, sum over taps.

Weights: `init_params(spec, seed)` draws the JAX package's random numbers
(so both packages hold the same weights in tests), `params_from_jax`
carries a JAX parameter tree across (HWIO -> OIHW), and
`load_torch_lpips` reads torchvision `features.{i}` and richzhang
`lin{k}` state dicts straight into the module; `save_torch_lpips`
writes parameters in those layouts.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .device import resolve_device

# (out_ch, kernel, stride, pad) conv entries; pool markers placed BEFORE
# the next conv (torchvision .features order): "M" = alexnet
# MaxPool2d(3, 2), "P" = vgg16 MaxPool2d(2, 2); taps after each ReLU
ALEX_SPEC = {
    "convs": [(64, 11, 4, 2), "M", (192, 5, 1, 2), "M", (384, 3, 1, 1),
              (256, 3, 1, 1), (256, 3, 1, 1)],
    "channels": [64, 192, 384, 256, 256],   # lpipsPyTorch networks.py:82
}
VGG16_SPEC = {
    # taps after relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
    # (lpipsPyTorch networks.py:92-94 target_layers [4, 9, 16, 23, 30])
    "convs": [(64, 3, 1, 1), (64, 3, 1, 1, "T"), "P",
              (128, 3, 1, 1), (128, 3, 1, 1, "T"), "P",
              (256, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1, "T"), "P",
              (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1, "T"), "P",
              (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1, "T")],
    "channels": [64, 128, 256, 512, 512],
}

# input z-score constants (networks.py:41-44; input in [-1, 1])
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _convs(spec) -> list:
    return [e for e in spec["convs"] if e not in ("M", "P")]


def _tap_after(spec) -> list:
    """Indices of conv entries whose ReLU output is a tap point."""
    convs = _convs(spec)
    if spec is ALEX_SPEC or len(spec["channels"]) == len(convs):
        return list(range(len(convs)))      # alex: every conv is a tap
    return [i for i, e in enumerate(convs) if len(e) == 5 and e[4] == "T"]


def init_params(spec, seed: int = 0) -> dict:
    """Random conv + lin parameters, the same numbers as the JAX
    package's `init_params(spec, seed)`: {"convs": [(weight [O, I, K, K],
    bias [O])], "lins": [[C]]}, CPU float32 tensors."""
    rng = np.random.default_rng(seed)
    convs = []
    cin = 3
    for cout, k, *_ in _convs(spec):
        w = (rng.standard_normal((k, k, cin, cout))
             / np.sqrt(k * k * cin)).astype(np.float32)
        convs.append((torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                      torch.zeros(cout)))
        cin = cout
    lins = [torch.from_numpy(np.abs(rng.standard_normal((c,))
                                    .astype(np.float32)) * 0.1)
            for c in spec["channels"]]
    return {"convs": convs, "lins": lins}


def params_from_jax(jparams) -> dict:
    """A JAX LPIPS parameter tree (HWIO conv weights) as this module's
    parameters (OIHW)."""
    return {"convs": [(torch.from_numpy(np.asarray(w, np.float32)
                                        .transpose(3, 2, 0, 1).copy()),
                       torch.from_numpy(np.asarray(b, np.float32).copy()))
                      for w, b in jparams["convs"]],
            "lins": [torch.from_numpy(np.asarray(lin, np.float32).copy())
                     for lin in jparams["lins"]]}


class LPIPS(nn.Module):
    """The LPIPS network of `spec` with `params` (`init_params` layout; None
    draws `init_params(spec, 0)`). `forward(x, y)`: [3, H, W] or
    [N, 3, H, W] in [-1, 1] -> [] or [N]."""

    def __init__(self, spec, params: dict | None = None):
        super().__init__()
        self.spec = spec
        if params is None:
            params = init_params(spec)
        self.convs = nn.ModuleList()
        cin = 3
        for (cout, k, s, p, *_), (w, b) in zip(_convs(spec),
                                               params["convs"]):
            conv = nn.Conv2d(cin, cout, k, stride=s, padding=p)
            with torch.no_grad():
                conv.weight.copy_(w)
                conv.bias.copy_(b)
            self.convs.append(conv)
            cin = cout
        for k, lin in enumerate(params["lins"]):
            self.register_buffer(f"lin{k}", torch.as_tensor(lin).reshape(-1))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1,
                                                                   1))
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1,
                                                                   1))
        self.requires_grad_(False)

    def features(self, x: torch.Tensor) -> list:
        """Backbone taps of x [N, 3, H, W] in [-1, 1]: channel-unit
        normalized activations [N, C, H', W'] (networks.py:52-62 +
        utils.py normalize_activation)."""
        x = (x - self.shift) / self.scale
        taps = set(_tap_after(self.spec))
        out = []
        ci = 0
        for e in self.spec["convs"]:
            if e in ("M", "P"):
                # VALID pools, floor output size (torch MaxPool2d)
                x = (F.max_pool2d(x, 3, 2) if e == "M"
                     else F.max_pool2d(x, 2, 2))
                continue
            x = F.relu(self.convs[ci](x))
            if ci in taps:
                norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
                out.append(x / (norm + 1e-10))
            ci += 1
        return out

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            return self.forward(x[None], y[None])[0]
        total = 0.0
        for k, (a, b) in enumerate(zip(self.features(x), self.features(y))):
            lin = getattr(self, f"lin{k}")
            d = torch.einsum("nchw,c->nhw", (a - b) ** 2, lin)
            total = total + d.mean(dim=(1, 2))
        return total


def lpips_fn(net_type: str = "alex", params=None, device=None):
    """(x, y) [3, H, W] in [0, 1] -> scalar distance, on `device` (CUDA
    unless given); applies the [0, 1] -> [-1, 1] map the torch lpips
    package expects."""
    spec = ALEX_SPEC if net_type == "alex" else VGG16_SPEC
    net = LPIPS(spec, params).to(resolve_device(device))

    def fn(x, y):
        with torch.no_grad():
            return net(x * 2.0 - 1.0, y * 2.0 - 1.0)

    return fn


def load_torch_lpips(backbone_path: str, lin_path: str,
                     net_type: str = "alex", device=None) -> LPIPS:
    """The LPIPS module of torch checkpoints, on `device` (CUDA unless
    given). backbone_path: torchvision alexnet/vgg16 state_dict — keys
    `features.{i}.weight/bias`; lin_path: richzhang lpips lin weights
    (v0.1 alex.pth / vgg.pth) — keys `lin{k}.model.1.weight` [1, C, 1, 1]
    (or `{k}.1.weight`, `lin{k}.weight`)."""
    spec = ALEX_SPEC if net_type == "alex" else VGG16_SPEC
    dev = resolve_device(device)
    sd = torch.load(backbone_path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    conv_idx = sorted({int(k.split(".")[1]) for k in sd
                       if k.startswith("features.")
                       and k.endswith(".weight")})
    convs = [(sd[f"features.{i}.weight"].float(),
              sd[f"features.{i}.bias"].float()) for i in conv_idx]
    ld = torch.load(lin_path, map_location="cpu")
    lins = []
    for k in range(len(spec["channels"])):
        for key in (f"lin{k}.model.1.weight", f"{k}.1.weight",
                    f"lin{k}.weight"):
            if key in ld:
                lins.append(ld[key].float().reshape(-1))
                break
        else:
            raise KeyError(f"lin weights for tap {k} not found in "
                           f"{lin_path}")
    return LPIPS(spec, {"convs": convs, "lins": lins}).to(dev)


def save_torch_lpips(spec, params: dict, backbone_path: str,
                     lin_path: str) -> None:
    """Write `params` (`init_params` layout) as the files
    `load_torch_lpips` reads: a torchvision `features.{i}` state dict (a
    conv and its ReLU take two module indices, a pool one) and richzhang
    `lin{k}.model.1.weight` [1, C, 1, 1]."""
    sd, i = {}, 0
    convs = iter(params["convs"])
    for e in spec["convs"]:
        if e in ("M", "P"):
            i += 1
            continue
        sd[f"features.{i}.weight"], sd[f"features.{i}.bias"] = next(convs)
        i += 2
    torch.save(sd, backbone_path)
    torch.save({f"lin{k}.model.1.weight": torch.as_tensor(lin).reshape(
        1, -1, 1, 1) for k, lin in enumerate(params["lins"])}, lin_path)
