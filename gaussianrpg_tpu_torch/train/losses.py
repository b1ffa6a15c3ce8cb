"""Training losses: masked L1/L2, PSNR, windowed SSIM.

Counterpart of `gaussianrpg_tpu/train/losses.py`: the SSIM is the 11x11
Gaussian-window formulation (sigma 1.5, k1 0.01, k2 0.03) with a
depthwise `F.conv2d` for the window (the JAX package's depthwise
convolution at HIGHEST precision; keep cuDNN's TF32 off on the card to
compare the two).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.math3d import l1_abs


def l1_loss(pred, gt, mask=None):
    d = l1_abs(pred - gt)
    if mask is None:
        return d.mean()
    m = torch.broadcast_to(mask, d.shape).to(d.dtype)
    return torch.sum(d * m) / torch.clamp(torch.sum(m), min=1.0)


def l2_loss(pred, gt, mask=None):
    d = (pred - gt) ** 2
    if mask is None:
        return d.mean()
    m = torch.broadcast_to(mask, d.shape).to(d.dtype)
    return torch.sum(d * m) / torch.clamp(torch.sum(m), min=1.0)


def psnr(pred, gt, mask=None):
    mse = l2_loss(pred, gt, mask)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def _filter2d(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise 2D convolution with same padding; img [C, H, W]."""
    c = img.shape[0]
    k = window.shape[0]
    kernel = window[None, None].expand(c, 1, k, k)
    return F.conv2d(img[None], kernel, padding=k // 2, groups=c)[0]


def ssim(pred, gt, window_size: int = 11):
    """Mean SSIM over [C, H, W] images in [0, 1]."""
    w = _gaussian_window(window_size, 1.5, pred.device)
    mu1 = _filter2d(pred, w)
    mu2 = _filter2d(gt, w)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1_sq = _filter2d(pred * pred, w) - mu1_sq
    sigma2_sq = _filter2d(gt * gt, w) - mu2_sq
    sigma12 = _filter2d(pred * gt, w) - mu12
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()
