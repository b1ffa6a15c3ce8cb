"""The benchmark's inputs, made from `--seed` on the device: a Gaussian
scene with the statistics a configuration states, YOLOv5 weights whose
Detect head is set to find a stated number of objects, and the draws
that order the episodes and pick the frames the check compares.

Each random draw is one large call on a `torch.Generator` of the device
(or one `numpy` generator for host scalars), so one seed gives the same
inputs in every run.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .reference import yolo as ref_yolo


def generators(seed: int, device: torch.device):
    """(device generator, host generator) for one seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen, np.random.default_rng(seed)


def frozen_scene(sc: dict, gen: torch.Generator, device) -> dict:
    """Gaussians laid out as a street (ground, facades, sky) with the
    footprint and opacity statistics of a trained scene, at the camera
    of `sc`. Returns means, scales, quats, opacities, colors (float32)."""
    n = int(sc["gaussians"])
    u = torch.rand((n, 10), generator=gen, device=device)
    z = torch.randn((n, 5), generator=gen, device=device)
    n_g, n_f = int(sc["ground"]["count"]), int(sc["facades"]["count"])

    def span(col, lo_hi, rows):
        lo, hi = lo_hi
        return lo + (hi - lo) * u[rows, col]

    g, f, s = slice(0, n_g), slice(n_g, n_g + n_f), slice(n_g + n_f, n)
    gr, fa, sk = sc["ground"], sc["facades"], sc["sky"]
    side = torch.where(u[f, 2] < 0.5, -1.0, 1.0)
    means = torch.cat([
        torch.stack([span(0, gr["x"], g), gr["y"] + gr["y_sd"] * z[g, 0],
                     span(1, gr["z"], g)], -1),
        torch.stack([side * span(0, fa["abs_x"], f), span(1, fa["y"], f),
                     span(3, fa["z"], f)], -1),
        torch.stack([span(0, sk["x"], s), span(1, sk["y"], s),
                     span(3, sk["z"], s)], -1)])
    fl = sc["width"] / (2 * math.tan(math.radians(sc["fovx_deg"]) / 2))
    sigma_px = span(4, sc["sigma_px"], slice(None))
    scale = sigma_px * means[:, 2].clamp(min=1.0) / fl
    quats = z[:, 1:5] / z[:, 1:5].norm(dim=1, keepdim=True)
    return dict(means=means.contiguous(),
                scales=scale[:, None].expand(n, 3).contiguous(),
                quats=quats.contiguous(),
                opacities=span(5, sc["opacity"], slice(None)).contiguous(),
                colors=u[:, 6:9].contiguous())


def yolo_weights(yc: dict, gen: torch.Generator, device) -> list:
    """He-normal conv weights and zero biases for every conv of the graph
    (`reference.yolo.conv_shapes` order), from one draw."""
    lays = ref_yolo.layers(yc["depth_multiple"], yc["width_multiple"],
                           yc["num_classes"])
    shapes = ref_yolo.conv_shapes(lays)
    sizes = [co * ci * k * k for co, ci, k, _ in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = [], 0
    for (co, ci, k, _), size in zip(shapes, sizes):
        w = flat[at:at + size].view(co, ci, k, k) * math.sqrt(2.0 / (k * k
                                                                   * ci))
        out.append((w, torch.zeros(co, device=device)))
        at += size
    return out


def calibrate_detect(weights: list, raw: torch.Tensor, yc: dict) -> list:
    """The weights with the three Detect convs rescaled and biased so that
    on the frame whose Detect outputs before the sigmoid are `raw`
    ([A, 5 + nc] rows, `reference.yolo.predict(..., raw=True)`; the view
    where the closed loop's ego stops) every output channel is centred on 0 with the spread
    `yc["detect_logit_sd"]` over all channels, and exactly
    `yc["objects_at_stop"]` rows of a kept class reach the confidence
    threshold: He-normal weights alone leave every confidence near 0.25,
    so nothing would be detected, ranged or braked for."""
    no = yc["num_classes"] + 5
    h, w = yc["input_hw"]
    sizes = [3 * (-(-h // s)) * (-(-w // s)) for s in ref_yolo.STRIDES]
    levels = torch.split(raw.double(), sizes)
    means = [lv.view(-1, 3, no).mean(0) for lv in levels]     # [3, no]
    centred = torch.cat([(lv.view(-1, 3, no) - m).view(-1, no)
                         for lv, m in zip(levels, means)])
    scale = yc["detect_logit_sd"] / float(centred.std())
    logit = centred * scale
    best, cls = torch.sigmoid(logit[:, 5:]).max(1)
    kept = torch.zeros(no - 5, dtype=torch.bool, device=raw.device)
    kept[list(yc["classes"])] = True
    ok = kept[cls] & (best > yc["conf_thres"])
    # the objectness shift that lifts each row over the threshold
    need = torch.sort(torch.logit(yc["conf_thres"] / best[ok])
                      - logit[ok, 4]).values
    n = int(yc["objects_at_stop"])
    shift = float((need[n - 1] + need[n]) / 2)
    out = list(weights[:-3])
    for (wt, _), m in zip(weights[-3:], means):
        b = -scale * m
        b[:, 4] += shift
        out.append((wt * scale, b.reshape(-1).to(wt.dtype)))
    return out
