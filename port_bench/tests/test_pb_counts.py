"""The roofline counts against hand-counted cases, and YOLOv5s's FLOPs
against the published figure."""
import math

import pytest
import torch

from port_bench import core
from port_bench.reference import raster, yolo

BLEND = core.roofline("blend_fwd")


def flat_splats(opacities, width=32, height=16, tile=(32, 16)):
    """Gaussians so wide that alpha is the opacity at every pixel, centred
    in one 32x16 tile, at depths 1, 2, ..."""
    n = len(opacities)
    cam = raster.pinhole_camera(torch.eye(4).double().numpy(),
                                math.radians(60), width, height, "cpu")
    means = torch.tensor([[0.0, 0.0, 1.0 + i] for i in range(n)])
    scales = torch.full((n, 3), 1e3) * means[:, 2:3]
    quats = torch.tensor([[1.0, 0, 0, 0]] * n)
    op = torch.tensor(opacities)
    colors = torch.rand(n, 3)
    return raster.render(means, scales, quats, op, colors, cam,
                         tile_x=tile[0], tile_y=tile[1],
                         bg=torch.zeros(3), count=True)


def test_one_gaussian_counts_every_pixel_once():
    _, c = flat_splats([0.5])
    assert (c.pairs, c.live_pair_pixels, c.pixels) == (1, 512, 512)
    assert BLEND.ops(c) == 21 * 512
    assert BLEND.bytes_moved(c) == 4 * (10 * 1 + 5 * 512)


def test_the_stopping_pair_counts_and_what_follows_does_not():
    # T after each pair: 0.05, 0.0025, 1.25e-4; the fourth would take it
    # to 6.25e-6 < 1e-4, so the pixel stops there: four pairs met, three
    # colour it, the fifth is never met
    img, c = flat_splats([0.95] * 5)
    assert c.live_pair_pixels == 4 * 512
    assert c.pairs == 3
    assert BLEND.ops(c, s_ch=2) == 25 * 4 * 512
    assert BLEND.bytes_moved(c, s_ch=2) == 4 * (12 * 3 + 7 * 512)


def test_skipped_pairs_are_not_counted():
    # below 1/255 the pair is skipped at every pixel
    _, c = flat_splats([0.5, 0.003])
    assert (c.pairs, c.live_pair_pixels) == (1, 512)


def test_bound_takes_the_larger_of_the_two_limits():
    peaks = {"fp32_flops_per_s": 67e12, "bytes_per_s": 3.35e12}
    c = raster.BlendCounts(pairs=10, live_pair_pixels=10**9, pixels=100)
    assert BLEND.bound_s(c, peaks) == pytest.approx(21e9 / 67e12)
    c = raster.BlendCounts(pairs=10**9, live_pair_pixels=1, pixels=100)
    assert BLEND.bound_s(c, peaks) == pytest.approx(4 * (10e9 + 500)
                                                    / 3.35e12)


def test_yolov5s_flops_match_the_published_figure():
    # Ultralytics' README: YOLOv5s v6.0, 640x640, 16.5 GFLOPs
    lays = yolo.layers(0.33, 0.50, 80)
    assert yolo.conv_flops(lays, 640, 640) == pytest.approx(16.5e9,
                                                            rel=0.01)
    flops = core.roofline("yolov5").flops(dict(
        depth_multiple=0.33, width_multiple=0.5, num_classes=80,
        input_hw=[384, 640]))
    assert flops == yolo.conv_flops(lays, 384, 640)
