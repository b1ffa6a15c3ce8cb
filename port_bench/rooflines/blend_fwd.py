"""Kernel B (`csrc/blend_fwd.cu`), the front-to-back blend: what it needs
on one frame's inputs, from the reference's `BlendCounts`.

- operations: 21 + 2 S a live pair-pixel (the Gaussian's exponent, the
  opacity test, alpha and its clamp, the transmittance and the stop
  test, the weighted sums of r, g, b, depth and alpha; 2 more a channel
  for each of S extra channels);
- bytes: each (Gaussian, tile) pair that colours a pixel reads its
  projected Gaussian once, in float32: 2D mean, conic (3), opacity,
  colour (3), depth and the S extra channels; each pixel writes its
  r, g, b, depth, alpha and extra planes once. How the port lays the
  rows out is not counted.
"""

FLOATS_PER_PAIR = 10


def ops(counts, s_ch: int = 0) -> float:
    return float((21 + 2 * s_ch) * counts.live_pair_pixels)


def bytes_moved(counts, s_ch: int = 0) -> float:
    return float(4 * ((FLOATS_PER_PAIR + s_ch) * counts.pairs
                      + (5 + s_ch) * counts.pixels))


def bound_s(counts, peaks: dict, s_ch: int = 0) -> float:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory peak."""
    return max(ops(counts, s_ch) / peaks["fp32_flops_per_s"],
               bytes_moved(counts, s_ch) / peaks["bytes_per_s"])
