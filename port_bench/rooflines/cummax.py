"""Kernel A (`csrc/cummax.cu`), the fused running max over k int32 arrays
of P elements: each element read once and written once, 8 bytes, and one
max. P counts every slot of each array (the binning's pair capacity,
zero-padded to a multiple of 65536), those of inactive Gaussians and of
no pair included: the kernel reads them all."""


def bytes_moved(elements: float) -> float:
    return 8.0 * elements


def ops(elements: float) -> float:
    return float(elements)


def bound_s(elements: float, peaks: dict) -> float:
    """The least time the card could take on `elements` (k * P)."""
    return max(ops(elements) / peaks["fp32_flops_per_s"],
               bytes_moved(elements) / peaks["bytes_per_s"])
