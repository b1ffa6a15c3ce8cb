"""Counterpart of `gaussianrpg_tpu.data`."""
