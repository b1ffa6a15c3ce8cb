"""Counterpart of `gaussianrpg_tpu.config`."""
