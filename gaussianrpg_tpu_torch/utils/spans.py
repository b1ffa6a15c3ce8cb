"""Named host spans, recorded only while a profiler runs.

`span(name)` is a `torch.profiler.record_function` range when
`torch.autograd._profiler_enabled()` (a `torch.profiler.profile`, or
`torch.autograd.profiler.emit_nvtx`, which turns the profiler on and
makes each range an NVTX range), else one shared null context. The
ranges land on the profiler's timeline beside its CUDA records, so they
share the device trace's clock; the profiler keeps them and writes them
out with its trace. Off, a span costs the gate's one call (about a
microsecond), not the range's ~10 us.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A `record_function(name)` range while a profiler runs, else a
    shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
