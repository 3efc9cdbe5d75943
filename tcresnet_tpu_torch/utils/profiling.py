"""Profiling hooks (counterpart of tcresnet_tpu/utils/profiling.py).

`trace(log_dir)` records a `torch.profiler` trace of the code it wraps,
the host's operators and, on a card, its kernels and copies, and writes it
as a Chrome trace (`trace_<pid>.json`, readable in Perfetto or
chrome://tracing) into `log_dir` when the block exits. `annotate(name)`
names a region of that trace (`torch.profiler.record_function`); it costs
a few microseconds of host time when no trace is recording.

The JAX module's `compiled_flops` (XLA's static cost analysis) has no
counterpart here yet.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

import torch


@contextmanager
def trace(log_dir: Optional[str]):
    """A torch.profiler trace of the block, written to `log_dir` on exit
    (also when the block raises); does nothing when log_dir is falsy.
    Yields the profiler, or None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        out = Path(log_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"trace_{os.getpid()}.json"))


def annotate(name: str):
    """A named region of the trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)
