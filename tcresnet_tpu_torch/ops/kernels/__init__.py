"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Nothing here imports a CUDA toolchain at import time: a kernel's library
is compiled with nvcc (`_build.py`) the first time a wrapper launches it
on a CUDA tensor.

Each wrapper module counts its kernels' launches in module counters,
which a caller may reset to 0 (`reset_launch_counts`); `launch_counts`
reads them all. `COUNTERS` is the one list of them: a new kernel's
counter is registered there.
"""

from __future__ import annotations

import importlib
from typing import Dict

# kernel -> (module of this package, its launch counter); "plain_routes"
# counts the CUDA batches K2's wrapper sent to the plain feature instead,
# "k5_tables" the op tables K5's plan built (`FusedInfer2D._table`),
# "dft_wgmma" the launches of K2, K8, K3 (hops, phases) and K4 whose tile
# plan took the 128-row product (csrc/dft_wgmma.cuh), "bn" the batch-norm
# kernels (six a training-mode forward and backward), "dw_conv" the
# depthwise conv's (three a forward and backward)
COUNTERS = {
    "k1": ("augment", "k1_launches"),
    "k6": ("augment", "k6_launches"),
    "k2": ("mfcc", "launches"),
    "k8": ("mfcc", "phases_launches"),
    "k9": ("mfcc", "radix4_launches"),
    "k3": ("frontend", "launches"),
    "k3_phases": ("frontend", "phases_launches"),
    "k3_radix4": ("frontend", "radix4_launches"),
    "k7_fwd": ("tconv", "fwd_launches"),
    "k7_dx": ("tconv", "dx_launches"),
    "k7_dw": ("tconv", "dw_launches"),
    "k4": ("infer", "launches"),
    "k5": ("infer2d", "launches"),
    "plain_routes": ("mfcc", "plain_routes"),
    "k5_tables": ("infer2d", "k5_tables"),
    "dft_wgmma": ("mfcc", "wgmma_launches"),
    "bn": ("batchnorm", "launches"),
    "dw_conv": ("dwconv", "launches"),
}


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch counter as it stands: kernel -> launches."""
    return {name: getattr(importlib.import_module(f"{__name__}.{module}"), attr)
            for name, (module, attr) in COUNTERS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for module, attr in COUNTERS.values():
        setattr(importlib.import_module(f"{__name__}.{module}"), attr, 0)


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The kernels launched since `before` (a `launch_counts()`), with their
    launches; a kernel not launched is left out."""
    now = launch_counts()
    return {name: now[name] - before[name] for name in now if now[name] != before[name]}
