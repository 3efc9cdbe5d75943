"""Published peaks of the cards the benchmark knows (NVIDIA's data sheet,
SXM part, dense rates without sparsity, at the full 700 W power limit).

The cells' settings are float32 with cuDNN allowed TF32, so the fastest
arithmetic they permit is dense TF32: every roofline and MFU here is taken
against it. A card not in the table reports no roofline or MFU.
"""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
        "memory_bytes": 80e9,
        "power_limit_w": 700.0,
    },
}

PEAK_FLOPS_KEY = "tf32_flops"


def peak(card: str, key: str) -> Optional[float]:
    return PEAKS.get(card, {}).get(key)


def least_seconds(card: str, flops: float, nbytes: float) -> Optional[float]:
    """max(operations / peak, bytes / bandwidth): the least time the card
    can take for the work."""
    f, b = peak(card, PEAK_FLOPS_KEY), peak(card, "hbm_bytes_per_s")
    if not f or not b:
        return None
    return max(flops / f, nbytes / b)
