"""The host-resident split (counterpart of the HostDataset in
tcresnet_tpu/data/speech_commands.py:43).

Only the container is ported here: the Speech Commands discovery, decode
cache and oversampling loader are still to port (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class HostDataset:
    """Decoded, host-resident split: everything device_data needs."""

    wavs: np.ndarray  # [N, S] int16 (silence rows all-zero)
    labels: np.ndarray  # [N] int32
    is_silent: np.ndarray  # [N] bool
    label_names: Tuple[str, ...]
    noise_bank: Optional[np.ndarray]  # [K, L] float32 in [-1, 1), or None
    split: str = ""
    # Logical->physical row map from oversampling: [M] int32 with M >= N,
    # or None (identity). Train sampling draws uniformly over the LOGICAL
    # axis; eval visits each physical row exactly once.
    sample_row: Optional[np.ndarray] = None

    @property
    def num_samples(self) -> int:
        """Physical (unique) row count: the eval universe."""
        return int(self.wavs.shape[0])

    @property
    def num_logical_samples(self) -> int:
        """Sampling-universe size: inflated by oversampling duplicates."""
        if self.sample_row is not None:
            return int(self.sample_row.shape[0])
        return self.num_samples

    @property
    def num_classes(self) -> int:
        return len(self.label_names)
