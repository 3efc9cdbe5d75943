"""Synthetic class-conditional audio (counterpart of
tcresnet_tpu/data/synthetic.py:21-83).

Each class is a distinct tone with random phase, amplitude, vibrato and a
noise floor; the silence class is zero. Trivially learnable, so a few
training steps lower the loss. The arrays are bit-equal to the JAX
package's for the same arguments (tests/test_torch_data.py): the same
numpy draws in the same order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tcresnet_tpu_torch import const
from tcresnet_tpu_torch.data.speech_commands import HostDataset


def make_synthetic_dataset(
    num_samples: int = 4096,
    num_classes: int = 12,
    desired_samples: int = 16000,
    sample_rate: int = 16000,
    seed: int = 0,
    split: str = "train",
    silence_class: Optional[int] = 0,
    noise_clips: int = 4,
) -> HostDataset:
    """A HostDataset of labeled tones: class k (except silence) is a tone
    at 220 * 2^(k/6) Hz with a second harmonic. `silence_class` must be 0
    (where label_names puts `__null__`) or None."""
    if silence_class not in (0, None):
        raise ValueError(
            f"silence_class must be 0 or None, got {silence_class} "
            "(label_names always places __null__ at index 0)"
        )
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_samples).astype(np.int32)
    t = np.arange(desired_samples, dtype=np.float64) / sample_rate

    wavs = np.zeros((num_samples, desired_samples), np.float32)
    for i, k in enumerate(labels):
        if silence_class is not None and k == silence_class:
            continue
        f0 = 220.0 * 2.0 ** (float(k) / 6.0)
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.3, 0.8)
        vib = 1.0 + 0.01 * np.sin(2 * np.pi * rng.uniform(2, 6) * t)
        sig = amp * np.sin(2 * np.pi * f0 * vib * t + phase)
        sig += 0.3 * amp * np.sin(2 * np.pi * 2 * f0 * t + phase)
        sig += rng.normal(0, 0.01, desired_samples)
        wavs[i] = np.clip(sig, -1, 1)

    is_silent = (
        labels == silence_class
        if silence_class is not None
        else np.zeros(num_samples, bool)
    )
    wavs_i16 = (wavs * 32767).astype(np.int16)
    wavs_i16[is_silent] = 0

    label_names = tuple(
        [const.NULL_CLASS_LABEL] + [f"tone{k}" for k in range(1, num_classes)]
    )
    noise_bank = rng.uniform(
        -0.5, 0.5, size=(noise_clips, desired_samples * 2)
    ).astype(np.float32)
    return HostDataset(
        wavs=wavs_i16,
        labels=labels,
        is_silent=is_silent,
        label_names=label_names,
        noise_bank=noise_bank,
        split=split,
    )
