"""Host-side WAV decoding (PCM16) in numpy (counterpart of
tcresnet_tpu/data/wav.py:28-85).

Wavs are decoded once, when a split is loaded; the decoded int16 samples
then live on the device for the whole run (`data/device_data.py`), and
the float32 scale (/32768, decode_wav's normalisation) is applied on the
gather. desired_samples crops or zero-pads; a multi-channel file gives
its first channel. The C++ batch decoder (`data/native_loader.py`) is
the fast path; this one is its fallback and its oracle.
"""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def decode_wav_int16(
    path, desired_samples: Optional[int] = None,
    expected_rate: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """Decode a PCM16 WAV file to int16 samples (first channel).

    Returns (samples[int16], sample_rate). Crops or zero-pads to
    `desired_samples` when given. `expected_rate` (when given) rejects a
    file whose header rate differs: wrong-rate audio through a fixed-rate
    front end gives features of the wrong time and frequency geometry.
    """
    with wave.open(str(path), "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        rate = w.getframerate()
        n_frames = w.getnframes()
        if sampwidth != 2:
            raise ValueError(f"{path}: only PCM16 wavs supported, got width {sampwidth}")
        if expected_rate is not None and rate != expected_rate:
            raise ValueError(f"{path}: sample rate {rate} != expected {expected_rate}")
        raw = w.readframes(n_frames)

    samples = np.frombuffer(raw, dtype="<i2")
    if n_channels > 1:
        samples = samples[::n_channels]

    if desired_samples is not None and desired_samples >= 0:
        if samples.shape[0] >= desired_samples:
            samples = samples[:desired_samples]
        else:
            samples = np.pad(samples, (0, desired_samples - samples.shape[0]))
    return np.ascontiguousarray(samples), rate


def decode_wav_float32(
    path, desired_samples: Optional[int] = None,
    expected_rate: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """decode_wav parity: float32 in [-1, 1) via /32768."""
    samples, rate = decode_wav_int16(path, desired_samples, expected_rate)
    return samples.astype(np.float32) / 32768.0, rate


def write_wav_pcm16(path, samples: np.ndarray, sample_rate: int = 16000) -> None:
    """Write a mono PCM16 WAV (float samples are clipped to [-1, 1) and
    scaled by 32768; int16 samples are written as they are)."""
    samples = np.asarray(samples)
    if samples.dtype != np.int16:
        samples = np.clip(samples, -1.0, 1.0 - 1.0 / 32768)
        samples = (samples * 32768.0).astype(np.int16)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(samples.astype("<i2").tobytes())
