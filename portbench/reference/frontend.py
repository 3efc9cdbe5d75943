"""The MFCC front end, as tf.signal computes it in the TF-1.13 recipe.

    frames [B, F, W] (hop H, no end padding)
    -> periodic Hann window and real DFT of length N (next power of two >= W)
    -> power |X|^2 [B, F, N/2 + 1]
    -> HTK mel bank [N/2 + 1, M] (triangles linear in mel, lowest bin zero)
    -> log(mel + 1e-6) -> DCT-II [M, C] scaled by sqrt(2 / M)

The DFT is a dense matrix product over the window's samples, the way an
accelerator's compiler counts it; `fewest_flops` gives the least work the
same transform needs (a real FFT and the nonzero mel weights).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

LOG_OFFSET = 1e-6


@dataclass(frozen=True)
class Geometry:
    sample_rate: int
    samples: int  # clip length
    window: int
    hop: int
    mel_bins: int
    coeffs: int
    lower_hz: float
    upper_hz: float

    @staticmethod
    def from_audio(audio: dict) -> "Geometry":
        """From a configuration file's `audio` section (times in ms)."""
        rate = int(audio["sample_rate"])
        return Geometry(
            sample_rate=rate,
            samples=int(rate * audio["clip_duration_ms"] / 1000),
            window=int(rate * audio["window_size_ms"] / 1000),
            hop=int(rate * audio["window_stride_ms"] / 1000),
            mel_bins=int(audio["num_mel_bins"]),
            coeffs=int(audio["num_mfccs"]),
            lower_hz=float(audio["lower_edge_hertz"]),
            upper_hz=float(audio["upper_edge_hertz"]))

    @property
    def fft(self) -> int:
        return 1 << math.ceil(math.log2(self.window))

    @property
    def bins(self) -> int:
        return self.fft // 2 + 1

    @property
    def frames(self) -> int:
        return 1 + (self.samples - self.window) // self.hop


@functools.lru_cache(maxsize=None)
def dft_matrix(window: int, fft: int) -> np.ndarray:
    """[W, 2K] float64: frames @ M = [Re | Im] of rfft(hann * frame, fft)."""
    n = np.arange(window, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / window)
    angle = 2.0 * np.pi * n[:, None] * np.arange(fft // 2 + 1)[None, :] / fft
    return np.concatenate([hann[:, None] * np.cos(angle), -hann[:, None] * np.sin(angle)], 1)


@functools.lru_cache(maxsize=None)
def mel_matrix(g: Geometry) -> np.ndarray:
    """[K, M] float64, tf.signal.linear_to_mel_weight_matrix."""
    def mel(f):
        return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)

    spec = mel(np.linspace(0.0, g.sample_rate / 2.0, g.bins)[1:])[:, None]
    edges = np.linspace(mel(g.lower_hz), mel(g.upper_hz), g.mel_bins + 2)
    lo, mid, hi = edges[None, :-2], edges[None, 1:-1], edges[None, 2:]
    w = np.maximum(0.0, np.minimum((spec - lo) / (mid - lo), (hi - spec) / (hi - mid)))
    return np.concatenate([np.zeros((1, g.mel_bins)), w], 0)


@functools.lru_cache(maxsize=None)
def dct_matrix(mel_bins: int, coeffs: int) -> np.ndarray:
    """[M, C] float64: sqrt(2 / M) cos(pi k (2n + 1) / 2M)."""
    n = np.arange(mel_bins, dtype=np.float64)[:, None]
    k = np.arange(coeffs, dtype=np.float64)[None, :]
    return np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * mel_bins)) * math.sqrt(2.0 / mel_bins)


def _const(a: np.ndarray, device, dtype) -> torch.Tensor:
    return torch.tensor(a, dtype=torch.float32, device=device).to(dtype)


def mfcc(wavs: torch.Tensor, g: Geometry, dtype=torch.float32) -> torch.Tensor:
    """[B, samples] float32 -> [B, frames, coeffs] float32. The three
    products take operands in `dtype` (the log runs in float32)."""
    device = wavs.device
    idx = torch.arange(g.frames, device=device)[:, None] * g.hop \
        + torch.arange(g.window, device=device)[None, :]
    frames = wavs.to(dtype)[:, idx]
    reim = (frames @ _const(dft_matrix(g.window, g.fft), device, dtype)).float()
    power = reim[..., :g.bins] ** 2 + reim[..., g.bins:] ** 2
    mel = (power.to(dtype) @ _const(mel_matrix(g), device, dtype)).float()
    log_mel = torch.log(mel + LOG_OFFSET)
    return (log_mel.to(dtype) @ _const(dct_matrix(g.mel_bins, g.coeffs), device, dtype)).float()


def fewest_flops(g: Geometry) -> float:
    """The least floating-point work of one clip's features: a real FFT of
    length N per frame (2.5 N log2 N, the usual count), the mel bank's
    nonzero weights and the DCT, each multiply-add two operations."""
    fft = 2.5 * g.fft * math.log2(g.fft)
    mel_nonzero = int(np.count_nonzero(mel_matrix(g)))
    return g.frames * (fft + 2.0 * mel_nonzero + 2.0 * g.mel_bins * g.coeffs)
