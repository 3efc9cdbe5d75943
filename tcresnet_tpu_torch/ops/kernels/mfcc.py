"""Fused MFCC / log-mel front end: wav [B, n] -> features [B, frames, C].

Counterpart of tcresnet_tpu/ops/pallas/mfcc.py (kernel K2, hops variant).
The kernel is `csrc/mfcc.cu`; its spectral code is `csrc/frontend.cuh`,
shared with K3 (`frontend.cu`) and K4 (`infer.cu`). Their source notes
say what bounds them on the H100. This module:

- lays the front end's constants out for the kernels and keeps them on
  the device, once per (audio config, clip length, device)
  (`front_end` -> `FrontEnd`, the ctypes mirror of `FeArgs`);
- holds the kernel's plain PyTorch version (`fused_mfcc_reference`),
  which is the port's plain front end (`ops/dsp.py`);
- dispatches (`fused_mfcc`): a CPU tensor goes to the plain version, a
  CUDA tensor to the kernel, anything else raises.

`launches` counts kernel launches and nothing else.

The JAX package's `dft_variant` picks the in-kernel DFT decomposition;
"auto" and "hops" resolve to this kernel. "phases" (K8) and "radix4" (K9)
are not ported and raise NotImplementedError (ROADMAP.md Queue 2).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from tcresnet_tpu_torch.config import AudioConfig
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.ops.kernels import _build

# Kernel launches since import (or since a caller reset it to 0).
launches = 0

SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use

# "auto" (dsp_backend, frontend_fuse) takes the front-end kernels from this
# batch on: the JAX package's threshold, measured on a TPU. The H100
# crossover is in PERF.md; changing the threshold is a later change.
AUTO_MIN_BATCH = 2048


def resolve_dft_variant(cfg: AudioConfig) -> str:
    """cfg.dft_variant for the kernels: "auto" and "hops" are this kernel;
    the phase-grouped (K8) and radix-4 (K9) kernels are not ported."""
    variant = getattr(cfg, "dft_variant", "auto")
    if variant in ("auto", "hops"):
        return "hops"
    if variant == "phases":
        raise NotImplementedError(
            "dft_variant='phases' needs the phase-grouped DFT kernel, which is "
            "not ported yet (ROADMAP.md Queue 2 row K8)")
    if variant == "radix4":
        raise NotImplementedError(
            "dft_variant='radix4' needs the radix-4 DFT kernel, which is not "
            "ported yet (ROADMAP.md Queue 2 row K9)")
    raise ValueError(
        f"dft_variant must be 'auto', 'hops', 'phases', or 'radix4'; got {variant!r}")


def interleaved_dft_matrix(window: int, fft_length: int, ncg: int) -> np.ndarray:
    """[window, 4*ncg] windowed real-DFT matrix with columns
    (re_k, im_k, re_k+1, im_k+1) per group; bins past the last are zero."""
    std = dsp.windowed_rdft_matrix(window, fft_length)
    num_bins = fft_length // 2 + 1
    out = np.zeros((window, 2 * ncg, 2), np.float32)
    out[:, :num_bins, 0] = std[:, :num_bins]
    out[:, :num_bins, 1] = std[:, num_bins:]
    return out.reshape(window, 4 * ncg)


class FeArgs(ctypes.Structure):
    """Mirror of struct FeArgs in csrc/frontend.cuh."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("dft", "mel", "dct")]
        + [(f, ctypes.c_int) for f in (
            "n", "window", "hop", "frames", "ncg", "num_bins", "num_mel",
            "num_coef", "magnitude", "round_bf16")]
    )


@dataclasses.dataclass(frozen=True)
class FrontEndGeometry:
    n: int
    window: int
    hop: int
    frames: int
    num_bins: int
    ncg: int  # DFT column groups of 4: (re_k, im_k, re_k+1, im_k+1)
    num_mel: int
    width: int  # feature coefficients per frame
    magnitude: bool

    def regions(self, region_a_floats: int = 0) -> tuple:
        """(region A floats, region B floats) of frontend.cuh's shared-memory
        plan; A at least `region_a_floats`, B 16-byte aligned."""
        a = max(self.n, self.frames * self.num_mel, region_a_floats)
        return a + (-a % 4), self.frames * 2 * self.ncg


def front_end_geometry(cfg: AudioConfig, n: int) -> FrontEndGeometry:
    window, hop = cfg.window_size_samples, cfg.window_stride_samples
    num_bins = dsp.fft_length_for(window) // 2 + 1
    return FrontEndGeometry(
        n, window, hop, dsp.num_frames_for(n, window, hop), num_bins,
        -(-num_bins // 2), cfg.num_mel_bins, dsp.feature_width(cfg),
        cfg.preprocess_method == "log_mel_spectrogram",
    )


def front_end_supported(cfg: AudioConfig, n: int) -> bool:
    """frontend.cuh's conditions: MFCC or log-mel; frames read as 16-byte
    rows (hop and window multiples of 4); the features fit over the power
    spectrum in place (C <= 2 * ncg)."""
    if cfg.preprocess_method not in ("mfcc", "log_mel_spectrogram"):
        return False
    window, hop = cfg.window_size_samples, cfg.window_stride_samples
    if n < window or hop % 4 or window % 4:
        return False
    g = front_end_geometry(cfg, n)
    return g.width <= 2 * g.ncg


def fused_mfcc_available(cfg: AudioConfig, n: int) -> bool:
    """The JAX kernel's condition (hop-decomposable geometry: window % hop
    == 0, n % hop == 0, n >= window; MFCC or log-mel) and this kernel's:
    the shared front end's, and K2's shared-memory plan fits one block."""
    window, hop = cfg.window_size_samples, cfg.window_stride_samples
    if window % hop or n % hop or not front_end_supported(cfg, n):
        return False
    a, b = front_end_geometry(cfg, n).regions()
    return 4 * (a + b) <= SMEM_LIMIT


def auto_takes_kernel(cfg: AudioConfig, device: torch.device, batch: int, n: int) -> bool:
    """The "auto" rule: a CUDA device, batch >= AUTO_MIN_BATCH, and a
    geometry K2 serves (the JAX package's rule with "cuda" for "tpu")."""
    return device.type == "cuda" and batch >= AUTO_MIN_BATCH and fused_mfcc_available(cfg, n)


class FrontEnd:
    """frontend.cuh's constants for one geometry, on one device: the
    interleaved DFT (rounded to bf16 and back for
    dsp_matmul_dtype="bfloat16"), the mel matrix and the DCT (None for
    log-mel). Made once per (config, n, device) by `front_end`; read it,
    never write it."""

    def __init__(self, cfg: AudioConfig, n: int, device: torch.device):
        g = front_end_geometry(cfg, n)
        self.geom = g
        self.device = torch.device(device)
        self.matmul_dtype = dsp.dsp_matmul_dtype(cfg)

        def dev(a):
            return torch.tensor(np.ascontiguousarray(a, np.float32), device=self.device)

        fft_length = dsp.fft_length_for(g.window)
        self.dft = dsp.round_operand(
            dev(interleaved_dft_matrix(g.window, fft_length, g.ncg)), self.matmul_dtype)
        self.mel = dev(dsp.linear_to_mel_weight_matrix(*dsp.mel_args(cfg)))
        self.dct = None if g.magnitude else dev(
            dsp.dct_ii_matrix(cfg.num_mel_bins, cfg.num_mfccs))

    def args(self) -> FeArgs:
        g = self.geom
        dct = self.mel if self.dct is None else self.dct
        return FeArgs(
            self.dft.data_ptr(), self.mel.data_ptr(), dct.data_ptr(),
            g.n, g.window, g.hop, g.frames, g.ncg, g.num_bins, g.num_mel,
            g.width, int(g.magnitude), int(self.matmul_dtype == torch.bfloat16),
        )


@functools.lru_cache(maxsize=None)
def front_end(cfg: AudioConfig, n: int, device: torch.device) -> FrontEnd:
    return FrontEnd(cfg, n, device)


class _K2Args(ctypes.Structure):
    """Mirror of struct K2Args in csrc/mfcc.cu."""

    _fields_ = [("fe", FeArgs), ("wavs", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("batch", ctypes.c_int), ("region_a", ctypes.c_int),
                ("smem_bytes", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _build.bind("mfcc", _K2Args, ["k2_mfcc"], "k2_args_size", "k2_error_string")


def build_kernels() -> None:
    """Build (if needed) and load the kernel library now, not at first launch."""
    _library()


def fused_mfcc_reference(wavs: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """Plain PyTorch version of K2: the port's plain front end, [B, frames, C]."""
    if cfg.preprocess_method == "log_mel_spectrogram":
        return dsp.log_mel_spectrogram(wavs, cfg, magnitude_squared=False)
    return dsp.mfcc(wavs, cfg)


def fused_mfcc(wavs: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """[B, n] f32 wavs -> [B, frames, C] MFCC or log-mel: the kernel for a
    CUDA tensor, the plain version for a CPU tensor, an error otherwise."""
    global launches
    resolve_dft_variant(cfg)
    if wavs.dim() != 2:
        raise ValueError(f"wavs must be [B, n], got {list(wavs.shape)}")
    n = wavs.shape[1]
    if wavs.device.type == "cpu":
        return fused_mfcc_reference(wavs, cfg)
    if wavs.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device type {wavs.device.type!r}")
    if wavs.dtype != torch.float32:
        raise TypeError(f"wavs must be float32, got {wavs.dtype}")
    if not wavs.is_contiguous():
        raise ValueError("wavs must be contiguous")
    if not fused_mfcc_available(cfg, n):
        raise ValueError(
            f"K2 does not serve this geometry ({cfg.preprocess_method}, n {n}, "
            f"window {cfg.window_size_samples}, hop {cfg.window_stride_samples})")
    fe = front_end(cfg, n, wavs.device)
    g = fe.geom
    out = torch.empty((wavs.shape[0], g.frames, g.width), device=wavs.device,
                      dtype=torch.float32)
    if wavs.shape[0] == 0:
        return out
    region_a, region_b = g.regions()
    args = _K2Args(fe.args(), wavs.data_ptr(), out.data_ptr(), wavs.shape[0],
                   region_a, 4 * (region_a + region_b))
    _build.launch(_library(), "k2_mfcc", "k2_error_string", args, wavs.device)
    launches += 1
    return out
