"""Gather + augment kernels: K1 (int16 dataset rows by index) and K6 (an
f32 batch), one CUDA source, `csrc/augment.cu`.

Counterparts of tcresnet_tpu/ops/pallas/augment.py::_kernel_gather (K1)
and ::_kernel (K6). Per output sample both compute

    out[b, t] = clip(keep * x[t - shift] + vol * noise[clip, off + t], -1, 1)

with x[t - shift] zero outside [0, n), `off` rounded down to a multiple
of 1024 under noise_crop_quantize. The kernel's source note says what
bounds it on the H100 (memory) and how its design differs from the TPU
kernel's (no roll decomposition: a shifted read is a coalesced load).

`augment_reference` is the plain PyTorch version of both; a wrapper takes
it only for CPU tensors. The kernels are bit-exact with it: the same
float32 operations in the same order, with no FMA contraction
(`csrc/augment.cuh`).

`k1_launches` and `k6_launches` count kernel launches and nothing else.
The per-row scalars come from `ops/augment.py::draw_scalars` on the
device; their ranges (idx < rows, clip < clips, off <= clip_len - n) are
the draw's guarantee, not checked here (that would cost a host sync).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from tcresnet_tpu_torch.ops.kernels import _build

# Kernel launches since import (or since a caller reset them to 0).
k1_launches = 0
k6_launches = 0

CROP_QUANTUM = 1024  # crop-offset quantum of noise_crop_quantize (AUG_QUANTUM)


class AugmentScalars(NamedTuple):
    """Per-row draws of one augmented batch, all [B] on the device: the
    `_draw_scalars` tuple of the JAX kernels."""

    shifts: torch.Tensor  # int32, signed sample shift
    clips: torch.Tensor  # int32, noise clip
    offs: torch.Tensor  # int32, crop offset in the clip
    vols: torch.Tensor  # float32, background volume
    keeps: torch.Tensor  # float32, 0 for silence rows else 1


class _AugArgs(ctypes.Structure):
    """Mirror of struct AugArgs in csrc/augment.cuh."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in (
            "src", "idx", "shifts", "clips", "offs", "vols", "keeps", "noise", "out")]
        + [("row_stride", ctypes.c_longlong)]
        + [(f, ctypes.c_int) for f in ("batch", "n", "clip_len", "quantize")]
    )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _build.bind("augment", _AugArgs, ["k1_gather_augment", "k6_augment"],
                       "aug_args_size", "aug_error_string")


def build_kernels() -> None:
    """Build (if needed) and load the kernel library now, not at first launch."""
    _library()


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def crop_offsets(offs: torch.Tensor, quantize: bool) -> torch.Tensor:
    """The crop start actually read: `offs`, or rounded down to 1024 samples."""
    offs = offs.long()
    return offs - offs % CROP_QUANTUM if quantize else offs


def time_shift(wavs: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """out[b, t] = wavs[b, t - shifts[b]], zero outside the clip."""
    n = wavs.shape[-1]
    t = torch.arange(n, device=wavs.device)
    s = t[None, :] - shifts.long()[:, None]
    valid = (s >= 0) & (s < n)
    return torch.where(valid, wavs.gather(1, s.clamp(0, n - 1)), 0.0)


def augment_reference(src: torch.Tensor, idx: Optional[torch.Tensor],
                      scalars: AugmentScalars, noise_bank: torch.Tensor, n: int,
                      quantize: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K1 (int16 `src` rows `idx`, decoded by
    2^-15) and K6 (f32 `src`, idx None) -> [B, n] float32."""
    rows = src[idx.long()] if idx is not None else src
    x = rows[:, :n]
    x = x.to(torch.float32) * (1.0 / 32768.0) if x.dtype == torch.int16 else x.float()
    shifted = time_shift(x, scalars.shifts) * scalars.keeps[:, None]
    t = torch.arange(n, device=x.device)
    starts = scalars.clips.long() * noise_bank.shape[1] + crop_offsets(scalars.offs, quantize)
    crop = noise_bank.reshape(-1)[starts[:, None] + t[None, :]]
    return torch.clamp(shifted + scalars.vols[:, None] * crop, -1.0, 1.0)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def check_inputs(src: torch.Tensor, idx: Optional[torch.Tensor], scalars: AugmentScalars,
                 noise_bank: torch.Tensor, n: int) -> None:
    """What the augment body (csrc/augment.cuh) takes, for K1, K6 and K3:
    a contiguous [rows, >= n] source (int16 with idx, else f32), a
    contiguous [B] int32 idx, the five [B] draws, a contiguous
    [clips, >= n] float32 noise bank, all on one device. Raises otherwise."""
    device = src.device
    if src.dtype != (torch.int16 if idx is not None else torch.float32):
        raise TypeError(f"source must be {'int16' if idx is not None else 'float32'}, "
                        f"got {src.dtype}")
    if src.dim() != 2 or not src.is_contiguous() or not 0 < n <= src.shape[1]:
        raise ValueError(f"source must be a contiguous [rows, >= {n}] tensor, "
                         f"got {list(src.shape)}")
    batch = scalars.shifts.shape[0]
    if idx is not None and (idx.device != device or idx.dtype != torch.int32
                            or idx.shape != (batch,) or not idx.is_contiguous()):
        raise ValueError(f"idx must be a contiguous [{batch}] int32 tensor on {device}")
    for name, dtype in (("shifts", torch.int32), ("clips", torch.int32),
                        ("offs", torch.int32), ("vols", torch.float32),
                        ("keeps", torch.float32)):
        t = getattr(scalars, name)
        if t.device != device or t.dtype != dtype or t.shape != (batch,) \
                or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous [{batch}] {dtype} tensor on {device}, "
                f"got {list(t.shape)} {t.dtype} on {t.device}")
    if noise_bank.device != device or noise_bank.dtype != torch.float32 \
            or noise_bank.dim() != 2 or not noise_bank.is_contiguous() \
            or noise_bank.shape[0] == 0 or noise_bank.shape[1] < n:
        raise ValueError(f"noise_bank must be a contiguous [clips, >= {n}] float32 "
                         f"tensor on {device}")


def kernel_args(src: torch.Tensor, idx: Optional[torch.Tensor], scalars: AugmentScalars,
                noise_bank: torch.Tensor, out: torch.Tensor, n: int,
                quantize: bool) -> _AugArgs:
    """struct AugArgs for tensors that passed check_inputs."""
    return _AugArgs(
        src.data_ptr(), idx.data_ptr() if idx is not None else None,
        scalars.shifts.data_ptr(), scalars.clips.data_ptr(), scalars.offs.data_ptr(),
        scalars.vols.data_ptr(), scalars.keeps.data_ptr(), noise_bank.data_ptr(),
        out.data_ptr(), src.shape[1], scalars.shifts.shape[0], n, noise_bank.shape[1],
        int(quantize),
    )


def _launch(entry: str, src: torch.Tensor, idx: Optional[torch.Tensor],
            scalars: AugmentScalars, noise_bank: torch.Tensor, n: int,
            quantize: bool) -> torch.Tensor:
    check_inputs(src, idx, scalars, noise_bank, n)
    batch = scalars.shifts.shape[0]
    if batch > 65535:
        raise ValueError(f"batch {batch} exceeds the grid's 65535 rows")
    out = torch.empty((batch, n), device=src.device, dtype=torch.float32)
    if batch:
        _build.launch(_library(), entry, "aug_error_string",
                      kernel_args(src, idx, scalars, noise_bank, out, n, quantize), src.device)
    return out


def fused_gather_augment(dataset: torch.Tensor, idx: torch.Tensor,
                         scalars: AugmentScalars, noise_bank: torch.Tensor, n: int,
                         quantize: bool = False) -> torch.Tensor:
    """K1: int16 dataset [rows, S] rows `idx` [B] int32 -> augmented [B, n]
    f32. The kernel for CUDA tensors, the plain version for CPU tensors."""
    global k1_launches
    if dataset.device.type == "cpu":
        return augment_reference(dataset, idx, scalars, noise_bank, n, quantize)
    if dataset.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device type {dataset.device.type!r}")
    out = _launch("k1_gather_augment", dataset, idx, scalars, noise_bank, n, quantize)
    if out.shape[0]:
        k1_launches += 1
    return out


def fused_augment(wavs: torch.Tensor, scalars: AugmentScalars,
                  noise_bank: torch.Tensor, quantize: bool = False) -> torch.Tensor:
    """K6: gathered f32 batch [B, n] -> augmented [B, n] f32. The kernel for
    CUDA tensors, the plain version for CPU tensors."""
    global k6_launches
    if wavs.device.type == "cpu":
        return augment_reference(wavs, None, scalars, noise_bank, wavs.shape[-1], quantize)
    if wavs.device.type != "cuda":
        raise ValueError(f"no K6 kernel for device type {wavs.device.type!r}")
    if wavs.dim() != 2 or wavs.shape[0] != scalars.shifts.shape[0]:
        raise ValueError(f"wavs must be [B, n] with B = {scalars.shifts.shape[0]}, "
                         f"got {list(wavs.shape)}")
    out = _launch("k6_augment", wavs, None, scalars, noise_bank, wavs.shape[1], quantize)
    if out.shape[0]:
        k6_launches += 1
    return out
