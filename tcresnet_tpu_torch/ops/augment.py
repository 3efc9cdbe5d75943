"""Device-side audio augmentation (counterpart of tcresnet_tpu/ops/augment.py).

Every function is split into a DRAW and an APPLY. The draw takes a
`torch.Generator` on the batch's device and returns the per-row scalars
(`AugmentScalars`: shift, clip, offset, volume, keep) with the
distributions of the JAX kernels' `_draw_scalars`
(tcresnet_tpu/ops/pallas/augment.py:435-452); the apply takes them
explicitly. The JAX package's XLA path and its kernels drew from
different key splits; here one draw feeds both the kernels and their
plain versions, so "xla" and "pallas" give the same batch for the same
generator state. Distributions (reference augmentation_factory.py):

  - time shift: uniform integer in [-T, T), T = int(n * shift_ratio);
    s > 0 delays the audio (zeros in front), s < 0 advances it;
  - background mix, naive version (v1): training rows get volume
    U[0, max_volume) with probability background_frequency, else 0; eval
    rows 0. Version 2: silence rows get U[0, 1), training and eval;
  - crop: a uniform clip, a uniform offset in [0, clip_len - n];
  - silence rows get a zero foreground; the result is clipped to [-1, 1].

Backends (`AugmentConfig.backend`): "pallas" names the port's kernels
(K1 `fused_gather_augment`, K6 `fused_augment`, ops/kernels/augment.py),
"auto" takes them on a CUDA device, "xla" is the plain apply. A kernel
wrapper handed a CPU tensor runs its plain version.

Under data parallelism every draw is the global batch's: a
`parallel.mesh.ShardedGenerator` draws all of the batch's rows and keeps
this rank's, so a rank's scalars are its rows of one process's.
"""

from __future__ import annotations

from typing import Optional

import torch

from tcresnet_tpu_torch.config import AugmentConfig
from tcresnet_tpu_torch.ops.kernels import augment as kernels
from tcresnet_tpu_torch.ops.kernels.augment import (
    AugmentScalars,
    augment_reference,
    time_shift,
)
from tcresnet_tpu_torch.parallel import mesh as meshlib

ANCHORED = ("anchored_slice_or_pad", "anchored_slice_or_pad_with_shift")
METHODS = ANCHORED + ("no_augmentation_audio",)


def _check_method(cfg: AugmentConfig) -> None:
    if cfg.method not in METHODS:
        raise ValueError(f"Unknown augmentation method {cfg.method!r}")


def _uniform(generator: torch.Generator, batch: int, device) -> torch.Tensor:
    return meshlib.draw(generator, lambda m: torch.rand((m,), generator=generator,
                                                        device=device), batch)


def _randint(generator: torch.Generator, low: int, high: int, batch: int,
             device) -> torch.Tensor:
    return meshlib.draw(generator, lambda m: torch.randint(
        low, high, (m,), generator=generator, device=device, dtype=torch.int32), batch)


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------


def draw_shifts(generator: torch.Generator, batch: int, n: int, cfg: AugmentConfig,
                device) -> torch.Tensor:
    """[B] int32 signed shifts, U[-T, T) for the shifting method, else 0."""
    max_shift = int(n * cfg.shift_ratio)
    if cfg.method == "anchored_slice_or_pad_with_shift" and max_shift > 0:
        return _randint(generator, -max_shift, max_shift, batch, device)
    return torch.zeros((batch,), dtype=torch.int32, device=device)


def draw_background_volumes(generator: torch.Generator, is_silent: torch.Tensor,
                            cfg: AugmentConfig, is_training: bool) -> torch.Tensor:
    """[B] float32 background volumes, both reference versions."""
    batch, device = is_silent.shape[0], is_silent.device
    if is_training:
        gate = _uniform(generator, batch, device) < cfg.background_frequency
        vol = _uniform(generator, batch, device) * cfg.background_max_volume
        fore = torch.where(gate, vol, 0.0)
    else:
        fore = torch.zeros((batch,), dtype=torch.float32, device=device)
    if getattr(cfg, "naive_background_mix", True):
        return fore
    return torch.where(is_silent, _uniform(generator, batch, device), fore)


def draw_scalars(generator: torch.Generator, is_silent: torch.Tensor,
                 cfg: AugmentConfig, noise_bank: torch.Tensor, n: int,
                 is_training: bool) -> AugmentScalars:
    """The per-row draws of one batch, on is_silent's device."""
    batch, device = is_silent.shape[0], is_silent.device
    num_clips, clip_len = noise_bank.shape
    if clip_len < n:
        # tf.random_crop's requirement: a crop of the wav length must exist
        raise ValueError(
            f"noise clips ({clip_len} samples) shorter than wavs ({n}); "
            "crops require clip_len >= num_samples")
    shifts = draw_shifts(generator, batch, n, cfg, device)
    clips = _randint(generator, 0, num_clips, batch, device)
    offs = _randint(generator, 0, clip_len - n + 1, batch, device)
    vols = draw_background_volumes(generator, is_silent, cfg, is_training)
    keeps = torch.where(is_silent, 0.0, 1.0).to(torch.float32)
    return AugmentScalars(shifts, clips, offs, vols, keeps)


# ---------------------------------------------------------------------------
# applies
# ---------------------------------------------------------------------------


def zero_silence(wavs: torch.Tensor, is_silent: torch.Tensor) -> torch.Tensor:
    return torch.where(is_silent[:, None], 0.0, wavs)


def use_kernels(cfg: AugmentConfig, device: torch.device) -> bool:
    """Whether `backend` selects the kernels: "pallas" always (a CPU tensor
    then runs their plain version), "auto" on a CUDA device."""
    backend = getattr(cfg, "backend", "auto")
    if backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"Unknown augment backend {backend!r}")
    return backend == "pallas" or (backend == "auto" and device.type == "cuda")


def _mixes(cfg: AugmentConfig, noise_bank: Optional[torch.Tensor]) -> bool:
    return cfg.method in ANCHORED and noise_bank is not None and noise_bank.shape[0] > 0


def augment_batch(wavs: torch.Tensor, is_silent: torch.Tensor,
                  generator: torch.Generator, cfg: AugmentConfig,
                  noise_bank: Optional[torch.Tensor], is_training: bool) -> torch.Tensor:
    """The plain augmentation dispatch (augmentation_factory.py:161-211):

      no_augmentation_audio            -> silence zeroing only
      anchored_slice_or_pad            -> silence zeroing + background mix
      anchored_slice_or_pad_with_shift -> + random time shift first
    """
    _check_method(cfg)
    wavs = wavs.to(torch.float32)
    if cfg.method == "no_augmentation_audio":
        return zero_silence(wavs, is_silent)
    n = wavs.shape[-1]
    if not _mixes(cfg, noise_bank):
        shifts = draw_shifts(generator, wavs.shape[0], n, cfg, wavs.device)
        return zero_silence(time_shift(wavs, shifts), is_silent)
    scalars = draw_scalars(generator, is_silent, cfg, noise_bank, n, is_training)
    return augment_reference(wavs, None, scalars, noise_bank, n,
                             bool(getattr(cfg, "noise_crop_quantize", False)))


def augment(wavs: torch.Tensor, is_silent: torch.Tensor, generator: torch.Generator,
            cfg: AugmentConfig, noise_bank: Optional[torch.Tensor],
            is_training: bool) -> torch.Tensor:
    """Backend-dispatching augmentation of a gathered [B, n] batch: K6
    when the backend selects the kernels and the method mixes noise,
    else the plain dispatch (which raises for an unknown method)."""
    if not (use_kernels(cfg, wavs.device) and _mixes(cfg, noise_bank)
            and noise_bank.shape[1] >= wavs.shape[-1]):
        return augment_batch(wavs, is_silent, generator, cfg, noise_bank, is_training)
    n = wavs.shape[-1]
    scalars = draw_scalars(generator, is_silent, cfg, noise_bank, n, is_training)
    return kernels.fused_augment(wavs.to(torch.float32).contiguous(), scalars, noise_bank,
                                 bool(getattr(cfg, "noise_crop_quantize", False)))


def gather_fusable(dataset: torch.Tensor, cfg: AugmentConfig,
                   noise_bank: Optional[torch.Tensor], n: int) -> bool:
    """Whether K1 takes this dataset and config: the int16 [rows, S]
    device layout with S >= n, one of the two anchored methods (an unknown
    method must reach the plain dispatch, which raises), and a noise bank
    whose clips cover n samples."""
    return (
        dataset.dim() == 2
        and dataset.dtype == torch.int16
        and n <= dataset.shape[1]
        and _mixes(cfg, noise_bank)
        and noise_bank.shape[1] >= n
    )


def augment_gathered(dataset: torch.Tensor, idx: torch.Tensor, is_silent: torch.Tensor,
                     generator: torch.Generator, cfg: AugmentConfig,
                     noise_bank: Optional[torch.Tensor], is_training: bool,
                     clip_len: int) -> torch.Tensor:
    """Gather + decode + augment over the device-resident dataset. K1 when
    the backend selects the kernels and `gather_fusable` holds; otherwise
    the rows are decoded and go through `augment` (K6 or plain)."""
    if use_kernels(cfg, dataset.device) and gather_fusable(dataset, cfg, noise_bank, clip_len):
        scalars = draw_scalars(generator, is_silent, cfg, noise_bank, clip_len, is_training)
        return kernels.fused_gather_augment(
            dataset, idx, scalars, noise_bank, clip_len,
            bool(getattr(cfg, "noise_crop_quantize", False)))
    from tcresnet_tpu_torch.data.device_data import DeviceDataset

    wavs = DeviceDataset.decode_rows(dataset, idx, clip_len)
    return augment(wavs, is_silent, generator, cfg, noise_bank, is_training)
