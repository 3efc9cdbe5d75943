"""Single-kernel training input path (K3): int16 dataset rows by index ->
decode -> augment -> MFCC or log-mel features [B, frames, C].

Counterpart of tcresnet_tpu/ops/pallas/frontend.py, all three branches:
the kernel is `csrc/frontend.cu`, in the DFT variant that
`mfcc.kernel_variant` gives (hops and phases, one entry point, as in K2
and K8; radix4 as in K9; a radix4 clip past K9's frames runs hops). K1's
per-sample body (`augment.cuh`) writes
the augmented samples (hops and phases: the sample span of a tile of the
batch's frames, each utterance with its own draws; radix4: the row) into
shared memory and the variant's stage (`dft_tc.cuh`, `radix4.cuh`) turns
them into features, so the augmented wave never reaches device memory.
Each launch takes the launch arguments of the MFCC kernel of its variant
(`mfcc.FrontEnd.launch_args`: K2's and K8's tile plan for the batch).
Its plain version is K1's then the variant's MFCC plain version
(`frontend_reference`); a wrapper takes it only for CPU tensors.

`launches`, `phases_launches` and `radix4_launches` count launches by the
stage that ran (hops, phases, radix4) and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tcresnet_tpu_torch.config import AudioConfig, AugmentConfig
from tcresnet_tpu_torch.ops import augment as aug
from tcresnet_tpu_torch.ops.kernels import _build, mfcc
from tcresnet_tpu_torch.ops.kernels.augment import (
    AugmentScalars,
    _AugArgs,
    augment_reference,
    check_inputs,
    kernel_args,
)

# Kernel launches since import (or since a caller reset them to 0).
launches = 0  # hops
phases_launches = 0
radix4_launches = 0

ENTRIES = {"hops": "k3_frontend", "phases": "k3_frontend", "radix4": "k3_radix4"}
_COUNTERS = {"hops": "launches", "phases": "phases_launches", "radix4": "radix4_launches"}


class _K3Args(ctypes.Structure):
    """Mirror of struct K3Args in csrc/frontend.cu."""

    _fields_ = [("fe", mfcc.FeArgs), ("v", mfcc.FeVariant), ("aug", _AugArgs),
                ("region_a", ctypes.c_int), ("smem_bytes", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _build.bind("frontend", _K3Args, sorted(set(ENTRIES.values())), "k3_args_size",
                       "k3_error_string")


def build_kernels() -> None:
    """Build (if needed) and load the kernel library now, not at first launch."""
    _library()


def frontend_fusable(dataset: torch.Tensor, aug_cfg: AugmentConfig,
                     audio_cfg: AudioConfig, noise_bank: Optional[torch.Tensor],
                     n: int) -> bool:
    """Whether the single-kernel path applies: K1 takes the dataset and
    config, and the front-end kernels the feature geometry (MFCC or
    log-mel, in the stage `mfcc.kernel_variant` picks)."""
    return (aug.gather_fusable(dataset, aug_cfg, noise_bank, n)
            and mfcc.fused_mfcc_available(audio_cfg, n))


def frontend_reference(dataset: torch.Tensor, idx: torch.Tensor, scalars: AugmentScalars,
                       noise_bank: torch.Tensor, audio_cfg: AudioConfig, n: int,
                       quantize: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K3: K1's plain version, then the resolved
    variant's MFCC plain version (K2's, K8's or K9's)."""
    wavs = augment_reference(dataset, idx, scalars, noise_bank, n, quantize)
    return mfcc.fused_mfcc_reference(wavs, audio_cfg)


def frontend_features(dataset: torch.Tensor, idx: torch.Tensor, scalars: AugmentScalars,
                      noise_bank: torch.Tensor, audio_cfg: AudioConfig, n: int,
                      quantize: bool = False) -> torch.Tensor:
    """[rows, S] int16 dataset + idx [B] int32 + the batch's draws ->
    [B, frames, C] f32: K3 in the stage of `mfcc.kernel_variant` for CUDA
    tensors (hops for a radix4 clip past K9's frames), its plain version
    (the resolved variant's) for CPU."""
    if dataset.device.type == "cpu":
        return frontend_reference(dataset, idx, scalars, noise_bank, audio_cfg, n, quantize)
    if dataset.device.type != "cuda":
        raise ValueError(f"no K3 kernel for device type {dataset.device.type!r}")
    check_inputs(dataset, idx, scalars, noise_bank, n)
    if not mfcc.fused_mfcc_available(audio_cfg, n):
        raise ValueError(f"K3 does not serve n={n} with this geometry "
                         f"({audio_cfg.preprocess_method}, window "
                         f"{audio_cfg.window_size_samples}, hop "
                         f"{audio_cfg.window_stride_samples})")
    variant = mfcc.kernel_variant(audio_cfg, n)
    fe = mfcc.front_end(audio_cfg, n, dataset.device, variant)
    g = fe.geom
    out = torch.empty((idx.shape[0], g.frames, g.width), device=dataset.device,
                      dtype=torch.float32)
    if idx.shape[0] == 0:
        return out
    v, region_a, smem, _part = fe.launch_args(idx.shape[0])
    args = _K3Args(fe.args(), v, kernel_args(dataset, idx, scalars, noise_bank, out, n, quantize),
                   region_a, smem)
    _build.launch(_library(), ENTRIES[variant], "k3_error_string", args, dataset.device)
    globals()[_COUNTERS[variant]] += 1
    if variant != "radix4":
        mfcc.count_wgmma(v)
    return out


def fused_gather_augment_mfcc(dataset: torch.Tensor, idx: torch.Tensor,
                              is_silent: torch.Tensor, generator: torch.Generator,
                              aug_cfg: AugmentConfig, audio_cfg: AudioConfig,
                              noise_bank: torch.Tensor, is_training: bool,
                              n: int) -> torch.Tensor:
    """Draw the batch's augmentation scalars and run K3 (callers check
    `frontend_fusable` first)."""
    if not frontend_fusable(dataset, aug_cfg, audio_cfg, noise_bank, n):
        raise ValueError(
            "fused_gather_augment_mfcc requires frontend_fusable(); callers "
            "must check it and fall back")
    scalars = aug.draw_scalars(generator, is_silent, aug_cfg, noise_bank, n, is_training)
    return frontend_features(dataset, idx, scalars, noise_bank, audio_cfg, n,
                             bool(getattr(aug_cfg, "noise_crop_quantize", False)))
