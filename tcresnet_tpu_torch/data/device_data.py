"""Device-resident datasets (counterpart of tcresnet_tpu/data/device_data.py).

The whole decoded split lives on the device as int16 (Speech Commands v1
train with silence: ~0.8 GB), and every train step draws its batch
indices there, so the steady-state input path costs no host work and no
host-to-device copy.

Layout. The JAX package stores rows as [N, P/128, 128] with P the next
power of two, a layout its gather+augment kernel needed for Mosaic DMA
(tcresnet_tpu/ops/pallas/augment.py:22-34). The port's kernel K1
(`csrc/augment.cu`) reads rows at any offset, so rows here are flat:
[N, S] int16 with S the clip length rounded up to 8 samples (16-byte
aligned rows; 16,000 already is). `decode_rows` gives the same float32
values as the JAX function.

Sampling: uniform with replacement per step, through the oversampling map
`sample_row` when there is one. Draws take an explicit `torch.Generator`
on the dataset's device; the trainer seeds it from (seed, step), so a
resumed run draws what an uninterrupted one would. Eval streams are
deterministic index ranges with a pad+mask final batch.

Under data parallelism every rank holds the whole split on its own device
(the JAX package's replicated dataset) and draws the global batch's
indices, keeping its rows (`parallel.mesh.ShardedGenerator`).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from tcresnet_tpu_torch.data.speech_commands import HostDataset
from tcresnet_tpu_torch.parallel import mesh as meshlib
from tcresnet_tpu_torch.utils.device import DeviceLike, resolve_device

Arrays = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

ROW_ALIGN = 8  # int16 samples per 16 bytes


class DeviceDataset:
    """A split on one device, with batch draws that stay on the device."""

    def __init__(self, host: HostDataset, device: DeviceLike):
        self.device = resolve_device(device)
        self.label_names = host.label_names
        self.num_samples = host.num_samples
        self.num_logical_samples = host.num_logical_samples
        self.num_classes = host.num_classes
        self.split = host.split

        n, self.clip_len = host.wavs.shape
        row = self.clip_len + (-self.clip_len % ROW_ALIGN)
        wavs = np.asarray(host.wavs, np.int16)
        if row != self.clip_len:
            wavs = np.pad(wavs, ((0, 0), (0, row - self.clip_len)))

        def put(a, dtype):
            # a decode-cache hit is a read-only memory map: copy it, since
            # a tensor on the CPU would share (and could write) its pages
            a = np.ascontiguousarray(a) if a.flags.writeable else np.array(a, order="C")
            return torch.as_tensor(a, dtype=dtype).to(self.device)

        self.wavs = put(wavs, torch.int16)  # [N, S] int16
        self.labels = put(host.labels, torch.int64)  # [N]
        self.is_silent = put(host.is_silent, torch.bool)  # [N]
        self.noise_bank = (
            put(host.noise_bank, torch.float32) if host.noise_bank is not None else None
        )
        # logical -> physical oversampling map ([M] int32, or None)
        self.sample_row = (
            put(host.sample_row, torch.int32) if host.sample_row is not None else None
        )

    @property
    def arrays(self) -> Arrays:
        return self.wavs, self.labels, self.is_silent

    @staticmethod
    def decode_rows(wavs2d: torch.Tensor, idx: torch.Tensor,
                    clip_len: Optional[int] = None) -> torch.Tensor:
        """[N, S] int16 rows idx -> [B, clip_len] float32 in [-1, 1)."""
        rows = wavs2d[idx.long()]
        if clip_len is not None and clip_len != rows.shape[1]:
            rows = rows[:, :clip_len]
        return rows.to(torch.float32) * (1.0 / 32768.0)

    @staticmethod
    def sample_indices(
        arrays: Arrays, generator: torch.Generator, batch_size: int,
        sample_row: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Uniform-with-replacement batch INDICES, drawn on the device:
        (idx [B] int32, labels [B], is_silent [B]). With `sample_row` the
        draw is uniform over the logical axis and mapped to physical rows.
        From a `ShardedGenerator` that keeps rows, `batch_size` is this
        rank's row count and the rows are those of the global draw."""
        wavs, labels, is_silent = arrays
        if sample_row is not None:
            li = meshlib.draw(generator, lambda m: torch.randint(
                0, sample_row.shape[0], (m,), generator=generator, device=wavs.device),
                batch_size)
            idx = sample_row[li].to(torch.int32)
        else:
            idx = meshlib.draw(generator, lambda m: torch.randint(
                0, wavs.shape[0], (m,), generator=generator, device=wavs.device,
                dtype=torch.int32), batch_size)
        rows = idx.long()
        return idx, labels[rows], is_silent[rows]

    @staticmethod
    def sample_batch(
        arrays: Arrays, generator: torch.Generator, batch_size: int,
        clip_len: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """A drawn batch, decoded: (wavs [B, clip_len] f32, labels, is_silent)."""
        idx, lab, sil = DeviceDataset.sample_indices(arrays, generator, batch_size)
        return DeviceDataset.decode_rows(arrays[0], idx, clip_len), lab, sil

    @staticmethod
    def gather_batch(arrays: Arrays, idx: torch.Tensor,
                     clip_len: Optional[int] = None):
        """An explicit index batch, decoded (deterministic eval)."""
        wavs, labels, is_silent = arrays
        rows = idx.long()
        return DeviceDataset.decode_rows(wavs, idx, clip_len), labels[rows], is_silent[rows]

    def eval_index_batches(self, batch_size: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (indices [B], valid_mask [B]) covering each sample once; the
        final batch is padded with index 0 and mask False."""
        n = self.num_samples
        for start in range(0, n, batch_size):
            stop = min(start + batch_size, n)
            idx = np.arange(start, start + batch_size)
            mask = idx < stop
            idx = np.where(mask, np.minimum(idx, n - 1), 0)
            yield idx.astype(np.int32), mask
