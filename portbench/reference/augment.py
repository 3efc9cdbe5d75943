"""Training augmentation of dataset rows (the reference recipe's
anchored_slice_or_pad_with_shift with the naive background mix):

    out[b, t] = clip(keep_b * x_b[t - shift_b] + vol_b * noise[clip_b, off_b + t], -1, 1)

with x the int16 row decoded by 2^-15, zero outside the clip, and keep 0 for
silence rows.
"""

from __future__ import annotations

import torch


def augment_rows(dataset: torch.Tensor, silent: torch.Tensor, noise: torch.Tensor,
                 rows: torch.Tensor, shifts: torch.Tensor, clips: torch.Tensor,
                 offs: torch.Tensor, vols: torch.Tensor, samples: int) -> torch.Tensor:
    """[N, S] int16 dataset, [N] bool silence flags, [K, L] float32 noise
    bank and one batch's draws -> [B, samples] float32."""
    r = rows.long()
    x = dataset[r, :samples].to(torch.float32) * (1.0 / 32768.0)
    t = torch.arange(samples, device=x.device)
    src = t[None, :] - shifts.long()[:, None]
    inside = (src >= 0) & (src < samples)
    shifted = torch.where(inside, x.gather(1, src.clamp(0, samples - 1)), 0.0)
    keep = torch.where(silent[r], 0.0, 1.0)
    crop = noise[clips.long()[:, None], offs.long()[:, None] + t[None, :]]
    return torch.clamp(shifted * keep[:, None] + vols[:, None] * crop, -1.0, 1.0)
