"""The training step's draws, from (seed, step) alone.

A step draws from one device generator seeded with
((seed mod 2^32) << 32) | step, in this order: the batch's rows (uniform,
with replacement), the augmentation scalars (time shift in [-T, T) with
T = samples * shift_ratio, noise clip, crop offset, background gate and
volume), then the dropout mask of the pooled features. The same calls on
the same generator give the same values on any device of one kind.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Draws(NamedTuple):
    rows: torch.Tensor  # [B] int32
    shifts: torch.Tensor  # [B] int32
    clips: torch.Tensor  # [B] int32
    offs: torch.Tensor  # [B] int32
    vols: torch.Tensor  # [B] float32
    generator: torch.Generator  # positioned after the augmentation draws


def step_generator(seed: int, step: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)) & 0xFFFFFFFFFFFFFFFF)
    return g


def draw_step(seed: int, step: int, batch: int, num_rows: int, augment: dict,
              noise_clips: int, noise_len: int, samples: int, device) -> Draws:
    """The rows and augmentation scalars of one step (`augment` is a
    configuration file's `augment` section)."""
    g = step_generator(seed, step, device)

    def randint(lo, hi):
        return torch.randint(lo, hi, (batch,), generator=g, device=device, dtype=torch.int32)

    rows = randint(0, num_rows)
    max_shift = int(samples * augment["shift_ratio"])
    if augment["method"] == "anchored_slice_or_pad_with_shift" and max_shift > 0:
        shifts = randint(-max_shift, max_shift)
    else:
        shifts = torch.zeros(batch, dtype=torch.int32, device=device)
    clips = randint(0, noise_clips)
    offs = randint(0, noise_len - samples + 1)
    gate = torch.rand((batch,), generator=g, device=device) < augment["background_frequency"]
    vol = torch.rand((batch,), generator=g, device=device) * augment["background_max_volume"]
    vols = torch.where(gate, vol, 0.0)
    if not augment["naive_background_mix"]:
        raise NotImplementedError("the reference draws the naive background mix only")
    return Draws(rows, shifts, clips, offs, vols, g)


def dropout_keep(generator: torch.Generator, shape, keep_prob: float, device) -> torch.Tensor:
    """The dropout mask: a unit is kept where a uniform draw is below keep_prob."""
    return torch.rand(shape, generator=generator, device=device) < keep_prob
