"""Optimizer and learning-rate schedule (counterpart of
tcresnet_tpu/train/optim.py:22-162).

As in the JAX package the optimizer runs at UNIT learning rate and its
updates are scaled by `schedule(global_step)` (`scale_updates`), so the LR
is a pure function of the step (reference helper/trainer.py:107-137).
The update rules are written by hand to optax's order and initial state
(not torch.optim, whose momentum and epsilon placement differ):

  "gd"  (optax.sgd(1.0))                 u = -g
  "mom" (optax.sgd(1.0, momentum=m))     t = g + m * t  (t0 = 0);  u = -t

"adam" and "rmsprop" come with the model families that use them
(ROADMAP.md Queue 1 item 6); they raise NotImplementedError, as do
trainable_scopes.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

from tcresnet_tpu_torch.config import OptimConfig

Tensors = Dict[str, torch.Tensor]


def piecewise_constant(boundaries: Sequence[int],
                       values: Sequence[float]) -> Callable[[int], float]:
    """tf.train.piecewise_constant: values[0] for step <= boundaries[0],
    values[i] for boundaries[i-1] < step <= boundaries[i], values[-1] after
    (a left-side search over the boundaries). The step is a host integer:
    the trainer knows it without reading the device."""
    if len(values) != len(boundaries) + 1:
        raise ValueError(f"need len(values) == len(boundaries) + 1: {boundaries}, {values}")
    b, v = list(boundaries), [float(x) for x in values]

    def schedule(step: int) -> float:
        return v[bisect.bisect_left(b, int(step))]

    return schedule


def resolve_boundaries(cfg: OptimConfig, num_samples: Optional[int] = None,
                       batch_size: Optional[int] = None, restore_step: int = 0,
                       relative: bool = False) -> tuple:
    """Boundaries in steps: epoch units are (b * num_samples) // batch_size
    (the reference's integer math), optionally shifted by the restore step."""
    boundaries = list(cfg.boundaries)
    if cfg.boundaries_epoch:
        if not num_samples or not batch_size:
            raise ValueError("boundaries_epoch requires num_samples and batch_size")
        boundaries = [(b * num_samples) // batch_size for b in boundaries]
    if relative:
        boundaries = [restore_step + b for b in boundaries]
    return tuple(boundaries)


class UnitOptimizer:
    """A unit-LR optimizer: init(params) -> state; update(grads, state) ->
    (updates, new state). State and updates are {name: tensor} on the
    params' device; update() never reads the device."""

    def __init__(self, name: str, momentum: float = 0.9):
        if name not in ("gd", "mom"):
            raise ValueError(f"Unknown optimizer {name!r}")
        self.name = name
        self.momentum = momentum

    def init(self, params: Mapping[str, torch.Tensor]) -> Tensors:
        if self.name == "gd":
            return {}
        return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}

    def update(self, grads: Mapping[str, torch.Tensor],
               state: Mapping[str, torch.Tensor]):
        if self.name == "gd":
            return {k: -g for k, g in grads.items()}, dict(state)
        trace = {k: g + self.momentum * state[k] for k, g in grads.items()}
        return {k: -t for k, t in trace.items()}, trace


def build_optimizer(cfg: OptimConfig, num_samples: Optional[int] = None,
                    batch_size: Optional[int] = None, restore_step: int = 0,
                    relative: bool = False):
    """(UnitOptimizer, schedule) for `cfg`."""
    if cfg.optimizer in ("adam", "rmsprop"):
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported yet (ROADMAP.md Queue 1 "
            "item 6: it comes with the Res / DS-CNN / KWS families)")
    if cfg.trainable_scopes:
        raise NotImplementedError(
            "trainable_scopes is not ported yet (ROADMAP.md Queue 1 item 6)")
    boundaries = resolve_boundaries(cfg, num_samples, batch_size, restore_step, relative)
    return UnitOptimizer(cfg.optimizer, cfg.momentum), piecewise_constant(boundaries, cfg.lr_list)


def scale_updates(updates: Mapping[str, torch.Tensor], lr: float) -> Tensors:
    """Scale unit-LR updates by the schedule value for this step."""
    return {k: lr * u for k, u in updates.items()}


def ema_update(ema_params: Mapping[str, torch.Tensor],
               params: Mapping[str, torch.Tensor], decay: float) -> Tensors:
    """TF ExponentialMovingAverage.apply: decay * shadow + (1 - decay) * param."""
    return {k: decay * e + (1.0 - decay) * params[k] for k, e in ema_params.items()}
