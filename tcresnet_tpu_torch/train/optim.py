"""Optimizer and learning-rate schedule (counterpart of
tcresnet_tpu/train/optim.py:22-162).

As in the JAX package the optimizer runs at UNIT learning rate and its
updates are scaled by `schedule(global_step)` (`scale_updates`), so the LR
is a pure function of the step (reference helper/trainer.py:107-137).
The update rules are written by hand to optax's order and initial state
(not torch.optim, whose momentum and epsilon placement differ):

  "gd"      (optax.sgd(1.0))                  u = -g
  "mom"     (optax.sgd(1.0, momentum=m))      t = g + m * t  (t0 = 0);  u = -t
  "adam"    (optax.adam(1.0, eps=e))          c = c + 1 (c0 = 0, int32);
            mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu  (both 0 at start);
            u = -(mu / (1 - b1^c)) / (sqrt(nu / (1 - b2^c)) + e)   (b1 0.9, b2 0.999)
  "rmsprop" (optax.rmsprop(1.0, decay=d, eps=e))
            nu = (1 - d) g^2 + d nu  (nu0 = 0);  u = -g / sqrt(nu + e)

The state is a flat {name: tensor} mapping ("count", "mu/<param>",
"nu/<param>" for adam), so checkpoints carry it, the step count included,
and a resumed run updates as an uninterrupted one would.

With `trainable_scopes` only the params whose path matches a scope
(`trainable_mask`, prefix-anchored regexes) are updated, as optax's
multi_transform with set_to_zero does in the JAX package: the others get
no update and keep no optimizer state (set_to_zero's state is empty;
adam's count is one scalar for the trained set). Their gradients are
still computed by the step, as in JAX.
"""

from __future__ import annotations

import bisect
import re
from typing import Callable, Dict, FrozenSet, Mapping, Optional, Sequence

import torch

from tcresnet_tpu_torch.config import OptimConfig

Tensors = Dict[str, torch.Tensor]

ADAM_B1, ADAM_B2 = 0.9, 0.999  # optax.adam's defaults; the config sets neither


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


def trainable_mask(params: Mapping[str, object], scopes: Sequence[str],
                   path_of: Callable[[str], str] = str) -> Dict[str, bool]:
    """{name: True where path_of(name) matches a scope regex} (the JAX
    package's trainable_mask, get_variables_to_train parity). Matching is
    PREFIX-ANCHORED (re.match), the reference's startswith: "fc" selects
    paths that start with fc, not "block3/fc_proj"."""
    return {name: any(re.match(s, path_of(name)) for s in scopes) for name in params}


class UnitOptimizer:
    """A unit-LR optimizer: init(params) -> state; update(grads, state) ->
    (updates, new state). State and updates are {name: tensor} on the
    params' device; update() never reads the device. With `trainable` (a
    set of names) only those params have state and get updates."""

    NAMES = ("gd", "mom", "adam", "rmsprop")

    def __init__(self, name: str, momentum: float = 0.9, *, adam_epsilon: float = 1e-8,
                 rmsprop_decay: float = 0.9, rmsprop_epsilon: float = 1e-10,
                 trainable: Optional[FrozenSet[str]] = None):
        if name not in self.NAMES:
            raise ValueError(f"Unknown optimizer {name!r}")
        self.name = name
        self.momentum = momentum
        self.adam_epsilon = adam_epsilon
        self.rmsprop_decay, self.rmsprop_epsilon = rmsprop_decay, rmsprop_epsilon
        self.trainable = trainable

    def _trained(self, tensors: Mapping[str, torch.Tensor]) -> Mapping[str, torch.Tensor]:
        if self.trainable is None:
            return tensors
        return {k: v for k, v in tensors.items() if k in self.trainable}

    def init(self, params: Mapping[str, torch.Tensor]) -> Tensors:
        device = next(iter(params.values())).device
        params = self._trained(params)

        def zeros(prefix):
            return {f"{prefix}{k}": torch.zeros_like(p, dtype=torch.float32)
                    for k, p in params.items()}

        if self.name == "gd":
            return {}
        if self.name == "mom":
            return zeros("")
        if self.name == "rmsprop":
            return zeros("nu/")
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                **zeros("mu/"), **zeros("nu/")}

    def update(self, grads: Mapping[str, torch.Tensor],
               state: Mapping[str, torch.Tensor]):
        grads = self._trained(grads)
        if self.name == "gd":
            return {k: -g for k, g in grads.items()}, dict(state)
        if self.name == "mom":
            trace = {k: g + self.momentum * state[k] for k, g in grads.items()}
            return {k: -t for k, t in trace.items()}, trace
        updates, new = {}, {}
        if self.name == "rmsprop":
            d = self.rmsprop_decay
            for k, g in grads.items():
                nu = (1 - d) * (g * g) + d * state[f"nu/{k}"]
                updates[k] = -(torch.rsqrt(nu + self.rmsprop_epsilon) * g)
                new[f"nu/{k}"] = nu
            return updates, new
        b1, b2 = ADAM_B1, ADAM_B2
        count = state["count"] + 1
        new["count"] = count
        correct1 = 1 - b1 ** count.to(torch.float32)
        correct2 = 1 - b2 ** count.to(torch.float32)
        for k, g in grads.items():
            mu = (1 - b1) * g + b1 * state[f"mu/{k}"]
            nu = (1 - b2) * (g * g) + b2 * state[f"nu/{k}"]
            updates[k] = -((mu / correct1) / (torch.sqrt(nu / correct2) + self.adam_epsilon))
            new[f"mu/{k}"], new[f"nu/{k}"] = mu, nu
        return updates, new


def build_optimizer(cfg: OptimConfig, num_samples: Optional[int] = None,
                    batch_size: Optional[int] = None, restore_step: int = 0,
                    relative: bool = False, params: Optional[Mapping[str, object]] = None,
                    path_of: Callable[[str], str] = str):
    """(UnitOptimizer, schedule) for `cfg`. With cfg.trainable_scopes the
    optimizer updates only the `params` names whose `path_of(name)`
    matches a scope (`params` is required then; the trainer's `path_of` is
    `models/convert.py::jax_path`, the path JAX's scopes match)."""
    trainable = None
    if cfg.trainable_scopes:
        if params is None:
            raise ValueError("trainable_scopes requires params for the mask")
        mask = trainable_mask(params, cfg.trainable_scopes, path_of)
        trainable = frozenset(k for k, m in mask.items() if m)
    boundaries = resolve_boundaries(cfg, num_samples, batch_size, restore_step, relative)
    optimizer = UnitOptimizer(cfg.optimizer, cfg.momentum, adam_epsilon=cfg.adam_epsilon,
                              rmsprop_decay=cfg.rmsprop_decay,
                              rmsprop_epsilon=cfg.rmsprop_epsilon, trainable=trainable)
    return optimizer, piecewise_constant(boundaries, cfg.lr_list)


def scale_updates(updates: Mapping[str, torch.Tensor], lr: float) -> Tensors:
    """Scale unit-LR updates by the schedule value for this step."""
    return {k: lr * u for k, u in updates.items()}


def ema_update(ema_params: Mapping[str, torch.Tensor],
               params: Mapping[str, torch.Tensor], decay: float) -> Tensors:
    """TF ExponentialMovingAverage.apply: decay * shadow + (1 - decay) * param."""
    return {k: decay * e + (1.0 - decay) * params[k] for k, e in ema_params.items()}
