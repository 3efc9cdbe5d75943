"""Train state (counterpart of tcresnet_tpu/train/state.py:17-53).

The step, the params, the BN running statistics, the optimizer state and
the EMA params, as {name: tensor} mappings on the training device. The
params and statistics ARE the model's tensors (`from_model`): the trainer
updates them in place, so the module always computes with the state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor  # int64 scalar on the device (global step)
    params: Tensors
    batch_stats: Tensors
    opt_state: Tensors
    ema_params: Optional[Tensors] = None

    def state_dict(self) -> Dict[str, object]:
        """Host copies of every tensor, for torch.save."""
        def host(d):
            return None if d is None else {k: v.detach().cpu() for k, v in d.items()}

        return {"step": self.step.detach().cpu(), "params": host(self.params),
                "batch_stats": host(self.batch_stats), "opt_state": host(self.opt_state),
                "ema_params": host(self.ema_params)}

    def load_state_dict(self, saved: Dict[str, object]) -> None:
        """Copy a state_dict() into this state's tensors, in place."""
        with torch.no_grad():
            self.step.copy_(saved["step"])
            for field in ("params", "batch_stats", "opt_state", "ema_params"):
                mine, theirs = getattr(self, field), saved.get(field)
                if (mine is None) != (theirs is None) or (
                        mine is not None and set(mine) != set(theirs)):
                    raise ValueError(f"checkpoint {field} does not match this state")
                for k, v in (mine or {}).items():
                    v.copy_(theirs[k])


def create_train_state(model: nn.Module, optimizer, use_ema: bool = False) -> TrainState:
    """A state over `model`'s own parameters and buffers."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    return TrainState(
        step=torch.zeros((), dtype=torch.int64, device=device),
        params=params,
        batch_stats=dict(model.named_buffers()),
        opt_state=optimizer.init(params),
        ema_params={k: p.detach().clone() for k, p in params.items()} if use_ema else None,
    )
