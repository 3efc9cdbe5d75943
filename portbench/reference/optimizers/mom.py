"""Momentum SGD as the TC-ResNet recipe runs it (the authors'
helper/trainer.py, TF-1.13's MomentumOptimizer without Nesterov):

    t <- g + momentum * t  (t starts at 0);  v <- v - lr * t

`optim["momentum"]` is the configuration's. After one step the trace is the
first gradient itself.
"""

from __future__ import annotations

from typing import Dict

import torch

Tensors = Dict[str, torch.Tensor]


def init(params: Tensors) -> Tensors:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def step(params: Tensors, grads: Tensors, state: Tensors, lr: float, optim: dict):
    trace = {k: g + optim["momentum"] * state[k] for k, g in grads.items()}
    return {k: params[k].detach() - lr * trace[k] for k in grads}, trace


def first_grad(program_state: Tensors, name: str) -> torch.Tensor:
    return program_state[name]
