"""Adam, Kingma & Ba, "Adam: A Method for Stochastic Optimization"
(arXiv:1412.6980), Algorithm 1, in float32:

    t <- t + 1
    m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2  (both 0 at start)
    m_hat = m / (1 - b1^t);  v_hat = v / (1 - b2^t)
    theta <- theta - lr * m_hat / (sqrt(v_hat) + eps)

with b1 0.9, b2 0.999 and eps the configuration's `optim["adam_epsilon"]`.

TF-1.13's `AdamOptimizer`, which the original recipes ran, takes the
paper's "efficient" form instead: lr_t = lr sqrt(1 - b2^t) / (1 - b1^t) and
theta <- theta - lr_t m / (sqrt(v) + eps_hat). That is this update with
eps = eps_hat / sqrt(1 - b2^t) in place of eps: at eps_hat = 1e-8 it is
3.16e-7 at step 1, 3.2e-8 at step 100 and 1.26e-8 at step 1000. At step 1
sqrt(v_hat) = |g|, so an element's update differs by the factor
(|g| + 1e-8) / (|g| + 3.16e-7): 0.03% where |g| = 1e-3, 23% at
|g| = 1e-6. The reference follows Algorithm 1, as the program under test
(optax's adam) does.

The program's state after one step holds mu = (1 - b1) g, so the first
gradient is mu / (1 - b1).
"""

from __future__ import annotations

from typing import Dict

import torch

Tensors = Dict[str, torch.Tensor]
B1, B2 = 0.9, 0.999


def init(params: Tensors) -> dict:
    return {"t": 0, "m": {k: torch.zeros_like(v) for k, v in params.items()},
            "v": {k: torch.zeros_like(v) for k, v in params.items()}}


def step(params: Tensors, grads: Tensors, state: dict, lr: float, optim: dict):
    t = state["t"] + 1
    eps = optim["adam_epsilon"]
    m = {k: B1 * state["m"][k] + (1 - B1) * g for k, g in grads.items()}
    v = {k: B2 * state["v"][k] + (1 - B2) * (g * g) for k, g in grads.items()}
    new = {}
    for k in grads:
        m_hat = m[k] / (1 - B1 ** t)
        v_hat = v[k] / (1 - B2 ** t)
        new[k] = params[k].detach() - lr * m_hat / (torch.sqrt(v_hat) + eps)
    return new, {"t": t, "m": m, "v": v}


def first_grad(program_state: Tensors, name: str) -> torch.Tensor:
    return program_state[f"mu/{name}"] / (1 - B1)
