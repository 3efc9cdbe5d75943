"""Loss functions (counterpart of tcresnet_tpu/train/loss.py:16-59).

total = CE(label smoothing) + weight_decay * sum(sum(v^2) / 2) over the
non-BatchNorm parameters: the reference's effective training loss
(factory/audio_nets.py:161-183).
"""

from __future__ import annotations

from typing import Mapping

import torch


def per_example_softmax_cross_entropy(logits: torch.Tensor, onehot: torch.Tensor,
                                      label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-example CE with label smoothing: y = y * (1 - s) + s / num_classes."""
    if label_smoothing > 0.0:
        num_classes = onehot.shape[-1]
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / num_classes
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -(onehot * log_probs).sum(-1)


def smoothed_softmax_cross_entropy(logits: torch.Tensor, onehot: torch.Tensor,
                                   label_smoothing: float = 0.0) -> torch.Tensor:
    """tf.losses.softmax_cross_entropy semantics, mean over the batch."""
    return per_example_softmax_cross_entropy(logits, onehot, label_smoothing).mean()


def is_batch_norm_name(name: str) -> bool:
    """True for a parameter of a BatchNorm layer: the port keeps the Flax
    scope names (`conv0_bn.weight`), and the check is the JAX one
    (a scope ending in `_bn`, named `bn`, or containing `BatchNorm`)."""
    return any(s.endswith("_bn") or s == "bn" or "BatchNorm" in s
               for s in name.split(".")[:-1])


def l2_regularization(params: Mapping[str, torch.Tensor],
                      weight_decay: float) -> torch.Tensor:
    """weight_decay * sum(sum(v^2) / 2) over non-BatchNorm params."""
    device = next(iter(params.values())).device
    total = torch.zeros((), dtype=torch.float32, device=device)
    if weight_decay == 0.0:
        return total
    for name, p in params.items():
        if not is_batch_norm_name(name):
            total = total + 0.5 * torch.sum(torch.square(p.to(torch.float32)))
    return weight_decay * total


def training_loss(logits: torch.Tensor, onehot: torch.Tensor,
                  params: Mapping[str, torch.Tensor], model_cfg):
    """(total, model loss, L2) of a training step in one process: the
    smoothed cross entropy, mean over the batch, plus the L2 term of
    `model_cfg.weight_decay`. What the Trainer differentiates and
    `utils.profiling.step_flops` counts."""
    model_loss = smoothed_softmax_cross_entropy(logits, onehot, model_cfg.label_smoothing)
    l2 = l2_regularization(params, model_cfg.weight_decay)
    return model_loss + l2, model_loss, l2
