"""Layer primitives with TF-slim semantics (counterpart of
tcresnet_tpu/models/layers.py).

Activations inside the port's models are PyTorch's [B, C, T]; the public
model input keeps the JAX layout [B, T, C(, 1)].

- TF-SAME padding is asymmetric: the left pad is total // 2, so a 9x1
  stride-2 conv on T=98 pads 3 on the left and 4 on the right. PyTorch's
  padding="same" refuses stride 2, so the pad is an explicit F.pad.
- slim.batch_norm uses epsilon 1e-3 and decay 0.997, which is Flax's
  momentum (running = m * running + (1 - m) * batch) and torch's
  momentum 0.003. In training mode it normalises with the batch
  statistics and updates the running variance with the BIASED batch
  variance, as Flax does (torch's own batch norm uses the unbiased one).
- Convs have no bias.
- `compute_dtype` as the JAX layers honour it: a conv runs in that dtype
  (its f32 weight cast for the call); batch norm computes its statistics
  and normalises in float32 and returns the compute dtype; parameters
  stay float32.
- slim.dropout(keep_prob) keeps each unit with probability keep_prob and
  scales it by 1 / keep_prob.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3  # slim.batch_norm default


def same_padding(t: int, k: int, stride: int) -> Tuple[int, int, int]:
    """TF-SAME geometry of a k-tap stride-s conv over t rows:
    (out rows, left pad, right pad)."""
    to = -(-t // stride)
    total = max((to - 1) * stride + k - t, 0)
    return to, total // 2, total - total // 2


class TemporalConv(nn.Module):
    """k x 1 temporal conv, TF-SAME, no bias. weight [Co, Ci, k] (the Flax
    kernel [k, 1, Ci, Co] transposed)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, device=device)
        )
        nn.init.xavier_uniform_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, Ci, T] -> [B, Co, ceil(T / stride)]."""
        _, lo, hi = same_padding(x.shape[-1], self.weight.shape[-1], self.stride)
        x = F.pad(x.to(self.dtype), (lo, hi))
        return F.conv1d(x, self.weight.to(self.dtype), stride=self.stride)


class SlimBatchNorm(nn.Module):
    """slim.batch_norm (center + scale, epsilon 1e-3) over dim 1 of
    [B, C, ...]: running statistics in eval mode, batch statistics (and a
    running-statistics update) in training mode."""

    def __init__(self, num_features: int, *, momentum: float = 0.997,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.momentum = momentum  # Flax's: running = m * running + (1 - m) * batch
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.to(torch.float32)
        if self.training:
            # Flax's fast variance, E[x^2] - E[x]^2 clipped at 0, in f32
            axes = [0] + list(range(2, x.dim()))
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)


def dropout(x: torch.Tensor, keep_prob: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """slim.dropout: in training keep each unit with probability keep_prob
    and scale it by 1 / keep_prob; the identity otherwise (or at 1.0).
    The mask is drawn from `generator` (torch's default one when None)."""
    if not training or keep_prob >= 1.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, C, T] -> [B, C]: the full-window mean."""
    return x.mean(dim=-1)
