"""TC-ResNet (counterpart of tcresnet_tpu/models/tc_resnet.py:36-126).

The [B, L, C, 1] features are read with the MFCC axis as channels, so
every conv is a k x 1 temporal conv:

  conv0 3x1 -> n_blocks residual blocks (9x1 conv stride s + 9x1 conv,
  1x1 stride-2 "down" shortcut when channels change, ReLU after the add)
  -> global average pool -> linear classifier (no bias).

Submodule names follow the Flax scopes (conv0_conv, conv0_bn,
block{i}_down_conv, block{i}_conv0_bn, fc, ...) and are registered in
Flax's creation order, so weights map by name (models/convert.py).
In training mode batch norm uses batch statistics and updates its running
ones, and dropout (keep_prob) acts on the pooled vector before the fc,
its mask drawn from the generator passed to forward().
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tcresnet_tpu_torch.models import layers

TC_CHANNELS = {
    "TCResNet8": (16, 24, 32, 48),
    "TCResNet14": (16, 24, 24, 32, 32, 48, 48),
}


def scaled_channels(name: str, width_multiplier: float) -> Tuple[int, ...]:
    return tuple(int(c * width_multiplier) for c in TC_CHANNELS[name])


def block_plan(channels: Tuple[int, ...]) -> List[Tuple[int, int, bool]]:
    """(block index, out channels, has a "down" shortcut) per residual
    block; a block with a down shortcut has stride 2."""
    plan, prev = [], channels[0]
    for i, n in enumerate(channels[1:]):
        plan.append((i, n, n != prev))
        prev = n
    return plan


class TCResNet(nn.Module):
    def __init__(self, num_classes: int, n_channels: Tuple[int, ...],
                 in_channels: int, *, dropout_keep_prob: float = 0.5,
                 bn_momentum: Optional[float] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.n_channels = tuple(n_channels)
        self.dropout_keep_prob = dropout_keep_prob
        self.bn_momentum = 0.997 if bn_momentum is None else bn_momentum
        self.dtype = dtype
        self._add_conv_bn("conv0", in_channels, n_channels[0], 3, 1, device)
        prev = n_channels[0]
        for i, n, down in block_plan(self.n_channels):
            stride = 2 if down else 1
            if down:
                self._add_conv_bn(f"block{i}_down", prev, n, 1, 2, device)
            self._add_conv_bn(f"block{i}_conv0", prev, n, 9, stride, device)
            self._add_conv_bn(f"block{i}_conv1", n, n, 9, 1, device)
            prev = n
        self.fc = nn.Linear(prev, num_classes, bias=False, device=device)
        nn.init.xavier_uniform_(self.fc.weight)

    def _add_conv_bn(self, name, ci, co, k, stride, device):
        self.add_module(f"{name}_conv", layers.TemporalConv(
            ci, co, k, stride, dtype=self.dtype, device=device))
        self.add_module(f"{name}_bn", layers.SlimBatchNorm(
            co, momentum=self.bn_momentum, dtype=self.dtype, device=device))

    def _conv_bn(self, x, name, relu=True):
        x = getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x))
        return F.relu(x) if relu else x

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, L, C] or [B, L, C, 1] features -> [B, num_classes] f32 logits.
        In training mode the dropout mask is drawn from `generator`."""
        if x.dim() == 4:
            if x.shape[-1] != 1:
                raise ValueError("temporal variant expects [B, L, C, 1] features")
            x = x[..., 0]
        x = x.transpose(1, 2)  # [B, L, C] -> [B, C, L]: frequency becomes channels
        x = self._conv_bn(x, "conv0")
        for i, _, down in block_plan(self.n_channels):
            shortcut = self._conv_bn(x, f"block{i}_down") if down else x
            y = self._conv_bn(x, f"block{i}_conv0")
            y = self._conv_bn(y, f"block{i}_conv1", relu=False)
            x = F.relu(y + shortcut)
        x = layers.dropout(layers.global_avg_pool(x), self.dropout_keep_prob,
                           self.training, generator)
        return F.linear(x, self.fc.weight.to(self.dtype)).to(torch.float32)


def tc_resnet8(num_classes: int, width_multiplier: float = 1.0, *,
               in_channels: int, **kw) -> TCResNet:
    return TCResNet(num_classes, scaled_channels("TCResNet8", width_multiplier),
                    in_channels, **kw)


def tc_resnet14(num_classes: int, width_multiplier: float = 1.0, *,
                in_channels: int, **kw) -> TCResNet:
    return TCResNet(num_classes, scaled_channels("TCResNet14", width_multiplier),
                    in_channels, **kw)
