"""DS-CNN family (counterpart of tcresnet_tpu/models/ds_cnn.py).

ARM's "Hello Edge" depthwise-separable KWS CNNs over the [T, F] map: one
standard 10x4 conv (stride 2x2 for S, 2x1 for M/L), then separable
blocks (3x3 depthwise conv -> BN + ReLU -> 1x1 pointwise conv -> BN +
ReLU), a global average pool and `fc1` with a bias. Every conv has a
bias; every BN a shift and no scale (center=True, scale=False), decay
0.96. The depthwise weight is [C, 1, kh, kw] with groups=C (the Flax
kernel [kh, kw, 1, C] transposed). Submodule names follow the Flax
scopes (conv_1, conv_1_bn, conv_ds_1_dw, conv_ds_1_dw_bn, conv_ds_1_pw,
..., fc1). Each depthwise conv is traced as the span `model.depthwise`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tcresnet_tpu_torch.models import layers
from tcresnet_tpu_torch.utils.profiling import backward_span, span


class Block(NamedTuple):
    type: str  # "conv" | "separable"
    depth: int
    kernel: Tuple[int, int]
    stride: Tuple[int, int]
    name: str


S_NET_DEF = (
    Block("conv", 64, (10, 4), (2, 2), "conv_1"),
    Block("separable", 64, (3, 3), (1, 1), "conv_ds_1"),
    Block("separable", 64, (3, 3), (1, 1), "conv_ds_2"),
    Block("separable", 64, (3, 3), (1, 1), "conv_ds_3"),
    Block("separable", 64, (3, 3), (1, 1), "conv_ds_4"),
)

M_NET_DEF = (
    Block("conv", 172, (10, 4), (2, 1), "conv_1"),
    Block("separable", 172, (3, 3), (2, 2), "conv_ds_1"),
    Block("separable", 172, (3, 3), (1, 1), "conv_ds_2"),
    Block("separable", 172, (3, 3), (1, 1), "conv_ds_3"),
    Block("separable", 172, (3, 3), (1, 1), "conv_ds_4"),
)

L_NET_DEF = (
    Block("conv", 276, (10, 4), (2, 1), "conv_1"),
    Block("separable", 276, (3, 3), (2, 2), "conv_ds_1"),
    Block("separable", 276, (3, 3), (1, 1), "conv_ds_2"),
    Block("separable", 276, (3, 3), (1, 1), "conv_ds_3"),
    Block("separable", 276, (3, 3), (1, 1), "conv_ds_4"),
    Block("separable", 276, (3, 3), (1, 1), "conv_ds_5"),
)

NET_DEFS = {"DSCNNS": S_NET_DEF, "DSCNNM": M_NET_DEF, "DSCNNL": L_NET_DEF}


class DSCNN(nn.Module):
    def __init__(self, num_classes: int, net_def: Tuple[Block, ...], *,
                 bn_momentum: Optional[float] = None, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.net_def = tuple(net_def)
        self.dtype = dtype
        momentum = 0.96 if bn_momentum is None else bn_momentum
        channels = 1

        def conv_bn(name, ci, co, kernel, stride, groups=1):
            self.add_module(name, layers.Conv2d(
                ci, co, kernel, stride, groups=groups, bias=True, dtype=dtype, device=device))
            self.add_module(f"{name}_bn", layers.SlimBatchNorm(
                co, momentum=momentum, center=True, scale=False, dtype=dtype, device=device))

        for block in self.net_def:
            if block.type == "conv":
                conv_bn(block.name, channels, block.depth, block.kernel, block.stride)
            elif block.type == "separable":
                conv_bn(f"{block.name}_dw", channels, channels, block.kernel, block.stride,
                        groups=channels)
                conv_bn(f"{block.name}_pw", channels, block.depth, (1, 1), (1, 1))
            else:
                raise ValueError(f"Block type {block.type!r} is not supported")
            channels = block.depth
        self.fc1 = nn.Linear(channels, num_classes, device=device)
        nn.init.xavier_uniform_(self.fc1.weight)
        nn.init.zeros_(self.fc1.bias)

    def _conv_bn_relu(self, x, name):
        return getattr(self, f"{name}_bn")(getattr(self, name)(x), relu=True)

    def _depthwise_bn_relu(self, x, name):
        """`_conv_bn_relu` with the conv inside the spans `model.depthwise`
        (forward, and backward on its grad_fn)."""
        with span("model.depthwise", layer=name, phase="forward"):
            y = getattr(self, name)(x)
        y = backward_span(y, "model.depthwise", layer=name, phase="backward")
        return getattr(self, f"{name}_bn")(y, relu=True)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T, F, 1] features -> [B, num_classes] f32 logits."""
        x = x.permute(0, 3, 1, 2)  # [B, T, F, 1] -> [B, 1, T, F]
        for block in self.net_def:
            if block.type == "conv":
                x = self._conv_bn_relu(x, block.name)
            else:
                x = self._depthwise_bn_relu(x, f"{block.name}_dw")
                x = self._conv_bn_relu(x, f"{block.name}_pw")
        x = x.mean(dim=(2, 3))
        return F.linear(x, self.fc1.weight.to(self.dtype),
                        self.fc1.bias.to(self.dtype)).to(torch.float32)
