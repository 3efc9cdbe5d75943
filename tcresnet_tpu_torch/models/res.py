"""Res family (counterpart of tcresnet_tpu/models/res.py).

Tang & Lin's deep residual KWS nets over the [T, F] map:

  f_conv 3x3 -> ReLU [-> 4x3/1 VALID avg pool, Res8]
  -> blocks of (conv -> ReLU -> stat-only BN, conv -> ReLU, add, BN)
  [-> a trailing conv -> ReLU -> BN, Res15] -> global average pool
  -> fc (no bias).

Every conv is 3x3 stride 1 SAME without bias, `num_channels` wide (45,
narrow 19); Res15 dilates layer idx at 2 ** (idx // 3), up to 16. The
batch norms have neither scale nor shift (center=False, scale=False), so
they have running statistics and no parameters, as in Flax. Submodule
names follow the Flax scopes (f_conv, conv{idx}, conv{idx}_bn, fc) and
are registered in Flax's creation order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tcresnet_tpu_torch.models import layers

RES_SHAPES = {  # name -> (layers, channels, front pool, dilation)
    "Res8": (6, 45, (4, 3), False),
    "Res8Narrow": (6, 19, (4, 3), False),
    "Res15": (13, 45, None, True),
    "Res15Narrow": (13, 19, None, True),
}


def dilation_rate(idx: int, use_dilation: bool) -> int:
    return 2 ** (idx // 3) if use_dilation else 1


class ResKWS(nn.Module):
    def __init__(self, num_classes: int, num_layers: int, num_channels: int, *,
                 pool_size: Optional[Tuple[int, int]] = None, use_dilation: bool = False,
                 bn_momentum: Optional[float] = None, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.num_layers = num_layers
        self.pool_size = pool_size
        self.use_dilation = use_dilation
        self.dtype = dtype
        momentum = 0.997 if bn_momentum is None else bn_momentum
        self.f_conv = self._conv(1, num_channels, 1, device)
        for idx in range(num_layers):
            # every conv has its BN: a block's first after its ReLU, its
            # second after the residual add, the trailing one after its ReLU
            self.add_module(f"conv{idx}", self._conv(
                num_channels, num_channels, dilation_rate(idx, use_dilation), device))
            self.add_module(f"conv{idx}_bn", layers.SlimBatchNorm(
                num_channels, momentum=momentum, center=False, scale=False,
                dtype=dtype, device=device))
        self.fc = nn.Linear(num_channels, num_classes, bias=False, device=device)
        nn.init.xavier_uniform_(self.fc.weight)

    def _conv(self, ci, co, rate, device):
        return layers.Conv2d(ci, co, (3, 3), dilation=rate, dtype=self.dtype, device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T, F, 1] features -> [B, num_classes] f32 logits."""
        x = F.relu(self.f_conv(x.permute(0, 3, 1, 2)))
        if self.pool_size is not None:
            x = layers.avg_pool_valid(x, self.pool_size, (1, 1))
        idx = 0
        for i in range(self.num_layers // 2):
            shortcut = x
            y = getattr(self, f"conv{idx}_bn")(F.relu(getattr(self, f"conv{idx}")(x)))
            y = F.relu(getattr(self, f"conv{idx + 1}")(y))
            x = getattr(self, f"conv{2 * i + 1}_bn")(y + shortcut)
            idx += 2
        if self.num_layers % 2:
            x = getattr(self, f"conv{idx}_bn")(F.relu(getattr(self, f"conv{idx}")(x)))
        return F.linear(x.mean(dim=(2, 3)), self.fc.weight.to(self.dtype)).to(torch.float32)


def res_model(name: str, num_classes: int, **kw) -> ResKWS:
    num_layers, channels, pool, dilation = RES_SHAPES[name]
    return ResKWS(num_classes, num_layers, channels, pool_size=pool, use_dilation=dilation, **kw)
