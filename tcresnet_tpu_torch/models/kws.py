"""Google KWS baselines (counterpart of tcresnet_tpu/models/kws.py).

All seven architectures of the JAX package, over [B, T, F, 1] features:

  single_fc        flatten -> fc (bias)
  conv             20x8/64 SAME conv + ReLU, 2x2 SAME max pool, 10x4/64 SAME
                   conv + ReLU, flatten -> fc (biases)
  trad_fpool3      20x8/64 VALID conv + ReLU, 1x3 VALID max pool, 10x4/64
                   VALID conv + ReLU, flatten -> lin(32) -> fc1(128) -> fc2,
                   no biases
  low_latency_conv Tx8/186 VALID conv + ReLU (spans all frames), flatten ->
                   fc1(128) -> fc2(128) -> fc3 (biases)
  one_fstride4     Tx8/186 VALID conv, stride 4 along F, + ReLU, flatten ->
                   lin(32) -> fc1(128) -> fc2(128) -> fc3, no biases
  low_latency_svdf rank-2 SVDF with 1280 units: per-frame frequency filters
                   weights_frequency [F, 2560], per-filter time filters
                   weights_time [2560, T], unit-major filters (k = u * 2 + r),
                   ReLU(units + bias), then fc1(256) -> fc2(256) -> fc3
  tiny_conv        10x8/8 stride-2 SAME conv + ReLU, flatten -> fc

The Dense layers between the fcs have no activation, as in the JAX
package. Flax flattens NHWC, channel fastest; the port's activations are
NCHW, so they are permuted to [B, T, F, C] before the flatten, and the
Dense weights keep Flax's input order (models/convert.py transposes
[in, out] to [out, in] and nothing more).

In training mode dropout with keep probability 0.5 follows each ReLU, and
fc1 and fc2 of low_latency_conv, one_fstride4 and low_latency_svdf, where
the JAX model drops (kws.py:58-59, 100-190); the masks are drawn from the
generator passed to forward(), in forward order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tcresnet_tpu_torch.models import layers

KWS_ARCHITECTURES = (
    "single_fc",
    "conv",
    "low_latency_conv",
    "one_fstride4",
    "trad_fpool3",
    "low_latency_svdf",
    "tiny_conv",
)

SVDF_RANK, SVDF_UNITS = 2, 1280
KEEP_PROB = 0.5  # the reference's dropout after each ReLU and hidden fc
# dense layers followed by dropout in training
_DROPPED_DENSE = {"low_latency_conv": ("fc1", "fc2"), "one_fstride4": ("fc1", "fc2"),
                  "low_latency_svdf": ("fc1", "fc2")}


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """[B, C, T, F] -> [B, T * F * C] in Flax's order (channel fastest)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _ceil_half(n: int) -> int:
    return -(-n // 2)


class KWSNet(nn.Module):
    def __init__(self, num_classes: int, architecture: str, feature_shape: Tuple[int, int, int],
                 *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if architecture not in KWS_ARCHITECTURES:
            raise ValueError(
                f"Unknown KWS architecture {architecture!r}; choose from {KWS_ARCHITECTURES}")
        self.architecture = architecture
        self.dtype = dtype
        t, f, _ = feature_shape
        nc = num_classes

        def conv(name, ci, co, kernel, stride=(1, 1), padding="SAME", bias=True):
            self.add_module(name, layers.Conv2d(ci, co, kernel, stride, padding=padding,
                                                bias=bias, dtype=dtype, device=device))

        def dense(name, fan_in, fan_out, bias=True):
            self.add_module(name, nn.Linear(fan_in, fan_out, bias=bias, device=device))

        if architecture == "single_fc":
            dense("fc", t * f, nc)
        elif architecture == "conv":
            conv("conv1", 1, 64, (20, 8))
            conv("conv2", 64, 64, (10, 4))
            dense("fc", _ceil_half(t) * _ceil_half(f) * 64, nc)
        elif architecture == "trad_fpool3":
            conv("conv1", 1, 64, (20, 8), padding="VALID", bias=False)
            f2 = (f - 7 - 3) // 3 + 1
            conv("conv2", 64, 64, (10, 4), padding="VALID", bias=False)
            dense("lin", (t - 19 - 9) * (f2 - 3) * 64, 32, bias=False)
            dense("fc1", 32, 128, bias=False)
            dense("fc2", 128, nc, bias=False)
        elif architecture == "low_latency_conv":
            conv("conv1", 1, 186, (t, 8), padding="VALID")
            dense("fc1", (f - 7) * 186, 128)
            dense("fc2", 128, 128)
            dense("fc3", 128, nc)
        elif architecture == "one_fstride4":
            conv("conv1", 1, 186, (t, 8), (1, 4), padding="VALID", bias=False)
            dense("lin", ((f - 8) // 4 + 1) * 186, 32, bias=False)
            dense("fc1", 32, 128, bias=False)
            dense("fc2", 128, 128, bias=False)
            dense("fc3", 128, nc, bias=False)
        elif architecture == "low_latency_svdf":
            k = SVDF_RANK * SVDF_UNITS
            self.weights_frequency = nn.Parameter(torch.empty(f, k, device=device))
            self.weights_time = nn.Parameter(torch.empty(k, t, device=device))
            self.bias = nn.Parameter(torch.zeros(SVDF_UNITS, device=device))
            dense("fc1", SVDF_UNITS, 256)
            dense("fc2", 256, 256)
            dense("fc3", 256, nc)
        else:  # tiny_conv
            conv("conv1", 1, 8, (10, 8), (2, 2))
            dense("fc", _ceil_half(t) * _ceil_half(f) * 8, nc)
        # truncated-normal weights, zero biases (stddev 0.001 for single_fc)
        std = 0.001 if architecture == "single_fc" else 0.01
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                nn.init.zeros_(p)
            else:
                nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std)

    def _dense(self, x, name):
        fc = getattr(self, name)
        bias = None if fc.bias is None else fc.bias.to(self.dtype)
        return F.linear(x, fc.weight.to(self.dtype), bias)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T, F, 1] features -> [B, num_classes] f32 logits. In training
        mode the dropout masks are drawn from `generator`."""
        arch = self.architecture

        def drop(y):
            return layers.dropout(y, KEEP_PROB, self.training, generator)

        def dense_tail(y, names):
            for name in names:
                y = self._dense(y, name)
                if name in _DROPPED_DENSE.get(arch, ()):
                    y = drop(y)
            return y.to(torch.float32)

        x = x.to(self.dtype)
        if arch == "single_fc":
            return dense_tail(x.reshape(x.shape[0], -1), ("fc",))
        if arch == "low_latency_svdf":
            frames = x[..., 0]  # [B, T, F]
            acts = frames @ self.weights_frequency.to(self.dtype)  # [B, T, K]
            out = torch.einsum("btk,kt->bk", acts, self.weights_time.to(self.dtype))
            units = out.reshape(x.shape[0], SVDF_UNITS, SVDF_RANK).sum(-1)
            y = drop(F.relu(units + self.bias.to(self.dtype)))
            return dense_tail(y, ("fc1", "fc2", "fc3"))
        x = drop(F.relu(self.conv1(x.permute(0, 3, 1, 2))))  # [B, 1, T, F] in
        if arch == "conv":
            x = layers.max_pool(x, (2, 2), (2, 2), "SAME")
            x = drop(F.relu(self.conv2(x)))
            tail = ("fc",)
        elif arch == "trad_fpool3":
            x = layers.max_pool(x, (1, 3), (1, 3), "VALID")
            x = drop(F.relu(self.conv2(x)))
            tail = ("lin", "fc1", "fc2")
        elif arch == "low_latency_conv":
            tail = ("fc1", "fc2", "fc3")
        elif arch == "one_fstride4":
            tail = ("lin", "fc1", "fc2", "fc3")
        else:  # tiny_conv
            tail = ("fc",)
        return dense_tail(_flatten_nhwc(x), tail)
