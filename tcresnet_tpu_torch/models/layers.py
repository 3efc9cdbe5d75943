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
  (its f32 weight cast for the call), except that the K7 conv
  (`PallasTemporalConv`) rounds its operands to it and computes and
  returns float32, as the JAX Pallas conv does; batch norm computes its
  statistics and normalises in float32 and returns the compute dtype;
  parameters stay float32.
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


class PallasTemporalConv(TemporalConv):
    """k x 1 conv through kernel K7's forward and backward
    (ops/kernels/tconv.py; the JAX PallasTemporalConv). The parameter is
    TemporalConv's, so checkpoints are interchangeable between backends.

    As in JAX, x and the weight are cast to the compute dtype and then to
    float32, and the conv returns float32 (under bf16 compute the cuDNN
    path returns bf16); autograd then rounds dx and dw through bf16 where
    the VJP of JAX's casts does. `interpret` runs the plain versions on
    any device (the JAX package's "pallas-interpret", a test value)."""

    def __init__(self, *args, interpret: bool = False, **kw):
        super().__init__(*args, **kw)
        self.interpret = interpret

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from tcresnet_tpu_torch.ops.kernels.tconv import temporal_conv

        x = x.to(self.dtype).to(torch.float32)
        w = self.weight.to(self.dtype).to(torch.float32)
        return temporal_conv(x, w, self.stride, self.interpret)


def slim_conv(in_channels: int, out_channels: int, kernel: Tuple[int, int],
              stride: Tuple[int, int], *, conv_backend: str = "xla",
              dtype: torch.dtype = torch.float32, device=None) -> nn.Module:
    """The conv module for a Flax-style (kernel, stride) over [B, L, 1, C]
    activations, by `conv_backend` (JAX layers.py::slim_conv):

      "xla"              TemporalConv (cuDNN on the card)
      "pallas"           PallasTemporalConv: K7 on the card, its plain
                         version on the CPU
      "pallas-interpret" PallasTemporalConv on the plain versions, any device

    Only temporal convs (kernel and stride 1 along the second axis) exist
    in the port; every TC-ResNet conv is one, the 1x1 stride-(2, 1)
    shortcut included. "im2col" (Im2ColConv) is not carried over."""
    if conv_backend == "im2col":
        raise NotImplementedError(
            "conv_backend='im2col' (Im2ColConv, an XLA formulation for the TPU) is "
            "not carried over to the port (ROADMAP.md Queue 1 item 15)")
    if conv_backend not in ("xla", "pallas", "pallas-interpret"):
        raise ValueError(f"conv_backend must be 'xla', 'pallas' or 'pallas-interpret', "
                         f"got {conv_backend!r}")
    if kernel[1] != 1 or stride[1] != 1:
        raise NotImplementedError(
            f"only temporal k x 1 convs are ported, got kernel {kernel} stride {stride} "
            "(ROADMAP.md Queue 1 item 11)")
    args = (in_channels, out_channels, kernel[0], stride[0])
    if conv_backend == "xla":
        return TemporalConv(*args, dtype=dtype, device=device)
    return PallasTemporalConv(*args, dtype=dtype, device=device,
                              interpret=conv_backend == "pallas-interpret")


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
