"""Layer primitives with TF-slim semantics (counterpart of
tcresnet_tpu/models/layers.py).

Activations inside the port's models are PyTorch's [B, C, T] (temporal
TC-ResNets) or [B, C, T, F] (the 2D families); the public model input
keeps the JAX layout [B, T, C(, 1)] / [B, T, F, 1].

- TF-SAME padding is asymmetric: the left pad is total // 2, so a 9x1
  stride-2 conv on T=98 pads 3 on the left and 4 on the right, and an
  even kernel (DS-CNN's 10x4, KWS's 20x8) pads one more row on the high
  side. PyTorch's padding="same" refuses stride 2, so the pad is an
  explicit F.pad; SAME max pooling pads with -inf.
- slim.batch_norm uses epsilon 1e-3 and decay 0.997, which is Flax's
  momentum (running = m * running + (1 - m) * batch) and torch's
  momentum 0.003. In training mode it normalises with the batch
  statistics and updates the running variance with the BIASED batch
  variance, as Flax does (torch's own batch norm uses the unbiased one).
- The TC-ResNet and Res convs have no bias; DS-CNN's and KWS's have one
  (`Conv2d(bias=True)`).
- `compute_dtype` as the JAX layers honour it: a conv runs in that dtype
  (its f32 weight cast for the call), except that the K7 conv
  (`PallasTemporalConv`) rounds its operands to it and computes and
  returns float32, as the JAX Pallas conv does; batch norm computes its
  statistics and normalises in float32 and returns the compute dtype;
  parameters stay float32.
- slim.dropout(keep_prob) keeps each unit with probability keep_prob and
  scales it by 1 / keep_prob.
- Data parallelism (parallel/mesh.py): under `sync_batch_norm(model,
  mesh)` a batch norm in training mode takes the moments of the global
  batch, its rows' sums reduced over the data axis, as the JAX package's
  do under jit's global view; a dropout mask drawn from a
  `ShardedGenerator` is the global batch's mask, of which this rank keeps
  its rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tcresnet_tpu_torch.ops.kernels import dwconv
from tcresnet_tpu_torch.ops.kernels.batchnorm import batch_norm_train
from tcresnet_tpu_torch.parallel import mesh as meshlib

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


def check_conv_backend(conv_backend: str) -> None:
    """"xla", "pallas" and "pallas-interpret" are served; "im2col" raises
    NotImplementedError, anything else ValueError."""
    if conv_backend == "im2col":
        raise NotImplementedError(
            "conv_backend='im2col' (Im2ColConv, an XLA formulation for the TPU) is "
            "not carried over to the port (ROADMAP.md Queue 1, \"Not carried over\")")
    if conv_backend not in ("xla", "pallas", "pallas-interpret"):
        raise ValueError(f"conv_backend must be 'xla', 'pallas' or 'pallas-interpret', "
                         f"got {conv_backend!r}")


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
    check_conv_backend(conv_backend)
    if kernel[1] != 1 or stride[1] != 1:
        raise NotImplementedError(
            f"only temporal k x 1 convs are ported (every TC-ResNet conv is one), got "
            f"kernel {kernel} stride {stride}")
    args = (in_channels, out_channels, kernel[0], stride[0])
    if conv_backend == "xla":
        return TemporalConv(*args, dtype=dtype, device=device)
    return PallasTemporalConv(*args, dtype=dtype, device=device,
                              interpret=conv_backend == "pallas-interpret")


def same_padding_2d(hw: Tuple[int, int], kernel: Tuple[int, int], stride: Tuple[int, int],
                    dilation: int = 1) -> Tuple[int, int, int, int]:
    """F.pad's (left, right, top, bottom) for a TF-SAME 2D window over
    [..., T, F]: per axis the low pad is total // 2, so an even kernel puts
    the extra row on the high side."""
    pads = []
    for n, k, s in zip(hw, kernel, stride):
        _, lo, hi = same_padding(n, (k - 1) * dilation + 1, s)
        pads.append((lo, hi))
    (t_lo, t_hi), (f_lo, f_hi) = pads
    return (f_lo, f_hi, t_lo, t_hi)


class Conv2d(nn.Module):
    """slim.conv2d / nn.Conv over [B, Ci, T, F]: TF-SAME (explicit F.pad,
    since PyTorch's padding="same" refuses stride 2) or VALID, stride,
    dilation, `groups` (groups == Ci is the depthwise conv) and an
    optional bias. weight [Co, Ci / groups, kh, kw] (the Flax kernel
    [kh, kw, Ci / groups, Co] transposed). A depthwise 3x3 SAME conv
    (DS-CNN's) on a card runs `ops/kernels/dwconv.py`'s kernels, pad and
    bias inside; elsewhere, and while PyTorch traces, F.pad and F.conv2d."""

    def __init__(self, in_channels: int, out_channels: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), *, padding: str = "SAME",
                 dilation: int = 1, groups: int = 1, bias: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.padding, self.dilation, self.groups = padding, dilation, groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *kernel, device=device))
        nn.init.xavier_uniform_(self.weight)
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device)) if bias else None

    def _depthwise_3x3(self, x: torch.Tensor) -> bool:
        """Whether the conv is one `ops/kernels/dwconv.py` computes:
        depthwise (groups equal to its input and output channels), 3x3,
        dilation 1, SAME, strides 1 or 2."""
        return (1 < self.groups == x.shape[1] == self.weight.shape[0] and self.kernel == (3, 3)
                and self.dilation == 1 and self.padding == "SAME"
                and all(s in (1, 2) for s in self.stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        pads = same_padding_2d(x.shape[-2:], self.kernel, self.stride, self.dilation) \
            if self.padding == "SAME" else None
        if self._depthwise_3x3(x) and dwconv.takes(x):
            return dwconv.depthwise_conv3x3(x, self.weight.to(self.dtype), bias, self.stride, pads)
        if pads is not None:
            x = F.pad(x, pads)
        return F.conv2d(x, self.weight.to(self.dtype), bias, stride=self.stride,
                        dilation=self.dilation, groups=self.groups)


def avg_pool_valid(x: torch.Tensor, window: Tuple[int, int],
                   stride: Tuple[int, int]) -> torch.Tensor:
    """slim.avg_pool2d with its default VALID padding, over [B, C, T, F]."""
    return F.avg_pool2d(x, tuple(window), tuple(stride))


def max_pool(x: torch.Tensor, window: Tuple[int, int], stride: Tuple[int, int],
             padding: str) -> torch.Tensor:
    """nn.max_pool over [B, C, T, F]; SAME pads with -inf (TF-SAME split)."""
    if padding == "SAME":
        x = F.pad(x, same_padding_2d(x.shape[-2:], window, stride), value=float("-inf"))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return F.max_pool2d(x, tuple(window), tuple(stride))


class SlimBatchNorm(nn.Module):
    """slim.batch_norm (epsilon 1e-3) over dim 1 of [B, C, ...]: running
    statistics in eval mode, batch statistics (and a running-statistics
    update) in training mode. `center` and `scale` say whether the layer
    has a learned shift ("bias") and scale ("weight"); as in Flax, a layer
    without them has no such parameter at all (Res uses neither, DS-CNN
    only the shift)."""

    def __init__(self, num_features: int, *, momentum: float = 0.997,
                 center: bool = True, scale: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.momentum = momentum  # Flax's: running = m * running + (1 - m) * batch
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features, device=device)) if scale else None
        self.bias = nn.Parameter(torch.zeros(num_features, device=device)) if center else None
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))
        self.mesh: Optional[meshlib.Mesh] = None  # set by sync_batch_norm

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        """y in `self.dtype`, then ReLU where `relu`. Training mode runs the
        batch-norm Function of `ops/kernels/batchnorm.py` (its kernels on a
        card, its plain version on the CPU): Flax's fast variance, E[x^2] -
        E[x]^2 clipped at 0 in f32, whose clip has jnp.maximum's gradient (at
        a tie, a channel that is all zeros as after a ReLU, it splits in
        halves, where a clamp would pass all of it), and the running
        statistics updated with the biased variance."""
        if self.training:
            return batch_norm_train(x, self.weight, self.bias, self.running_mean,
                                    self.running_var, self.momentum, relu, self.dtype,
                                    self.mesh)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.to(torch.float32)
        mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS)
        if self.weight is not None:
            mul = mul * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape)
        if self.bias is not None:
            y = y + self.bias.view(shape)
        y = y.to(self.dtype)
        return F.relu(y) if relu else y


def sync_batch_norm(model: nn.Module, mesh: Optional[meshlib.Mesh]) -> nn.Module:
    """Point every SlimBatchNorm of `model` at `mesh` (None: per-process
    moments again); returns the model."""
    for m in model.modules():
        if isinstance(m, SlimBatchNorm):
            m.mesh = mesh
    return model


def dropout(x: torch.Tensor, keep_prob: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """slim.dropout: in training keep each unit with probability keep_prob
    and scale it by 1 / keep_prob; the identity otherwise (or at 1.0).
    The mask is drawn from `generator` (torch's default one when None;
    a `ShardedGenerator` draws the global batch's mask and keeps x's rows)."""
    if not training or keep_prob >= 1.0:
        return x
    keep = meshlib.draw(generator, lambda m: torch.rand(
        (m,) + tuple(x.shape[1:]), generator=generator, device=x.device), x.shape[0]) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, C, T] -> [B, C]: the full-window mean."""
    return x.mean(dim=-1)
