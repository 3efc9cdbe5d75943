"""TC-ResNet and Res as functions of a {name: tensor} weight mapping.

TC-ResNet (Choi et al., "Temporal Convolution for Real-time Keyword Spotting
on Mobile Devices", Interspeech 2019): the MFCC axis is the channel axis and
every convolution is k x 1 along time, TF-SAME, without bias, each followed
by batch norm (epsilon 1e-3):

    conv0 3x1, ReLU
    per block of width c (stride 2 where the width changes):
        shortcut = ReLU(BN(conv 1x1 stride 2)) where the width changes
        y = ReLU(BN(conv 9x1 stride s)); y = BN(conv 9x1)
        x = ReLU(y + shortcut)
    mean over time -> dropout (training) -> fc (no bias)

Res15 (Tang & Lin, "Deep Residual Learning for Small-Footprint Keyword
Spotting", ICASSP 2018): 3x3 convolutions of one width over the [time, mel]
map, without bias, layer i dilated 2^(i // 3); batch norms without scale or
shift:

    x = ReLU(conv f)
    per pair (i, i + 1): y = BN_i(ReLU(conv_i x)); x = BN_{i+1}(ReLU(conv_{i+1} y) + x)
    odd layer count: x = BN_last(ReLU(conv_last x))
    mean over time and frequency -> fc (no bias)

Names follow the scopes of the published checkpoints (conv0_conv, conv0_bn,
block{i}_down_conv, f_conv, conv{i}_bn, fc), so one mapping of weights fits
any implementation that keeps them. `dtype` is the precision of the
convolutions and the fc; batch norm computes in float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
Weights = Dict[str, torch.Tensor]


def same_pad(n: int, k: int, stride: int = 1, dilation: int = 1) -> Tuple[int, int]:
    """TF-SAME (low, high) padding of one axis: the low side gets the smaller half."""
    span = (k - 1) * dilation + 1
    out = -(-n // stride)
    total = max((out - 1) * stride + span - n, 0)
    return total // 2, total - total // 2


def tc_blocks(channels: List[int]) -> List[Tuple[int, int, int, bool]]:
    """(block, in width, out width, has a down shortcut) per residual block."""
    return [(i, channels[i], channels[i + 1], channels[i + 1] != channels[i])
            for i in range(len(channels) - 1)]


def leaves(arch: dict, coeffs: int) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """name -> (shape, kind) of every weight, kinds: conv, fc, scale, shift
    (trained) and mean, var (batch-norm statistics)."""
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def bn(name, c, affine=True):
        if affine:
            out[f"{name}.weight"] = ((c,), "scale")
            out[f"{name}.bias"] = ((c,), "shift")
        out[f"{name}.running_mean"] = ((c,), "mean")
        out[f"{name}.running_var"] = ((c,), "var")

    if arch["family"] == "TCResNet":
        ch = arch["channels"]
        out["conv0_conv.weight"] = ((ch[0], coeffs, arch["first_kernel"]), "conv")
        bn("conv0_bn", ch[0])
        for i, ci, co, down in tc_blocks(ch):
            if down:
                out[f"block{i}_down_conv.weight"] = ((co, ci, 1), "conv")
                bn(f"block{i}_down_bn", co)
            out[f"block{i}_conv0_conv.weight"] = ((co, ci, arch["block_kernel"]), "conv")
            bn(f"block{i}_conv0_bn", co)
            out[f"block{i}_conv1_conv.weight"] = ((co, co, arch["block_kernel"]), "conv")
            bn(f"block{i}_conv1_bn", co)
        out["fc.weight"] = ((arch["classes"], ch[-1]), "fc")
    elif arch["family"] == "Res":
        c = arch["channels"]
        out["f_conv.weight"] = ((c, 1, 3, 3), "conv")
        for i in range(arch["layers"]):
            out[f"conv{i}.weight"] = ((c, c, 3, 3), "conv")
            bn(f"conv{i}_bn", c, affine=False)
        out["fc.weight"] = ((arch["classes"], c), "fc")
    else:
        raise KeyError(f"no reference model for family {arch['family']!r}")
    return out


def batch_norm(x: torch.Tensor, w: Weights, name: str, training: bool,
               record=None) -> torch.Tensor:
    """Over dim 1; batch moments (biased variance) in training, else the
    running statistics. float32 in, float32 out. With `record` = (name,
    dict) the named layer normalises with, and stores, its batch moments."""
    axes = [0] + list(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if training or (record is not None and record[0] == name):
        mean = x.mean(axes)
        var = ((x - mean.view(shape)) ** 2).mean(axes)
        if record is not None and record[0] == name:
            record[1][name] = (mean, var)
    else:
        mean, var = w[f"{name}.running_mean"], w[f"{name}.running_var"]
    y = (x - mean.view(shape)) * torch.rsqrt(var + BN_EPS).view(shape)
    if f"{name}.weight" in w:
        y = y * w[f"{name}.weight"].view(shape) + w[f"{name}.bias"].view(shape)
    return y


def _conv1d(x, weight, stride, dtype):
    lo, hi = same_pad(x.shape[-1], weight.shape[-1], stride)
    return F.conv1d(F.pad(x.to(dtype), (lo, hi)), weight.to(dtype), stride=stride).float()


def _conv2d(x, weight, dilation, dtype):
    t_lo, t_hi = same_pad(x.shape[-2], 3, 1, dilation)
    f_lo, f_hi = same_pad(x.shape[-1], 3, 1, dilation)
    x = F.pad(x.to(dtype), (f_lo, f_hi, t_lo, t_hi))
    return F.conv2d(x, weight.to(dtype), dilation=dilation).float()


def tc_resnet(w: Weights, feats: torch.Tensor, arch: dict, training: bool,
              keep: Optional[torch.Tensor] = None, dtype=torch.float32,
              record=None) -> torch.Tensor:
    """[B, frames, coeffs] features -> [B, classes] float32 logits. In
    training `keep` is the dropout mask of the pooled features."""
    def conv_bn(x, name, stride, relu=True):
        y = batch_norm(_conv1d(x, w[f"{name}_conv.weight"], stride, dtype), w,
                       f"{name}_bn", training, record)
        return F.relu(y) if relu else y

    x = conv_bn(feats.transpose(1, 2), "conv0", 1)
    for i, _, _, down in tc_blocks(arch["channels"]):
        stride = 2 if down else 1
        shortcut = conv_bn(x, f"block{i}_down", 2) if down else x
        y = conv_bn(x, f"block{i}_conv0", stride)
        y = conv_bn(y, f"block{i}_conv1", 1, relu=False)
        x = F.relu(y + shortcut)
    pooled = x.mean(-1)
    if training and arch["dropout_keep_prob"] < 1.0:
        pooled = torch.where(keep, pooled / arch["dropout_keep_prob"], 0.0)
    return (pooled.to(dtype) @ w["fc.weight"].to(dtype).t()).float()


def res(w: Weights, feats: torch.Tensor, arch: dict, training: bool = False,
        dtype=torch.float32, record=None) -> torch.Tensor:
    """[B, frames, coeffs] features -> [B, classes] float32 logits."""
    def rate(i):
        return 2 ** (i // 3) if arch["dilation"] else 1

    def conv(x, i):
        return F.relu(_conv2d(x, w[f"conv{i}.weight"], rate(i), dtype))

    if arch.get("pool"):
        raise NotImplementedError("the reference Res has no front pooling")
    x = F.relu(_conv2d(feats[:, None], w["f_conv.weight"], 1, dtype))
    for i in range(0, arch["layers"] - 1, 2):
        y = batch_norm(conv(x, i), w, f"conv{i}_bn", training, record)
        x = batch_norm(conv(y, i + 1) + x, w, f"conv{i + 1}_bn", training, record)
    if arch["layers"] % 2:
        last = arch["layers"] - 1
        x = batch_norm(conv(x, last), w, f"conv{last}_bn", training, record)
    return (x.mean((2, 3)).to(dtype) @ w["fc.weight"].to(dtype).t()).float()


def forward(w: Weights, feats: torch.Tensor, arch: dict, training: bool,
            keep: Optional[torch.Tensor] = None, dtype=torch.float32,
            record=None) -> torch.Tensor:
    if arch["family"] == "TCResNet":
        return tc_resnet(w, feats, arch, training, keep, dtype, record)
    return res(w, feats, arch, training, dtype, record)
