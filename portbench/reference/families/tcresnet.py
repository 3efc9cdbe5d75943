"""TC-ResNet (Choi et al., "Temporal Convolution for Real-time Keyword
Spotting on Mobile Devices", Interspeech 2019): the MFCC axis is the channel
axis and every convolution is k x 1 along time, TF-SAME, without bias, each
followed by batch norm with scale and shift:

    conv0 3x1, ReLU
    per block of width c (stride 2 where the width changes):
        shortcut = ReLU(BN(conv 1x1 stride 2)) where the width changes
        y = ReLU(BN(conv 9x1 stride s)); y = BN(conv 9x1)
        x = ReLU(y + shortcut)
    mean over time -> dropout (training) -> fc (no bias)

`arch`: `channels` (the stem's width, then each block's), `first_kernel`,
`block_kernel`, `classes`, `dropout_keep_prob`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.models import Leaves, Weights, batch_norm, bn_leaves, same_pad


def tc_blocks(channels: List[int]) -> List[Tuple[int, int, int, bool]]:
    """(block, in width, out width, has a down shortcut) per residual block."""
    return [(i, channels[i], channels[i + 1], channels[i + 1] != channels[i])
            for i in range(len(channels) - 1)]


def leaves(arch: dict, coeffs: int) -> Leaves:
    out: Leaves = {}
    ch = arch["channels"]
    out["conv0_conv.weight"] = ((ch[0], coeffs, arch["first_kernel"]), "conv")
    bn_leaves(out, "conv0_bn", ch[0])
    for i, ci, co, down in tc_blocks(ch):
        if down:
            out[f"block{i}_down_conv.weight"] = ((co, ci, 1), "conv")
            bn_leaves(out, f"block{i}_down_bn", co)
        out[f"block{i}_conv0_conv.weight"] = ((co, ci, arch["block_kernel"]), "conv")
        bn_leaves(out, f"block{i}_conv0_bn", co)
        out[f"block{i}_conv1_conv.weight"] = ((co, co, arch["block_kernel"]), "conv")
        bn_leaves(out, f"block{i}_conv1_bn", co)
    out["fc.weight"] = ((arch["classes"], ch[-1]), "fc")
    return out


def dropout_shape(arch: dict, batch: int) -> Tuple[int, int]:
    """The mask of the pooled features."""
    return batch, arch["channels"][-1]


def _conv1d(x, weight, stride, dtype):
    lo, hi = same_pad(x.shape[-1], weight.shape[-1], stride)
    return F.conv1d(F.pad(x.to(dtype), (lo, hi)), weight.to(dtype), stride=stride).float()


def forward(w: Weights, feats: torch.Tensor, arch: dict, training: bool,
            keep: Optional[torch.Tensor] = None, dtype=torch.float32,
            record=None) -> torch.Tensor:
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
