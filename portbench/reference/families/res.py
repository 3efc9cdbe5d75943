"""Res (Tang & Lin, "Deep Residual Learning for Small-Footprint Keyword
Spotting", ICASSP 2018): 3x3 convolutions of one width over the [time, mel]
map, TF-SAME, without bias, layer i dilated 2^(i // 3) where `dilation`;
batch norms without scale or shift:

    x = ReLU(conv f) [-> average pool `pool`, VALID, stride 1 (Res8)]
    per pair (i, i + 1): y = BN_i(ReLU(conv_i x)); x = BN_{i+1}(ReLU(conv_{i+1} y) + x)
    odd layer count: x = BN_last(ReLU(conv_last x))
    mean over time and frequency -> fc (no bias)

`arch`: `layers`, `channels` (one width), `dilation`, `pool` ([time,
frequency] window or null), `classes`. No dropout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from portbench.reference.models import Leaves, Weights, batch_norm, bn_leaves, same_pad


def leaves(arch: dict, coeffs: int) -> Leaves:
    out: Leaves = {}
    c = arch["channels"]
    out["f_conv.weight"] = ((c, 1, 3, 3), "conv")
    for i in range(arch["layers"]):
        out[f"conv{i}.weight"] = ((c, c, 3, 3), "conv")
        bn_leaves(out, f"conv{i}_bn", c, scale=False, shift=False)
    out["fc.weight"] = ((arch["classes"], c), "fc")
    return out


def dropout_shape(arch: dict, batch: int) -> None:
    return None


def _conv2d(x, weight, dilation, dtype):
    t_lo, t_hi = same_pad(x.shape[-2], 3, 1, dilation)
    f_lo, f_hi = same_pad(x.shape[-1], 3, 1, dilation)
    x = F.pad(x.to(dtype), (f_lo, f_hi, t_lo, t_hi))
    return F.conv2d(x, weight.to(dtype), dilation=dilation).float()


def forward(w: Weights, feats: torch.Tensor, arch: dict, training: bool,
            keep: Optional[torch.Tensor] = None, dtype=torch.float32,
            record=None) -> torch.Tensor:
    def rate(i):
        return 2 ** (i // 3) if arch["dilation"] else 1

    def conv(x, i):
        return F.relu(_conv2d(x, w[f"conv{i}.weight"], rate(i), dtype))

    x = F.relu(_conv2d(feats[:, None], w["f_conv.weight"], 1, dtype))
    if arch.get("pool"):
        x = F.avg_pool2d(x, tuple(arch["pool"]), (1, 1))
    for i in range(0, arch["layers"] - 1, 2):
        y = batch_norm(conv(x, i), w, f"conv{i}_bn", training, record)
        x = batch_norm(conv(y, i + 1) + x, w, f"conv{i + 1}_bn", training, record)
    if arch["layers"] % 2:
        last = arch["layers"] - 1
        x = batch_norm(conv(x, last), w, f"conv{last}_bn", training, record)
    return (x.mean((2, 3)).to(dtype) @ w["fc.weight"].to(dtype).t()).float()
