"""DS-CNN (Zhang, Suda, Lai & Chandra, "Hello Edge: Keyword Spotting on
Microcontrollers", arXiv:1711.07128; the DS-CNN of ARM's ML-KWS-for-MCU):
one standard convolution, then depthwise-separable blocks over the [time,
MFCC] map, every convolution TF-SAME:

    x = ReLU(BN(conv k_t x k_f stride s  + bias))            (conv_1)
    per separable block i (stride s on its depthwise conv):
        x = ReLU(BN(depthwise 3 x 3 stride s + bias))         (conv_ds_i_dw)
        x = ReLU(BN(pointwise 1 x 1 + bias))                  (conv_ds_i_pw)
    mean over time and frequency -> fc1 (with a bias)

as the original TF recipe builds it: slim's conv layers take a xavier
weight and a zero bias that is kept (`activation_fn=None`, so batch norm is
a layer of its own and not slim's `normalizer_fn`, which would drop the
bias); the separable block is `slim.separable_convolution2d` with
`num_outputs=None` and depth multiplier 1 (the depthwise part alone), then
a 1 x 1 `slim.convolution2d`; each batch norm is `slim.batch_norm` with
`center=True, scale=False` (a shift, no scale), decay 0.96, epsilon 1e-3,
ReLU after it; the head is a VALID average pool over the whole map and a
`slim.fully_connected` with a bias and no activation. The JAX package's
DS-CNN module records the same semantics.

Departures: the names are the port's `state_dict` keys (`conv_ds_i_dw`,
`conv_ds_i_pw`, `<conv>_bn`, `fc1`), not the TF scopes
(`conv_ds_i/depthwise_conv`, `conv_ds_i/dw_conv/batch_norm`, ...); the
depthwise weight is [C, 1, 3, 3] with groups = C (TF's [3, 3, C, 1]). The
decay only moves the running statistics, which a training step leaves
uncompared. Each conv bias is followed by a batch norm in training mode,
so its true gradient is zero: what a step computes for it is rounding
noise (`compare.QUIET` leaves such leaves out of the change gaps).

`arch`: `blocks` (each {type "conv" | "separable", depth, kernel [t, f],
stride [t, f], name}, as the port's `L_NET_DEF`), `classes`. No dropout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from portbench.reference.models import Leaves, Weights, batch_norm, bn_leaves, same_pad


def convs(arch: dict):
    """(name, in width, out width, kernel, stride, groups) of every
    convolution in forward order."""
    out, c = [], 1
    for b in arch["blocks"]:
        kernel, stride = tuple(b["kernel"]), tuple(b["stride"])
        if b["type"] == "conv":
            out.append((b["name"], c, b["depth"], kernel, stride, 1))
        elif b["type"] == "separable":
            out.append((f"{b['name']}_dw", c, c, kernel, stride, c))
            out.append((f"{b['name']}_pw", c, b["depth"], (1, 1), (1, 1), 1))
        else:
            raise ValueError(f"block type {b['type']!r} is not a DS-CNN block")
        c = b["depth"]
    return out


def leaves(arch: dict, coeffs: int) -> Leaves:
    out: Leaves = {}
    c = 1
    for name, ci, co, kernel, _, groups in convs(arch):
        out[f"{name}.weight"] = ((co, ci // groups) + kernel, "conv")
        out[f"{name}.bias"] = ((co,), "shift")
        bn_leaves(out, f"{name}_bn", co, scale=False)
        c = co
    out["fc1.weight"] = ((arch["classes"], c), "fc")
    out["fc1.bias"] = ((arch["classes"],), "shift")
    return out


def dropout_shape(arch: dict, batch: int) -> None:
    return None


def _conv2d(x, weight, bias, kernel, stride, groups, dtype):
    t_lo, t_hi = same_pad(x.shape[-2], kernel[0], stride[0])
    f_lo, f_hi = same_pad(x.shape[-1], kernel[1], stride[1])
    x = F.pad(x.to(dtype), (f_lo, f_hi, t_lo, t_hi))
    return F.conv2d(x, weight.to(dtype), bias.to(dtype), stride=stride, groups=groups).float()


def forward(w: Weights, feats: torch.Tensor, arch: dict, training: bool,
            keep: Optional[torch.Tensor] = None, dtype=torch.float32,
            record=None) -> torch.Tensor:
    x = feats[:, None]  # [B, 1, frames, coeffs]
    for name, _, _, kernel, stride, groups in convs(arch):
        x = _conv2d(x, w[f"{name}.weight"], w[f"{name}.bias"], kernel, stride, groups, dtype)
        x = F.relu(batch_norm(x, w, f"{name}_bn", training, record))
    pooled = x.mean((2, 3))
    return F.linear(pooled.to(dtype), w["fc1.weight"].to(dtype), w["fc1.bias"].to(dtype)).float()
