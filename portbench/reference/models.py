"""The reference model of a configuration, found by its `family`, and the
layers the families share.

`leaves`, `forward` and `dropout_shape` call the family's module,
`families/<family, lower-case>.py` (families/__init__.py gives what it
provides); a family without a file raises KeyError naming the file looked
for, and never runs another family's model. Adding a family is adding its
file.

Every convolution is TF-SAME (`same_pad`, the zero padding made explicit);
batch norm (epsilon 1e-3) computes in float32 and applies a scale and a
shift where the layer has them. Names follow the scopes of the published
checkpoints (conv0_conv, conv0_bn, f_conv, conv{i}_bn, fc), so one mapping
of weights fits any implementation that keeps them. `dtype` is the
precision of the convolutions and the fc.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict, Optional, Tuple

import torch

from portbench.reference import find

BN_EPS = 1e-3
Weights = Dict[str, torch.Tensor]
Leaves = Dict[str, Tuple[Tuple[int, ...], str]]


def same_pad(n: int, k: int, stride: int = 1, dilation: int = 1) -> Tuple[int, int]:
    """TF-SAME (low, high) padding of one axis: the low side gets the smaller half."""
    span = (k - 1) * dilation + 1
    out = -(-n // stride)
    total = max((out - 1) * stride + span - n, 0)
    return total // 2, total - total // 2


def family(arch: dict) -> ModuleType:
    """The module of `arch["family"]`."""
    return find("families", arch["family"])


def leaves(arch: dict, coeffs: int) -> Leaves:
    """name -> (shape, kind) of every weight, kinds: conv, fc, scale, shift
    (trained) and mean, var (batch-norm statistics)."""
    return family(arch).leaves(arch, coeffs)


def forward(w: Weights, feats: torch.Tensor, arch: dict, training: bool,
            keep: Optional[torch.Tensor] = None, dtype=torch.float32,
            record=None) -> torch.Tensor:
    """[B, frames, coeffs] features -> [B, classes] float32 logits. In
    training `keep` is the dropout mask (`dropout_shape`)."""
    return family(arch).forward(w, feats, arch, training, keep, dtype, record)


def dropout_shape(arch: dict, batch: int) -> Optional[Tuple[int, ...]]:
    """The dropout mask's shape at `batch`, or None where there is none."""
    return family(arch).dropout_shape(arch, batch)


def bn_leaves(out: Leaves, name: str, c: int, scale: bool = True, shift: bool = True) -> None:
    """A batch norm of width `c` into `out`: its scale and shift where it has
    them, then its statistics."""
    if scale:
        out[f"{name}.weight"] = ((c,), "scale")
    if shift:
        out[f"{name}.bias"] = ((c,), "shift")
    out[f"{name}.running_mean"] = ((c,), "mean")
    out[f"{name}.running_var"] = ((c,), "var")


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
        y = y * w[f"{name}.weight"].view(shape)
    if f"{name}.bias" in w:
        y = y + w[f"{name}.bias"].view(shape)
    return y
