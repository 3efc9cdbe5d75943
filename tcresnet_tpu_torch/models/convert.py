"""Carrying weights between the JAX (Flax) layout and the port's.

The port never sees a jax type: a Flax pytree arrives as nested dicts of
numpy arrays (`jax.device_get` plus a tree map to numpy, done by the
caller). Mapping is by model family and scope name (`scope_kind`), never
by kernel shape: a TCResNet2D8 1x1 "down" kernel [1, 1, Ci, Co] is a 2D
conv, a TCResNet8 one [k, 1, Ci, Co] a temporal conv.

  temporal conv  kernel [k, 1, Ci, Co]       -> "{scope}.weight" [Co, Ci, k]
  2D conv        kernel [kh, kw, Ci/g, Co]   -> "{scope}.weight" [Co, Ci/g, kh, kw]
                 bias [Co]                   -> "{scope}.bias"
  dense          kernel [in, out], bias      -> "{scope}.weight" [out, in], ".bias"
  batch norm     scale | bias (where present)-> "{scope}.weight" | ".bias"
  KWS SVDF       weights_frequency, weights_time, bias (top-level leaves)
                                             -> the same names, same layout
  batch_stats[scope]["mean" | "var"]         -> "{scope}.running_mean" | "_var"

A batch norm with neither scale nor shift (Res) has no params entry in
Flax and none here: only its running statistics.

`jax_path` gives each port name the '/'-joined Flax path it maps to
("conv0_conv.weight" -> "conv0_conv/kernel", "conv0_bn.running_mean" ->
"conv0_bn/mean"): the path the JAX package matches scope regexes
against, so a scope selects the same tensors in both packages.

The port's variables are {"params": {...}, "batch_stats": {...}} with an
optional "ema_params", each a flat {state-dict name: tensor} mapping; the
EMA copy replaces "params" only, as in the JAX package.
`variables_to_jax` carries them back, BN running statistics included.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from tcresnet_tpu_torch.config import ModelConfig
from tcresnet_tpu_torch.models import build_model

Nested = Mapping[str, Any]

_TC_SCOPE = r"conv0|block\d+_(down|conv0|conv1)"
_DS_SCOPE = r"conv_1|conv_ds_\d+_(dw|pw)"
# family -> ((scope pattern, kind), ...); the first full match wins
_FAMILY_SCOPES = {
    "tc": ((rf"({_TC_SCOPE})_conv", "temporal"), (rf"({_TC_SCOPE})_bn", "bn"), ("fc", "dense")),
    "tc2d": ((rf"({_TC_SCOPE})_conv", "conv2d"), (rf"({_TC_SCOPE})_bn", "bn"), ("fc", "dense")),
    "res": ((r"f_conv|conv\d+", "conv2d"), (r"conv\d+_bn", "bn"), ("fc", "dense")),
    "dscnn": ((_DS_SCOPE, "conv2d"), (rf"({_DS_SCOPE})_bn", "bn"), ("fc1", "dense")),
    "kws": ((r"conv[12]", "conv2d"), (r"fc[123]?|lin", "dense"),
            (r"weights_frequency|weights_time|bias", "leaf")),
}


def family(model_name: str) -> str:
    if model_name in ("TCResNet8", "TCResNet14"):
        return "tc"
    if model_name.startswith("ResNet2D8"):
        return "tc2d"
    if model_name.startswith("Res"):
        return "res"
    if model_name.startswith("DSCNN"):
        return "dscnn"
    if model_name == "KWS":
        return "kws"
    raise KeyError(f"Unknown model {model_name!r}")


def scope_kind(model_name: str, scope: str) -> str:
    """"temporal", "conv2d", "dense", "bn" or "leaf": how a Flax scope of
    the family maps; KeyError for a scope the family does not have."""
    for pattern, kind in _FAMILY_SCOPES[family(model_name)]:
        if re.fullmatch(pattern, scope):
            return kind
    raise KeyError(f"no port counterpart for Flax scope {scope!r} of {model_name}")


# port leaf -> Flax leaf: BN params, the other kinds' params, BN statistics
_BN_LEAVES = {"weight": "scale", "bias": "bias"}
_STAT_LEAVES = {"running_mean": "mean", "running_var": "var"}


def _jax_leaf(kind: str, leaf: str) -> str:
    if kind == "bn":
        return _BN_LEAVES[leaf]
    return "bias" if leaf == "bias" else "kernel"


def jax_path(model_name: str, name: str) -> str:
    """The '/'-joined Flax path of the port's params or batch_stats `name`
    in `model_name`'s family; KeyError for a name the family lacks."""
    scope, _, leaf = name.rpartition(".")
    if not scope:
        if scope_kind(model_name, leaf) != "leaf":
            raise KeyError(f"no Flax counterpart for port name {name!r}")
        return leaf
    if leaf in _STAT_LEAVES:
        return f"{scope}/{_STAT_LEAVES[leaf]}"
    return f"{scope}/{_jax_leaf(scope_kind(model_name, scope), leaf)}"


def _f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _params_from_jax(model_name: str, params: Nested) -> Dict[str, torch.Tensor]:
    out = {}
    for scope, leaves in params.items():
        kind = scope_kind(model_name, scope)
        if kind == "leaf":
            out[scope] = _f32(leaves)
            continue
        leaves = dict(leaves)
        kern = leaves.pop("kernel", None)
        if kind == "bn":
            names = {v: k for k, v in _BN_LEAVES.items()}
        else:
            names = {"bias": "bias"}
            if kind == "temporal":
                kern = np.asarray(kern)
                if kern.ndim != 4 or kern.shape[1] != 1:
                    raise ValueError(f"{scope}: expected a [k, 1, Ci, Co] kernel, got {kern.shape}")
                out[f"{scope}.weight"] = _f32(kern[:, 0].transpose(2, 1, 0))
            elif kind == "conv2d":
                out[f"{scope}.weight"] = _f32(np.asarray(kern).transpose(3, 2, 0, 1))
            else:  # dense
                out[f"{scope}.weight"] = _f32(np.asarray(kern).T)
        for leaf, value in leaves.items():
            if leaf not in names:
                raise KeyError(f"no port counterpart for Flax leaf {scope}/{leaf}")
            out[f"{scope}.{names[leaf]}"] = _f32(value)
    return out


def variables_from_jax(
    model_cfg: ModelConfig, params: Nested, batch_stats: Nested,
    ema_params: Optional[Nested] = None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Flax {params, batch_stats[, ema_params]} of `model_cfg`'s family, as
    numpy -> port variables."""
    stats = {}
    for scope, leaves in batch_stats.items():
        for leaf, jleaf in _STAT_LEAVES.items():
            stats[f"{scope}.{leaf}"] = _f32(leaves[jleaf])
    out = {"params": _params_from_jax(model_cfg.name, params), "batch_stats": stats}
    if ema_params is not None:
        out["ema_params"] = _params_from_jax(model_cfg.name, ema_params)
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A float32 numpy COPY (a CPU tensor's .numpy() would share memory
    with a tensor that training updates in place)."""
    return np.array(t.detach().cpu(), dtype=np.float32)


def _params_to_jax(model_name: str, params: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, t in params.items():
        scope, _, leaf = name.rpartition(".")
        a = _host(t)
        if not scope:
            if scope_kind(model_name, leaf) != "leaf":
                raise KeyError(f"no Flax counterpart for port parameter {name!r}")
            out[leaf] = a
            continue
        kind = scope_kind(model_name, scope)
        jleaf = _jax_leaf(kind, leaf)
        if jleaf == "kernel":
            if kind == "temporal":
                a = a.transpose(2, 1, 0)[:, None]
            elif kind == "conv2d":
                a = a.transpose(2, 3, 1, 0)
            else:  # dense
                a = a.T
            a = np.ascontiguousarray(a)
        out.setdefault(scope, {})[jleaf] = a
    return out


def variables_to_jax(model_cfg: ModelConfig,
                     variables: Mapping[str, Mapping[str, Any]]) -> Dict[str, Nested]:
    """Port variables of `model_cfg`'s family (tensors on any device) ->
    Flax {params, batch_stats[, ema_params]} as numpy: the inverse of
    `variables_from_jax`, BN running statistics included."""
    stats: Dict[str, Dict[str, np.ndarray]] = {}
    for name, t in variables["batch_stats"].items():
        scope, leaf = name.rsplit(".", 1)
        stats.setdefault(scope, {})[_STAT_LEAVES[leaf]] = _host(t)
    out = {"params": _params_to_jax(model_cfg.name, variables["params"]), "batch_stats": stats}
    if variables.get("ema_params") is not None:
        out["ema_params"] = _params_to_jax(model_cfg.name, variables["ema_params"])
    return out


def seeded_variables(
    model_cfg: ModelConfig, feature_shape: Tuple[int, int, int], seed: int
) -> Dict[str, Dict[str, Any]]:
    """JAX-layout {params, batch_stats} made from numpy alone, the same on
    every machine, drawn in Flax's module creation order:

    - the CNN families: glorot-uniform kernels, biases uniform in
      [-0.1, 0.1];
    - KWS: truncated-normal kernels and biases (stddev 0.01, 0.001 for
      single_fc, cut at two standard deviations, as Flax's initializer);
    - batch norm: scale, shift, mean and variance drawn away from their
      identity values, so that BN folding is exercised."""
    rng = np.random.default_rng(seed)
    is_kws = model_cfg.name == "KWS"
    std = 0.001 if model_cfg.kws_architecture == "single_fc" else 0.01

    def uniform(lo, hi, shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def truncated(shape):
        z = rng.standard_normal(shape)
        while (bad := np.abs(z) > 2).any():
            z[bad] = rng.standard_normal(int(bad.sum()))
        return (z * std / 0.87962566103423978).astype(np.float32)

    def kernel(shape, fan_in, fan_out):
        if is_kws:
            return truncated(shape)
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        return uniform(-limit, limit, shape)

    def bias(n):
        return truncated((n,)) if is_kws else uniform(-0.1, 0.1, (n,))

    params: Dict[str, Any] = {}
    stats: Dict[str, Dict[str, np.ndarray]] = {}
    model = build_model(model_cfg, feature_shape, device="meta")
    for name, p in model.named_parameters(recurse=False):  # the KWS SVDF's leaves
        params[name] = bias(p.shape[0]) if name == "bias" else truncated(tuple(p.shape))
    for name, mod in model.named_children():
        kind = scope_kind(model_cfg.name, name)
        if kind == "bn":
            c = mod.running_mean.shape[0]
            entry = {}
            if mod.weight is not None:
                entry["scale"] = uniform(0.5, 1.5, (c,))
            if mod.bias is not None:
                entry["bias"] = uniform(-0.5, 0.5, (c,))
            if entry:
                params[name] = entry
            stats[name] = {"mean": uniform(-1.0, 1.0, (c,)), "var": uniform(0.5, 1.5, (c,))}
            continue
        w = mod.weight
        if kind == "temporal":
            co, ci, k = w.shape
            entry = {"kernel": kernel((k, 1, ci, co), k * ci, k * co)}
        elif kind == "conv2d":
            co, ci, kh, kw = w.shape
            entry = {"kernel": kernel((kh, kw, ci, co), kh * kw * ci, kh * kw * co)}
        else:  # dense
            out_f, in_f = w.shape
            entry = {"kernel": kernel((in_f, out_f), in_f, out_f)}
        if getattr(mod, "bias", None) is not None:
            entry["bias"] = bias(w.shape[0])
        params[name] = entry
    return {"params": params, "batch_stats": stats}
