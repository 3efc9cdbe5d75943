"""Carrying weights between the JAX (Flax) layout and the port's.

The port never sees a jax type: a Flax pytree arrives as nested dicts of
numpy arrays (`jax.device_get` plus a tree map to numpy, done by the
caller). Mapping is by scope name, not position:

  params[scope]["kernel"] [k, 1, Ci, Co]  -> "{scope}.weight" [Co, Ci, k]
  params["fc"]["kernel"]  [in, out]       -> "fc.weight"      [out, in]
  params[scope_bn]["scale" | "bias"]      -> "{scope}.weight" | ".bias"
  batch_stats[scope_bn]["mean" | "var"]   -> "{scope}.running_mean" | "_var"

The port's variables are {"params": {...}, "batch_stats": {...}} with an
optional "ema_params", each a flat {state-dict name: tensor} mapping; the
EMA copy replaces "params" only, as in the JAX package.
`variables_to_jax` carries them back, BN running statistics included.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from tcresnet_tpu.config import ModelConfig
from tcresnet_tpu_torch.models import build_model, layers

Nested = Mapping[str, Mapping[str, Any]]


def _f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _params_from_jax(params: Nested) -> Dict[str, torch.Tensor]:
    out = {}
    for scope, leaves in params.items():
        if scope.endswith("_bn"):
            out[f"{scope}.weight"] = _f32(leaves["scale"])
            out[f"{scope}.bias"] = _f32(leaves["bias"])
        elif scope == "fc":
            out["fc.weight"] = _f32(np.asarray(leaves["kernel"]).T)
        elif scope.endswith("_conv"):
            kern = np.asarray(leaves["kernel"])
            if kern.ndim != 4 or kern.shape[1] != 1:
                raise ValueError(f"{scope}: expected a [k, 1, Ci, Co] kernel, got {kern.shape}")
            out[f"{scope}.weight"] = _f32(kern[:, 0].transpose(2, 1, 0))
        else:
            raise KeyError(f"no port counterpart for Flax scope {scope!r}")
    return out


def variables_from_jax(
    params: Nested, batch_stats: Nested, ema_params: Optional[Nested] = None
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Flax {params, batch_stats[, ema_params]} as numpy -> port variables."""
    stats = {}
    for scope, leaves in batch_stats.items():
        stats[f"{scope}.running_mean"] = _f32(leaves["mean"])
        stats[f"{scope}.running_var"] = _f32(leaves["var"])
    out = {"params": _params_from_jax(params), "batch_stats": stats}
    if ema_params is not None:
        out["ema_params"] = _params_from_jax(ema_params)
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A float32 numpy COPY (a CPU tensor's .numpy() would share memory
    with a tensor that training updates in place)."""
    return np.array(t.detach().cpu(), dtype=np.float32)


def _params_to_jax(params: Mapping[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, t in params.items():
        scope, leaf = name.rsplit(".", 1)
        a = _host(t)
        if scope.endswith("_bn"):
            out.setdefault(scope, {})["scale" if leaf == "weight" else "bias"] = a
        elif scope == "fc":
            out[scope] = {"kernel": np.ascontiguousarray(a.T)}
        elif scope.endswith("_conv"):
            out[scope] = {"kernel": np.ascontiguousarray(a.transpose(2, 1, 0)[:, None])}
        else:
            raise KeyError(f"no Flax counterpart for port parameter {name!r}")
    return out


def variables_to_jax(variables: Mapping[str, Mapping[str, Any]]) -> Dict[str, Nested]:
    """Port variables (tensors on any device) -> Flax {params, batch_stats
    [, ema_params]} as numpy: the inverse of `variables_from_jax`, BN
    running statistics included."""
    stats: Dict[str, Dict[str, np.ndarray]] = {}
    for name, t in variables["batch_stats"].items():
        scope, leaf = name.rsplit(".", 1)
        key = {"running_mean": "mean", "running_var": "var"}[leaf]
        stats.setdefault(scope, {})[key] = _host(t)
    out = {"params": _params_to_jax(variables["params"]), "batch_stats": stats}
    if variables.get("ema_params") is not None:
        out["ema_params"] = _params_to_jax(variables["ema_params"])
    return out


def seeded_variables(
    model_cfg: ModelConfig, feature_shape: Tuple[int, int, int], seed: int
) -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
    """JAX-layout {params, batch_stats} made from numpy alone, the same on
    every machine: glorot-uniform kernels, and BN scale, bias, mean and
    variance drawn away from their identity values so that BN folding is
    exercised. Drawn in Flax's module creation order."""
    rng = np.random.default_rng(seed)

    def uniform(lo, hi, shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def glorot(shape, fan_in, fan_out):
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        return uniform(-limit, limit, shape)

    params: Dict[str, Dict[str, np.ndarray]] = {}
    stats: Dict[str, Dict[str, np.ndarray]] = {}
    model = build_model(model_cfg, feature_shape, device="meta")
    for name, mod in model.named_children():
        if isinstance(mod, layers.TemporalConv):
            co, ci, k = mod.weight.shape
            params[name] = {"kernel": glorot((k, 1, ci, co), k * ci, k * co)}
        elif isinstance(mod, layers.SlimBatchNorm):
            c = mod.weight.shape[0]
            params[name] = {"scale": uniform(0.5, 1.5, (c,)),
                            "bias": uniform(-0.5, 0.5, (c,))}
            stats[name] = {"mean": uniform(-1.0, 1.0, (c,)),
                           "var": uniform(0.5, 1.5, (c,))}
        elif name == "fc":
            out_f, in_f = mod.weight.shape
            params[name] = {"kernel": glorot((in_f, out_f), in_f, out_f)}
        else:
            raise TypeError(f"unexpected submodule {name!r}")
    return {"params": params, "batch_stats": stats}
