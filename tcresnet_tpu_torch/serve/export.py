"""Inference functions for serving (counterpart of tcresnet_tpu/serve/export.py).

`build_inference_fn` closes the weights over a wav -> softmax (or
features -> softmax) function. Backends keep the JAX package's names so
run configs carry over:

  "xla"   — the plain per-op PyTorch path: `ops.dsp.preprocess` + the
            model (cuDNN convs on the card). It is also the path the
            fused kernels are held against.
  "fused" — for a CUDA input, the temporal TC-ResNets in one kernel
            launch (K4: `ops/kernels/infer.py`, `csrc/infer.cu`) and the
            2D families (TCResNet2D8[Pool], Res, DS-CNN, KWS) in two, the
            MFCC front end (`csrc/mfcc.cu`: K2, or K8 / K9 for
            dft_variant "phases" / "radix4") and the op-list kernel
            (K5: `ops/kernels/infer2d.py`, `csrc/infer2d.cu`); the
            kernels' plain versions for a CPU input. It raises for a
            model or geometry that no kernel serves.
  "auto"  — "fused" when the input tensor is on a CUDA device and its
            batch is at most `auto_fused_max_batch(name)`, else "xla".

Not in this slice (ROADMAP.md Queue 1 item 10): `compile_inference` and
the serialized artifact (`torch.export`).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import torch

from tcresnet_tpu_torch.config import ExperimentConfig
from tcresnet_tpu_torch.models import build_model
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.utils.device import resolve_device

# Largest batch "auto" serves through the fused kernel, per family. These
# values are the JAX package's routing table, copied as they are; the
# crossover on the H100 is still to be measured (ROADMAP.md).
_AUTO_FUSED_MAX_BATCH = {
    "TCResNet8": 32, "TCResNet14": 32,
    "Res8": 32, "Res8Narrow": 32, "Res15": 32, "Res15Narrow": 32,
    "DSCNNS": 8, "DSCNNM": 8, "DSCNNL": 8,
    "ResNet2D8": 4, "ResNet2D8Pool": 8,
    "KWS": 4,
}


def auto_fused_max_batch(model_name: str) -> int:
    """Largest batch `backend="auto"` serves via the fused kernel."""
    return _AUTO_FUSED_MAX_BATCH.get(model_name, 32)


def _with_matmul_precision(fn: Callable, precision: Optional[str]) -> Callable:
    """precision="highest": run `fn` with TF32 off in both cuBLAS matmuls
    and cuDNN convolutions, restoring both flags afterwards. cuDNN convs
    default to TF32 (about three decimal digits), which alone breaks the
    1e-5 softmax gate. None leaves PyTorch's settings as they are."""
    if precision is None:
        return fn
    if precision != "highest":
        raise ValueError(f"precision must be None or 'highest', got {precision!r}")

    def wrapped(x: torch.Tensor) -> torch.Tensor:
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        cudnn_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(x)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
            torch.backends.cudnn.allow_tf32 = cudnn_tf32

    return wrapped


def _check_input(x: torch.Tensor, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"input on {x.device}, inference function on {device}")


def build_inference_fn(
    cfg: ExperimentConfig,
    variables: Mapping[str, Any],
    include_preprocess: bool = True,
    use_ema: bool = False,
    backend: str = "xla",
    precision: Optional[str] = None,
    *,
    device,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """wav [B, N] (or features [B, H, W, 1]) -> softmax [B, num_classes].

    `variables` is the port's {"params", "batch_stats"[, "ema_params"]}
    mapping (models/convert.py). The weights move to `device` once; inputs
    must already be there."""
    device = resolve_device(device)
    if use_ema:
        # never silently ship raw params when the caller asked for EMA
        params = variables.get("ema_params")
        if params is None:
            raise ValueError(
                "use_ema=True but the variables mapping has no 'ema_params'"
            )
    else:
        params = variables["params"]
    batch_stats = variables.get("batch_stats", {})

    if backend not in ("xla", "fused", "auto"):
        raise ValueError(f"Unknown backend {backend!r}")
    if backend == "xla":
        return _with_matmul_precision(
            _build_xla_infer(cfg, params, batch_stats, include_preprocess, device),
            precision,
        )

    from tcresnet_tpu_torch.ops.kernels.infer import build_fused_infer, fused_infer_available
    from tcresnet_tpu_torch.ops.kernels.infer2d import (
        build_fused_infer2d,
        fused_infer2d_available,
    )

    is_temporal = fused_infer_available(cfg.model, cfg.audio)
    supported = include_preprocess and (
        is_temporal or fused_infer2d_available(cfg.model, cfg.audio))
    if not supported:
        if backend == "fused":
            raise ValueError(
                "backend='fused' needs include_preprocess and a supported "
                f"model/feature geometry (model={cfg.model.name})"
            )
        return _with_matmul_precision(
            _build_xla_infer(cfg, params, batch_stats, include_preprocess, device),
            precision,
        )

    build = build_fused_infer if is_temporal else build_fused_infer2d
    fused = build(cfg.model, cfg.audio, params, batch_stats, device=device)

    def infer_fused(x: torch.Tensor) -> torch.Tensor:
        _check_input(x, device)
        return torch.softmax(fused(x), dim=-1)

    if backend == "fused":
        return _with_matmul_precision(infer_fused, precision)

    max_fused = auto_fused_max_batch(cfg.model.name)
    xla_fn = _build_xla_infer(cfg, params, batch_stats, include_preprocess, device)

    def infer_auto(x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda and x.shape[0] <= max_fused:
            return infer_fused(x)
        return xla_fn(x)

    return _with_matmul_precision(infer_auto, precision)


def _build_xla_infer(cfg, params, batch_stats, include_preprocess, device):
    model = build_model(
        cfg.model, dsp.feature_shape(cfg.audio), cfg.train.compute_dtype,
        device=device,
    )
    state = {k: torch.as_tensor(v) for k, v in {**params, **batch_stats}.items()}
    model.load_state_dict(state)

    @torch.no_grad()
    def infer(x: torch.Tensor) -> torch.Tensor:
        _check_input(x, device)
        if include_preprocess:
            x = dsp.preprocess(x, cfg.audio)
        return torch.softmax(model(x), dim=-1)

    return infer
