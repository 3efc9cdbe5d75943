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

The `xla` path at one fixed input shape is also what is deployed:

  compile_inference — a callable for that shape: on the card the path
      captured once in a CUDA graph and replayed, on the CPU the program
      `torch.export` traces (the counterparts of JAX's AOT executable);
  export_serialized / load_serialized — that program as `torch.export`
      bytes, and back as a callable (JAX's serialized StableHLO).

As in the JAX package, neither the fused kernels nor "auto" are exported:
a kernel launched through ctypes is not an op `torch.export` can trace, so
the traced program runs the plain per-op convs and front end (cuDNN, the
dense DFT), whatever `conv_backend` and `dsp_backend` the run trained with:
the same function.
"""

from __future__ import annotations

import io
from typing import Any, Callable, Mapping, Optional, Tuple

import torch
from torch import nn

from tcresnet_tpu_torch.config import ExperimentConfig, plain_config
from tcresnet_tpu_torch.models import build_model
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.utils.device import resolve_device
from tcresnet_tpu_torch.utils.profiling import span

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
    must already be there. Each call is a `serve.request` span (`batch`, and
    `route`: "fused", or "xla" for the plain path; for "auto" the route it
    took)."""
    device = resolve_device(device)
    params, batch_stats = _weights(variables, use_ema)

    if backend not in ("xla", "fused", "auto"):
        raise ValueError(f"Unknown backend {backend!r}")
    if backend == "xla":
        return _with_matmul_precision(
            _request(_build_xla_infer(cfg, params, batch_stats, include_preprocess, device),
                     "xla"),
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
            _request(_build_xla_infer(cfg, params, batch_stats, include_preprocess, device),
                     "xla"),
            precision,
        )

    build = build_fused_infer if is_temporal else build_fused_infer2d
    fused = build(cfg.model, cfg.audio, params, batch_stats, device=device)

    def infer_fused(x: torch.Tensor) -> torch.Tensor:
        _check_input(x, device)
        return torch.softmax(fused(x), dim=-1)

    if backend == "fused":
        return _with_matmul_precision(_request(infer_fused, "fused"), precision)

    max_fused = auto_fused_max_batch(cfg.model.name)
    xla_fn = _build_xla_infer(cfg, params, batch_stats, include_preprocess, device)

    def infer_auto(x: torch.Tensor) -> torch.Tensor:
        fused_route = x.is_cuda and x.shape[0] <= max_fused
        with span("serve.request", batch=x.shape[0], route="fused" if fused_route else "xla"):
            return infer_fused(x) if fused_route else xla_fn(x)

    return _with_matmul_precision(infer_auto, precision)


def _request(fn: Callable, route: str) -> Callable:
    """`fn`, each call a `serve.request` span on `route`."""
    def served(x: torch.Tensor) -> torch.Tensor:
        with span("serve.request", batch=x.shape[0], route=route):
            return fn(x)

    return served


def _weights(variables: Mapping[str, Any], use_ema: bool):
    """(params, batch_stats) of the port's variables mapping."""
    if use_ema:
        # never silently ship raw params when the caller asked for EMA
        params = variables.get("ema_params")
        if params is None:
            raise ValueError(
                "use_ema=True but the variables mapping has no 'ema_params'"
            )
    else:
        params = variables["params"]
    return params, variables.get("batch_stats", {})


class _XlaInfer(nn.Module):
    """The `xla` path as one module, wav (or features) -> softmax: what
    build_inference_fn calls, a CUDA graph captures and torch.export
    traces."""

    def __init__(self, cfg: ExperimentConfig, params, batch_stats,
                 include_preprocess: bool, device: torch.device):
        super().__init__()
        self.audio = cfg.audio
        self.include_preprocess = include_preprocess
        self.model = build_model(
            cfg.model, dsp.feature_shape(cfg.audio), cfg.train.compute_dtype,
            device=device,
        )
        state = {k: torch.as_tensor(v) for k, v in {**params, **batch_stats}.items()}
        self.model.load_state_dict(state)
        self.requires_grad_(False)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.include_preprocess:
            x = dsp.preprocess(x, self.audio)
        return torch.softmax(self.model(x), dim=-1)


def _build_xla_infer(cfg, params, batch_stats, include_preprocess, device):
    module = _XlaInfer(cfg, params, batch_stats, include_preprocess, device)

    @torch.no_grad()
    def infer(x: torch.Tensor) -> torch.Tensor:
        _check_input(x, device)
        return module(x)

    return infer


def _input_shape(cfg: ExperimentConfig, batch_size: int,
                include_preprocess: bool) -> Tuple[int, ...]:
    """[B, N] wavs, or [B, H, W, 1] features without the front end."""
    if include_preprocess:
        return (batch_size, cfg.audio.desired_samples)
    return (batch_size,) + dsp.feature_shape(cfg.audio)


def _export(cfg, variables, batch_size, include_preprocess, use_ema, device):
    module = _XlaInfer(plain_config(cfg), *_weights(variables, use_ema), include_preprocess, device)
    example = torch.zeros(_input_shape(cfg, batch_size, include_preprocess), device=device)
    return torch.export.export(module, (example,))


class _CudaGraph:
    """`module` at input `shape` captured once in a CUDA graph, after three
    warm-up calls on a side stream (they build the front end's constants
    and load any kernel the path launches: a capture may not copy from the
    host). A call copies x into the static input, replays the graph and
    returns a copy of the static output. The graph reads the module's
    weights where they lie, so this object holds the module. TF32 is as
    the caller left it at capture. One caller at a time: the static
    buffers are shared."""

    def __init__(self, module: nn.Module, shape: Tuple[int, ...], device: torch.device):
        self.module = module
        self.static_in = torch.zeros(shape, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.no_grad(), torch.cuda.stream(side):
            for _ in range(3):
                module(self.static_in)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(self.graph):
            self.static_out = module(self.static_in)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.static_in.copy_(x)
        self.graph.replay()
        return self.static_out.clone()


def compile_inference(
    cfg: ExperimentConfig,
    variables: Mapping[str, Any],
    batch_size: int = 1,
    include_preprocess: bool = True,
    use_ema: bool = False,
    *,
    device,
) -> Tuple[Callable[[torch.Tensor], torch.Tensor], Tuple[int, ...]]:
    """The `xla` path compiled for one input shape -> (callable, shape).

    The counterpart of JAX's AOT executable (`jit(...).lower().compile()`),
    not a kernel. On a CUDA device the path is captured once in a CUDA
    graph (`_CudaGraph`: the convs and front end the config names, K7
    included, with TF32 as the caller left it) and replayed per call; on
    the CPU the callable is the program `torch.export.export` traces at
    that shape, run through its `.module()`. Either raises for an input of
    another shape or on another device."""
    device = resolve_device(device)
    shape = _input_shape(cfg, batch_size, include_preprocess)
    if device.type == "cuda":
        module = _XlaInfer(cfg, *_weights(variables, use_ema), include_preprocess, device)
        run = _CudaGraph(module, shape, device)
    else:
        run = _export(cfg, variables, batch_size, include_preprocess, use_ema, device).module()

    @torch.no_grad()
    def compiled(x: torch.Tensor) -> torch.Tensor:
        _check_input(x, device)
        if tuple(x.shape) != shape:
            raise ValueError(f"compiled for input {list(shape)}, got {list(x.shape)}")
        return run(x)

    return compiled, shape


def export_serialized(
    cfg: ExperimentConfig,
    variables: Mapping[str, Any],
    batch_size: int = 1,
    include_preprocess: bool = True,
    use_ema: bool = False,
    *,
    device,
) -> bytes:
    """The `xla` path at one batch as a serialized `torch.export` program
    (`torch.export.save`), traced on `device` (JAX's `platforms`): the
    .pb / .tflite analog. Reload with `load_serialized`."""
    program = _export(cfg, variables, batch_size, include_preprocess, use_ema,
                      resolve_device(device))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_serialized(data: bytes, device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The program `export_serialized` wrote, as a callable on the device
    it was traced on, or on `device` (its weights, lifted constants and the
    devices named in its ops moved by `torch.export.passes.
    move_to_device_pass`). It raises for an input of another shape."""
    program = torch.export.load(io.BytesIO(data))
    if device is not None:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, resolve_device(device))
    module = program.module()

    @torch.no_grad()
    def run(x: torch.Tensor) -> torch.Tensor:
        return module(x)

    return run
