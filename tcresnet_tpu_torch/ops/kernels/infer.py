"""Whole-model TC-ResNet inference: wav -> logits in one CUDA launch.

Counterpart of tcresnet_tpu/ops/pallas/infer.py (kernel K4). The kernel
itself is `csrc/infer.cu`; its source note says what bounds it on the
H100 and how its design differs from the TPU kernel's. This module:

- folds eval-mode BatchNorm into each conv once, on the host
  (`_fold_conv_bn`, epsilon 1e-3), and flattens the residual structure
  into a conv list with roles (`build_layer_spec`);
- lays the folded constants out for the kernel and copies them to the
  device once (`build_fused_infer` -> `FusedInfer`);
- holds the kernel's plain PyTorch version (`fused_infer_reference`),
  which does the same folding and the same per-tap matmuls;
- dispatches (`fused_infer`): a CPU tensor goes to the plain version, a
  CUDA tensor to the kernel, and anything else raises. There is no
  fallback from the kernel to the plain version: a failed build or
  launch raises.

`launches` counts kernel launches (and nothing else), so a run can show
that its serving path went through the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tcresnet_tpu_torch.config import AudioConfig, ModelConfig
from tcresnet_tpu_torch.models import layers
from tcresnet_tpu_torch.models.tc_resnet import TC_CHANNELS, block_plan, scaled_channels
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.ops.kernels import _build, mfcc

# Kernel launches since import (or since a caller reset it to 0).
launches = 0

_MAX_CONVS = 32  # K4_MAX_CONVS in csrc/infer.cu
_ROLES = {"conv0": 0, "down": 1, "block0": 2, "block1": 3}


# ---------------------------------------------------------------------------
# geometry and availability
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Geometry:
    fe: mfcc.FrontEndGeometry  # K4's FP32 front end's (csrc/frontend.cuh)
    act_max: int  # largest conv activation, T * C floats
    region_a: int
    smem_bytes: int


def _conv_shapes(model_cfg: ModelConfig, t: int) -> List[Tuple[int, int]]:
    """(out rows, out channels) of every conv in spec order."""
    channels = scaled_channels(model_cfg.name, model_cfg.width_multiplier)
    shapes = [(t, channels[0])]
    for _, n, down in block_plan(channels):
        to = -(-t // 2) if down else t
        shapes += ([(to, n)] if down else []) + [(to, n), (to, n)]
        t = to
    return shapes


def _geometry(model_cfg: ModelConfig, audio_cfg: AudioConfig) -> _Geometry:
    fe = mfcc.front_end_geometry(audio_cfg, audio_cfg.desired_samples)
    act_max = max(t * c for t, c in _conv_shapes(model_cfg, fe.frames))
    region_a, region_b = fe.regions(3 * act_max)
    c_last = scaled_channels(model_cfg.name, model_cfg.width_multiplier)[-1]
    smem = 4 * (region_a + region_b + c_last)
    return _Geometry(fe, act_max, region_a, smem)


def fused_infer_available(model_cfg: ModelConfig, audio_cfg: AudioConfig) -> bool:
    """The kernel serves the temporal TC-ResNets on both spectral front
    ends, at hop-decomposable geometry (window % hop == 0, n % hop == 0,
    n >= window; the JAX kernel's condition), with 16-byte aligned frames
    (hop and window multiples of 4), conv widths that are multiples of 4
    (every preset's), and a shared-memory plan that fits one Hopper block."""
    if model_cfg.name not in TC_CHANNELS:
        return False
    n = audio_cfg.desired_samples
    window, hop = audio_cfg.window_size_samples, audio_cfg.window_stride_samples
    if window % hop or n % hop or not mfcc.front_end_supported(audio_cfg, n):
        return False
    geom = _geometry(model_cfg, audio_cfg)
    shapes = _conv_shapes(model_cfg, geom.fe.frames)
    # a conv thread computes 4 output channels from 16-byte weight loads
    quads = all(c % 4 == 0 for _, c in shapes)
    return quads and geom.smem_bytes <= mfcc.SMEM_LIMIT and len(shapes) <= _MAX_CONVS


# ---------------------------------------------------------------------------
# weight folding: conv kernel + BN running stats -> (W [k*Cin, Cout], b)
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _fold_conv_bn(params: Mapping[str, Any], stats: Mapping[str, Any],
                  name: str) -> Tuple[np.ndarray, np.ndarray]:
    """Port-layout conv weight [Co, Ci, k] + BN -> (W [k*Ci, Co], b [Co]),
    in float32 numpy exactly as the JAX kernel folds."""
    kern = _np(params[f"{name}_conv.weight"]).astype(np.float32).transpose(2, 1, 0)
    gamma = _np(params[f"{name}_bn.weight"]).astype(np.float32)
    beta = _np(params[f"{name}_bn.bias"]).astype(np.float32)
    mean = _np(stats[f"{name}_bn.running_mean"]).astype(np.float32)
    var = _np(stats[f"{name}_bn.running_var"]).astype(np.float32)
    s = gamma / np.sqrt(var + layers.BN_EPS)
    k, ci, co = kern.shape
    return (kern * s).reshape(k * ci, co), beta - mean * s


def build_layer_spec(
    model_cfg: ModelConfig, params: Mapping[str, Any], stats: Mapping[str, Any]
) -> Tuple[List[Dict[str, Any]], np.ndarray]:
    """The TC-ResNet as a conv list + fc kernel [C_last, ncls].

    Each entry: {role, k, stride, relu, wb=(W, b)}; role is "conv0",
    "down" (sets the shortcut), "block0" (first block conv; identity
    shortcut when no down conv preceded it) or "block1" (no ReLU, then
    residual add and ReLU)."""
    channels = scaled_channels(model_cfg.name, model_cfg.width_multiplier)
    spec = [dict(role="conv0", k=3, stride=1, relu=True,
                 wb=_fold_conv_bn(params, stats, "conv0"))]
    for i, _, down in block_plan(channels):
        if down:
            spec.append(dict(role="down", k=1, stride=2, relu=True,
                             wb=_fold_conv_bn(params, stats, f"block{i}_down")))
        spec.append(dict(role="block0", k=9, stride=2 if down else 1, relu=True,
                         wb=_fold_conv_bn(params, stats, f"block{i}_conv0")))
        spec.append(dict(role="block1", k=9, stride=1, relu=False,
                         wb=_fold_conv_bn(params, stats, f"block{i}_conv1")))
    fc = _np(params["fc.weight"]).astype(np.float32).T  # Linear [out, in] -> [in, out]
    return spec, np.ascontiguousarray(fc)


# ---------------------------------------------------------------------------
# the plan: folded constants on the device
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Conv:
    role: str
    k: int
    stride: int
    relu: bool
    w: torch.Tensor  # [k*Ci, Co], a view into FusedInfer.wts
    b: torch.Tensor  # [Co]
    w_off: int
    b_off: int


class _K4Conv(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in
                ("k", "stride", "role", "relu", "ci", "co", "w_off", "b_off")]


class _K4Args(ctypes.Structure):
    """Mirror of struct K4Args in csrc/infer.cu (checked by size at load)."""

    _fields_ = (
        [("fe", mfcc.FeArgs)]
        + [(f, ctypes.c_void_p) for f in ("wavs", "out", "wts", "fc")]
        + [(f, ctypes.c_int) for f in (
            "batch", "n_convs", "ncls", "act_max", "region_a", "smem_bytes")]
        + [("convs", _K4Conv * _MAX_CONVS)]
    )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _build.bind("infer", _K4Args, ["k4_infer"], "k4_args_size", "k4_error_string")


def build_kernels() -> None:
    """Build (if needed) and load the kernel library now, not at first launch."""
    _library()


class FusedInfer:
    """infer(wavs [B, N] f32) -> logits [B, ncls] f32 through kernel K4.

    Weights are folded once here and live on `device`; the input must be
    on the same device."""

    def __init__(self, model_cfg: ModelConfig, audio_cfg: AudioConfig,
                 params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                 device: torch.device):
        if not fused_infer_available(model_cfg, audio_cfg):
            raise ValueError(
                f"the fused kernel does not serve model={model_cfg.name} with "
                f"this audio geometry ({audio_cfg.preprocess_method}, window "
                f"{audio_cfg.window_size_samples}, hop {audio_cfg.window_stride_samples})"
            )
        geom = _geometry(model_cfg, audio_cfg)
        self.device = torch.device(device)
        self.geom = geom
        self.ncls = model_cfg.num_classes

        def dev(a):
            return torch.tensor(np.ascontiguousarray(a, np.float32), device=self.device)

        self.fe = mfcc.front_end(audio_cfg, geom.fe.n, self.device, "fp32")
        self.magnitude = geom.fe.magnitude
        self.matmul_dtype = self.fe.matmul_dtype
        self.dft, self.mel, self.dct = self.fe.dft, self.fe.mel, self.fe.dct

        spec, fc = build_layer_spec(model_cfg, params, batch_stats)
        self.fc = dev(fc)
        # weights and biases at 16-byte aligned offsets: the kernel reads
        # the weights as float4
        pieces, offsets, off = [], [], 0
        for e in spec:
            for a in e["wb"]:
                offsets.append(off)
                pad = -a.size % 4
                pieces += [a.ravel(), np.zeros(pad, np.float32)]
                off += a.size + pad
        self.wts = dev(np.concatenate(pieces))
        offsets = list(zip(offsets[0::2], offsets[1::2]))
        self.convs = []
        for e, (w_off, b_off) in zip(spec, offsets):
            w, b = e["wb"]
            self.convs.append(_Conv(
                e["role"], e["k"], e["stride"], e["relu"],
                self.wts[w_off:w_off + w.size].view(w.shape),
                self.wts[b_off:b_off + b.size], w_off, b_off,
            ))

    def kernel_args(self, wavs: torch.Tensor, out: torch.Tensor) -> _K4Args:
        g = self.geom
        args = _K4Args(
            self.fe.args(), wavs.data_ptr(), out.data_ptr(), self.wts.data_ptr(),
            self.fc.data_ptr(), wavs.shape[0], len(self.convs), self.ncls,
            g.act_max, g.region_a, g.smem_bytes,
        )
        for i, c in enumerate(self.convs):
            ci, co = c.w.shape[0] // c.k, c.w.shape[1]
            args.convs[i] = _K4Conv(c.k, c.stride, _ROLES[c.role], int(c.relu),
                                    ci, co, c.w_off, c.b_off)
        return args

    def __call__(self, wavs: torch.Tensor) -> torch.Tensor:
        return fused_infer(wavs, self)


def build_fused_infer(model_cfg: ModelConfig, audio_cfg: AudioConfig,
                      params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                      *, device) -> FusedInfer:
    """-> infer(wavs [B, N] f32) -> logits [B, num_classes] f32, with the
    port's params / batch_stats mappings (models/convert.py)."""
    return FusedInfer(model_cfg, audio_cfg, params, batch_stats, device)


# ---------------------------------------------------------------------------
# plain version and dispatch
# ---------------------------------------------------------------------------


def _conv_step(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int,
               stride: int, relu: bool) -> torch.Tensor:
    """[B, T, Ci] -> [B, To, Co]: TF-SAME k x 1 conv as k shifted
    (stride-decimated) slices, each matmul'd against its weight block."""
    t, ci = x.shape[1], x.shape[2]
    to, lo, _ = layers.same_padding(t, k, stride)
    span = stride * (to - 1) + 1
    xpad = F.pad(x, (0, 0, lo, max(span + k - 1 - t - lo, 0)))
    acc = None
    for j in range(k):
        part = xpad[:, j:j + span:stride] @ w[j * ci:(j + 1) * ci]
        acc = part if acc is None else acc + part
    y = acc + b
    return torch.relu(y) if relu else y


def fused_infer_reference(wavs: torch.Tensor, plan: FusedInfer) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the plan's constants."""
    g = plan.geom.fe
    frames = dsp.round_operand(
        dsp.frame_signal(wavs.to(torch.float32), g.window, g.hop), plan.matmul_dtype)
    reim = (frames @ plan.dft).unflatten(-1, (2 * g.ncg, 2))
    re, im = reim[..., 0], reim[..., 1]
    power = (re * re + im * im)[..., :g.num_bins]
    spec = torch.sqrt(power) if plan.magnitude else power
    x = torch.log(spec @ plan.mel + 1e-6)
    if not plan.magnitude:
        x = x @ plan.dct

    shortcut = None
    for c in plan.convs:
        if c.role == "conv0":
            x = _conv_step(x, c.w, c.b, c.k, c.stride, c.relu)
        elif c.role == "down":
            shortcut = _conv_step(x, c.w, c.b, c.k, c.stride, c.relu)
        elif c.role == "block0":
            if shortcut is None:
                shortcut = x  # same-channel block: identity shortcut
            x = _conv_step(x, c.w, c.b, c.k, c.stride, c.relu)
        else:  # block1: conv (no relu) + residual add + relu
            x = torch.relu(_conv_step(x, c.w, c.b, c.k, c.stride, c.relu) + shortcut)
            shortcut = None
    return x.mean(dim=1) @ plan.fc


def fused_infer(wavs: torch.Tensor, plan: FusedInfer) -> torch.Tensor:
    """Logits of `wavs` [B, N] f32: the kernel for a CUDA tensor, the plain
    version for a CPU tensor, an error for anything else."""
    global launches
    if wavs.device != plan.device:
        raise ValueError(f"wavs on {wavs.device}, fused plan on {plan.device}")
    if wavs.device.type == "cpu":
        return fused_infer_reference(wavs, plan)
    if wavs.device.type != "cuda":
        raise ValueError(f"no K4 kernel for device type {wavs.device.type!r}")
    if wavs.dtype != torch.float32:
        raise TypeError(f"wavs must be float32, got {wavs.dtype}")
    if wavs.dim() != 2 or wavs.shape[1] != plan.geom.fe.n:
        raise ValueError(f"wavs must be [B, {plan.geom.fe.n}], got {list(wavs.shape)}")
    if not wavs.is_contiguous():
        raise ValueError("wavs must be contiguous")
    out = torch.empty((wavs.shape[0], plan.ncls), device=wavs.device, dtype=torch.float32)
    if wavs.shape[0] == 0:
        return out
    _build.launch(_library(), "k4_infer", "k4_error_string",
                  plan.kernel_args(wavs, out), wavs.device)
    launches += 1
    return out
