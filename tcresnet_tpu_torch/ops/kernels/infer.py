"""Whole-model TC-ResNet inference: wav -> logits in one CUDA call.

Counterpart of tcresnet_tpu/ops/pallas/infer.py (kernel K4). The kernel
itself is `csrc/infer.cu`; its source note says what bounds it on the
H100 and how its design differs from the TPU kernel's: its front end is
K2's tensor-core stage over every frame of the batch (`mfcc.front_end`'s
"hops" constants, `mfcc.tc_tile_plan`'s tiles), and each utterance's conv
stack runs in the block that stores the last of its frames (one
utterance), or in a second kernel of the same call (a batch of more:
`FusedInfer.two_kernels`). This module:

- folds eval-mode BatchNorm into each conv once, on the host
  (`_fold_conv_bn`, epsilon 1e-3), flattens the residual structure
  into a conv list with roles (`build_layer_spec`), and pads every conv
  width to a multiple of 4 with zeros (`_pad_channels`), so that the
  kernel serves every width multiplier, as the JAX kernel does;
- lays the folded constants out for the kernel and copies them to the
  device once (`build_fused_infer` -> `FusedInfer`), with the kernel's
  shared-memory plan (`_geometry`, `launch_smem_bytes`) and its own
  per-utterance and split-tile counters;
- holds the kernel's plain PyTorch version (`fused_infer_reference`): K2's
  plain feature, then the same folding and the same per-tap matmuls;
- dispatches (`fused_infer`): a CPU tensor goes to the plain version, a
  CUDA tensor to the kernel, and anything else raises. There is no
  fallback from the kernel to the plain version: a failed build or
  launch raises.

`launches` counts calls of the kernel's entry point, `k4_infer` (one per
`fused_infer` on a CUDA tensor, whichever path it takes, and nothing
else), so a run can show that its serving path went through the kernel.
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
    fe: mfcc.FrontEndGeometry  # K2's stage's (csrc/dft_tc.cuh)
    nnz: int  # the mel's nonzero weights (mfcc.tc_mel_constants)
    act_max: int  # largest conv activation, T * C floats
    # the conv stage's shared memory, in floats (csrc/infer.cu): the flag,
    # the features [frames, C] (rounded up to 4), three buffers of act_max
    # and the pooled vector [C_last]
    conv_floats: int


def _pad4(c: int) -> int:
    """A width padded to the kernel's: a conv thread computes 4 output
    channels from 16-byte weight loads."""
    return c + -c % 4


def _conv_shapes(model_cfg: ModelConfig, t: int) -> List[Tuple[int, int]]:
    """(out rows, out channels padded to 4, as `_pad_channels` lays them
    out) of every conv in spec order. The blocks are the model's: two
    widths that pad alike still have a down conv between them."""
    channels = scaled_channels(model_cfg.name, model_cfg.width_multiplier)
    shapes = [(t, _pad4(channels[0]))]
    for _, n, down in block_plan(channels):
        to = -(-t // 2) if down else t
        shapes += [(to, _pad4(n))] * (3 if down else 2)
        t = to
    return shapes


_FLAG_FLOATS = 4  # K4_FLAG in csrc/infer.cu


def _hops(audio_cfg: AudioConfig) -> AudioConfig:
    """K4's front end is always the hops DFT, as the JAX kernel's is."""
    return dataclasses.replace(audio_cfg, dft_variant="hops")


def _geometry(model_cfg: ModelConfig, audio_cfg: AudioConfig) -> _Geometry:
    fe = mfcc.front_end_geometry(audio_cfg, audio_cfg.desired_samples)
    nnz = mfcc.tc_mel_constants(*dsp.mel_args(audio_cfg))[1].size
    act_max = max(t * c for t, c in _conv_shapes(model_cfg, fe.frames))
    c_last = _pad4(scaled_channels(model_cfg.name, model_cfg.width_multiplier)[-1])
    feats = fe.frames * fe.width
    return _Geometry(fe, nnz, act_max, _FLAG_FLOATS + feats + -feats % 4 + 3 * act_max + c_last)


def launch_smem_bytes(geom: _Geometry, plan: mfcc.TcPlan) -> int:
    """A launch's shared memory: the stage's plan for the tile's rows or,
    where larger, the conv stage's, which reuses it."""
    return max(plan.smem_bytes, 4 * geom.conv_floats)


def fused_infer_available(model_cfg: ModelConfig, audio_cfg: AudioConfig) -> bool:
    """The kernel serves the temporal TC-ResNets on both spectral front
    ends where K2's stage serves the geometry in the hops variant
    (`mfcc.fused_mfcc_available`: hop-decomposable, window % hop == 0, n %
    hop == 0 and n >= window as in the JAX kernel; 16-byte aligned frames;
    a tile plan that fits a block), with a conv stage whose shared memory
    fits one Hopper block at the widths padded to 4 (`_pad_channels`) and
    at most the kernel's number of convs. Like the JAX kernel, it serves
    every width multiplier."""
    if model_cfg.name not in TC_CHANNELS:
        return False
    n = audio_cfg.desired_samples
    if not mfcc.fused_mfcc_available(_hops(audio_cfg), n):
        return False
    geom = _geometry(model_cfg, audio_cfg)
    return (4 * geom.conv_floats <= mfcc.SMEM_LIMIT
            and len(_conv_shapes(model_cfg, geom.fe.frames)) <= _MAX_CONVS)


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


def _pad_channels(spec: List[Dict[str, Any]],
                  fc: np.ndarray) -> Tuple[List[Dict[str, Any]], np.ndarray]:
    """The spec with every conv's output channels padded to a multiple of 4
    (zero weight columns, zero biases) and every input that came from a
    conv padded to match (zero weight rows; conv0 reads the features as
    they are), and the fc's input rows padded with zeros. A padded channel
    is 0 after each conv, its ReLU and the residual add, so it adds 0 to
    every sum and the logits are those of the unpadded model."""
    out = []
    for e in spec:
        w, b = e["wb"]
        k, co = e["k"], w.shape[1]
        ci = w.shape[0] // k
        ci_pad = 0 if e["role"] == "conv0" else _pad4(ci) - ci
        w = np.pad(w.reshape(k, ci, co), ((0, 0), (0, ci_pad), (0, _pad4(co) - co)))
        out.append({**e, "wb": (w.reshape(k * (ci + ci_pad), _pad4(co)),
                                np.pad(b, (0, _pad4(co) - co)))})
    return out, np.pad(fc, ((0, _pad4(fc.shape[0]) - fc.shape[0]), (0, 0)))


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
    """Mirror of struct K4Args in csrc/infer.cu (checked by size at load,
    and field by field by tests/test_torch_infer_tc.py)."""

    _fields_ = (
        [("fe", mfcc.FeArgs), ("v", mfcc.FeVariant)]
        + [(f, ctypes.c_void_p) for f in ("wavs", "feats", "count", "out", "wts", "fc")]
        + [(f, ctypes.c_int) for f in (
            "batch", "n_convs", "ncls", "act_max", "region_a", "smem_bytes",
            "two_kernels", "conv_bytes")]
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
        self.audio = _hops(audio_cfg)
        self.ncls = model_cfg.num_classes

        def dev(a):
            return torch.tensor(np.ascontiguousarray(a, np.float32), device=self.device)

        # K2's constants (shared with K2's calls of this geometry: read only)
        self.fe = mfcc.front_end(audio_cfg, geom.fe.n, self.device, "hops")
        # K4's own counters, 0 between calls (calls on one stream at a
        # time): the split tiles' (fewer than SMS tiles: the plan's rule)
        # and the utterances' (grown to the largest batch yet)
        self.done = torch.zeros(mfcc.SMS, dtype=torch.int32, device=self.device)
        self.count = torch.zeros(0, dtype=torch.int32, device=self.device)
        # None: the path of the rule (`two_kernels`); True / False forces one,
        # so that tools/infer_times.py can time both
        self.force_two_kernels = None

        spec, fc = _pad_channels(*build_layer_spec(model_cfg, params, batch_stats))
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

    def two_kernels(self, batch: int) -> bool:
        """Whether `k4_infer` runs a batch's conv stacks in a kernel of
        their own after the stage (one block per utterance) rather than in
        the block that stores an utterance's last rows: for every batch of
        more than one utterance. A block whose tile ends two utterances
        runs both stacks in turn, holding its SM (registers, shared memory)
        while other tiles wait; for one utterance the second launch is all
        the split adds (measured in PERF.md; both paths give the same
        bits). `force_two_kernels`, where set, decides instead. A batch on
        the 128-row product (csrc/dft_wgmma.cuh, from 172 clips at
        480/160) runs its conv stacks in their own kernel whatever this
        says: its tiles never hold a single utterance's whole call."""
        if self.force_two_kernels is not None:
            return self.force_two_kernels
        return batch > 1

    def kernel_args(self, wavs: torch.Tensor, feats: torch.Tensor,
                    out: torch.Tensor) -> Tuple[_K4Args, Any]:
        """(the launch's args, the split tiles' workspace or None: keep it
        until the launch is enqueued) for wavs [B, n] on the plan's device,
        the features' workspace [B, frames, C] and the logits [B, ncls]."""
        g, batch = self.geom, wavs.shape[0]
        if self.count.numel() < batch:
            self.count = torch.zeros(max(batch, 2 * self.count.numel()), dtype=torch.int32,
                                     device=self.device)
        v, region_a, _, part = self.fe.launch_args(batch)
        v.done = self.done.data_ptr()
        tiles = mfcc.tc_tile_plan(batch, g.fe, g.nnz)
        args = _K4Args(
            self.fe.args(), v, wavs.data_ptr(), feats.data_ptr(), self.count.data_ptr(),
            out.data_ptr(), self.wts.data_ptr(), self.fc.data_ptr(), batch, len(self.convs),
            self.ncls, g.act_max, region_a, launch_smem_bytes(g, tiles),
            int(self.two_kernels(batch)), 4 * g.conv_floats,
        )
        for i, c in enumerate(self.convs):
            ci, co = c.w.shape[0] // c.k, c.w.shape[1]
            args.convs[i] = _K4Conv(c.k, c.stride, _ROLES[c.role], int(c.relu),
                                    ci, co, c.w_off, c.b_off)
        return args, part

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
    """Plain PyTorch version of the kernel: K2's plain feature (the dense
    hops front end, `mfcc.fused_mfcc_reference`), then the plan's folded
    convs as per-tap matmuls, GAP and fc."""
    x = mfcc.fused_mfcc_reference(wavs.to(torch.float32), plan.audio, "hops")
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
    g = plan.geom.fe
    if wavs.dim() != 2 or wavs.shape[1] != g.n:
        raise ValueError(f"wavs must be [B, {g.n}], got {list(wavs.shape)}")
    if not wavs.is_contiguous():
        raise ValueError("wavs must be contiguous")
    if wavs.data_ptr() % 16:
        raise ValueError("k4_infer copies wavs in 16-byte chunks: wavs must be 16-byte aligned")
    batch = wavs.shape[0]
    out = torch.empty((batch, plan.ncls), device=wavs.device, dtype=torch.float32)
    if batch == 0:
        return out
    feats = torch.empty((batch, g.frames, g.width), device=wavs.device, dtype=torch.float32)
    args, _part = plan.kernel_args(wavs, feats, out)
    _build.launch(_library(), "k4_infer", "k4_error_string", args, wavs.device)
    launches += 1
    mfcc.count_wgmma(args.v)
    return out
