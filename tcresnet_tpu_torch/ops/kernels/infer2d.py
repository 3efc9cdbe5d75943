"""Whole-model 2D inference: features -> logits in one CUDA launch.

Counterpart of tcresnet_tpu/ops/pallas/infer2d.py (kernel K5), for the
2D families: TCResNet2D8[Pool], Res8/15[Narrow], DSCNN S/M/L and the
seven KWS baselines. The kernel is `csrc/infer2d.cu`; its source note
says what bounds it on the H100. The front end before it is the MFCC
kernel of the config's DFT variant (K2, K8 or K9, `ops/kernels/mfcc.py`),
so a request is two launches, as in JAX.

This module:

- folds eval-mode BatchNorm into the convs and flattens the model into
  the JAX package's op list (`build_op_list`: the same ops, the same
  folded weights, from port-layout variables);
- lowers that list to the kernel's program (`FusedInfer2D`): per op its
  shapes, computed here so the kernel infers none; where it reads and
  writes (three workspace slots, the features and the logits), which is
  how `save` and the conv roles (`down`, `block0`, `block1`) are carried
  out; and the elementwise ops that follow a conv (`affine`, `addsc`)
  folded into that conv's epilogue, in JAX's order. The folded weights
  live in one flat device buffer at 16-byte offsets, the output-channel
  axis padded to a multiple of 4 for 16-byte loads;
- plans, per batch size, how the kernel's implicit GEMM covers each conv
  (full, c1) and dense step (`gemm_plan`): its output tiles, the K parts
  it splits a step into so that a batch-1 step reaches every block of the
  grid, and how the parts are added (`op_rows`, `FusedInfer2D.op_table`);
- holds the kernel's plain PyTorch version (`fused_infer2d_reference`),
  which replays the same program with per-tap matmuls, broadcast
  multiplies for the `c1` / `dw` convs, the pools, the dense layers,
  `tconv_full` and `svdf`, and never calls `F.conv2d`;
- dispatches (`fused_infer2d`): a CPU tensor goes to the plain version, a
  CUDA tensor to the kernel, and anything else raises. There is no
  fallback.

Left out from the TPU kernel, as artifacts of Mosaic's layout rules: the
per-family batch tile, the zero-padding of the F axis to a multiple of 8
with its valid width, the reshape trick for strided slices and the
[n_blocks, tb, ncls] output. The port computes at the true widths (Res8:
95 x 38).

`launches` counts kernel launches and nothing else.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tcresnet_tpu_torch.config import AudioConfig, ModelConfig
from tcresnet_tpu_torch.models import layers
from tcresnet_tpu_torch.models.ds_cnn import NET_DEFS
from tcresnet_tpu_torch.models.kws import KWS_ARCHITECTURES
from tcresnet_tpu_torch.models.res import RES_SHAPES
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.ops.kernels import _build, mfcc
from tcresnet_tpu_torch.utils.device import resolve_device
from tcresnet_tpu_torch.utils.profiling import span

# Kernel launches since import (or since a caller reset it to 0).
launches = 0
# op tables built (`FusedInfer2D._table`), each a `k5.plan` span
k5_tables = 0

FAMILIES = ("ResNet2D8", "ResNet2D8Pool", *RES_SHAPES, *NET_DEFS, "KWS")

# the kernel's op kinds and conv modes (csrc/infer2d.cu)
KINDS = {"conv": 0, "pool": 1, "maxpool": 2, "gap": 3, "dense": 4, "tconv_full": 5, "svdf": 6}
MODES = {"full": 0, "c1": 1, "dw": 2}
# struct K5Op in csrc/infer2d.cu, one int each, in this order
OP_FIELDS = ("kind", "mode", "relu", "relu2", "res", "src", "dst",
             "kh", "kw", "sh", "sw", "dil", "pad_t", "pad_f",
             "t_in", "f_in", "c_in", "t_out", "f_out", "c_out", "c_pad",
             "w_off", "w2_off", "b_off", "aff_off", "rank", "n_chunks", "chunk")
# the GEMM plan of a conv (full, c1) or dense step, per batch (`gemm_plan`),
# the last fields of K5Op
PLAN_FIELDS = ("tile", "vec", "k_total", "tiles_m", "tiles_n", "splits", "split_slices")
INPUT, OUTPUT = -1, -2  # slot numbers of the features and of the logits
N_SLOTS = 3  # x, the shortcut and the op's output
GAP_CHUNK = 64  # positions a warp sums in the first pass of "gap"
# the kernel's GEMM tiles (K5Wide, K5Narrow in csrc/infer2d.cu), by an op's
# `tile`: output rows x output channels x the K slice of one shared-memory
# stage. Steps with at most NARROW_N (padded) output channels take tile 1,
# whose 128 x 32 leaves no warp idle on N.
GEMM_TILES = ((64, 64, 32), (128, 32, 32))
NARROW_N = 32
# the shortest K part of a split step, in K indices (taps x input
# channels); a whole number of slices. A step is split until tiles x parts
# reaches the grid or every part is this short.
MIN_K_PART = 32
# op tables a plan keeps, one per batch size, the least recently used
# dropped first
MAX_TABLES = 16
# the cooperative grid of an H100 (132 SMs x 2 blocks), which a CPU plan
# assumes; on the card the plan takes the grid the launch will use
H100_GRID_BLOCKS = 264


def fused_infer2d_available(model_cfg: ModelConfig, audio_cfg: AudioConfig) -> bool:
    """The JAX kernel's condition: a 2D family (a KWS architecture it
    knows) on a front end that the MFCC kernels serve (here their
    condition, which adds the shared-memory plan of the DFT variant)."""
    if model_cfg.name == "KWS" and model_cfg.kws_architecture not in KWS_ARCHITECTURES:
        return False
    return (model_cfg.name in FAMILIES
            and mfcc.fused_mfcc_available(audio_cfg, audio_cfg.desired_samples))


# ---------------------------------------------------------------------------
# host-side weight folding -> the JAX package's op list
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    return (t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)).astype(np.float32)


def _kernel(params, conv_name: str) -> np.ndarray:
    """Port conv weight [Co, Ci/g, kh, kw] -> the Flax kernel [kh, kw, Ci/g, Co]."""
    return _np(params[f"{conv_name}.weight"]).transpose(2, 3, 1, 0)


def _fold_conv_bn_2d(params, stats, conv_name: str, bn_name: str):
    """conv kernel (+ optional bias) + BN -> (w [kh*kw, Ci, Co], b [1, Co]),
    as the JAX kernel folds: any of the BN's scale and shift may be absent
    (DS-CNN has the shift only)."""
    kern = _kernel(params, conv_name)
    kh, kw, ci, co = kern.shape
    bias = _np(params.get(f"{conv_name}.bias", np.zeros(co)))
    gamma = _np(params.get(f"{bn_name}.weight", np.ones(co)))
    beta = _np(params.get(f"{bn_name}.bias", np.zeros(co)))
    mean = _np(stats[f"{bn_name}.running_mean"])
    var = _np(stats[f"{bn_name}.running_var"])
    s = gamma / np.sqrt(var + layers.BN_EPS)
    w = (kern * s).reshape(kh * kw, ci, co)
    b = ((bias - mean) * s + beta).reshape(1, co)
    return w, b


def _raw_conv(params, conv_name: str):
    """Unfolded conv (its BN is not adjacent) -> (w [kh*kw, Ci, Co], bias | 0)."""
    kern = _kernel(params, conv_name)
    kh, kw, ci, co = kern.shape
    bias = _np(params.get(f"{conv_name}.bias", np.zeros(co)))
    return kern.reshape(kh * kw, ci, co), bias.reshape(1, co)


def _stat_affine(stats, bn_name: str):
    """Stat-only BN (Res) -> [2, C]: row 0 the scale, row 1 the shift."""
    mean = _np(stats[f"{bn_name}.running_mean"])
    var = _np(stats[f"{bn_name}.running_var"])
    s = 1.0 / np.sqrt(var + layers.BN_EPS)
    return np.stack([s, -mean * s])


class _OpListBuilder:
    """The JAX package's op tuples and weight list, entry for entry."""

    def __init__(self):
        self.ops: List[Tuple] = []
        self.weights: List[np.ndarray] = []

    def conv(self, w, b, kh, kw, sh, sw, dil, relu, padding, role="main"):
        mode = "c1" if w.shape[1] == 1 else "full"
        self.ops.append(("conv", kh, kw, sh, sw, dil, relu, padding, mode, role))
        self.weights += [w, b]

    def dwconv(self, w, b, kh, kw, sh, sw, relu):
        self.ops.append(("conv", kh, kw, sh, sw, 1, relu, "SAME", "dw", "main"))
        self.weights += [w, b]

    def affine(self, a):
        self.ops.append(("affine",))
        self.weights.append(a)

    def pool(self, ph, pw, sh, sw):
        self.ops.append(("pool", ph, pw, sh, sw))

    def maxpool(self, ph, pw, sh, sw, padding):
        self.ops.append(("maxpool", ph, pw, sh, sw, padding))

    def save(self):
        self.ops.append(("save",))

    def addsc(self, relu: bool):
        self.ops.append(("addsc", relu))

    def gap(self):
        self.ops.append(("gap",))

    def _with_bias(self, kind, head, w, b):
        self.ops.append((kind, *head, b is not None))
        self.weights.append(w)
        if b is not None:
            self.weights.append(b)

    def dense(self, w, b, relu=False):
        self._with_bias("dense", (relu,), w, b)

    def flatten_dense(self, w, b, relu=False):
        # w [T, F, C, U] (4D input) or [T, F, U] (3D input)
        self._with_bias("flatten_dense", (relu,), w, b)

    def tconv_full(self, w, b, sw, relu):
        # full-height VALID conv, w [kw, T, U]
        self._with_bias("tconv_full", (w.shape[0], sw, relu), w, b)

    def svdf(self, w_freq, w_time, bias, rank):
        # unit-major filters k = u * rank + r, split per rank component
        self.ops.append(("svdf", rank))
        for r in range(rank):
            self.weights.append(np.ascontiguousarray(w_freq[:, r::rank]))
        for r in range(rank):
            self.weights.append(np.ascontiguousarray(w_time[r::rank].T))
        self.weights.append(bias)


def _build_tc2d(model_cfg: ModelConfig, params, stats) -> _OpListBuilder:
    """ResNet2D8[Pool]."""
    b = _OpListBuilder()
    w, bb = _fold_conv_bn_2d(params, stats, "conv0_conv", "conv0_bn")
    b.conv(w, bb, 3, 3, 1, 1, 1, True, "SAME")
    if model_cfg.name.endswith("Pool"):
        b.pool(4, 4, 4, 4)
    i = 0
    while f"block{i}_conv0_conv.weight" in params:
        has_down = f"block{i}_down_conv.weight" in params
        stride = 2 if has_down else 1
        if has_down:
            dw, db = _fold_conv_bn_2d(params, stats, f"block{i}_down_conv", f"block{i}_down_bn")
            b.conv(dw, db, 1, 1, 2, 2, 1, True, "SAME", role="down")
        w0, b0 = _fold_conv_bn_2d(params, stats, f"block{i}_conv0_conv", f"block{i}_conv0_bn")
        b.conv(w0, b0, 3, 3, stride, stride, 1, True, "SAME", role="block0")
        w1, b1 = _fold_conv_bn_2d(params, stats, f"block{i}_conv1_conv", f"block{i}_conv1_bn")
        b.conv(w1, b1, 3, 3, 1, 1, 1, False, "SAME", role="block1")
        b.addsc(relu=True)
        i += 1
    return b


def _build_res(model_cfg: ModelConfig, params, stats) -> _OpListBuilder:
    """Res8/15[Narrow]: conv-ReLU then stat-only BN; BN after the add."""
    b = _OpListBuilder()
    w, bb = _raw_conv(params, "f_conv")
    b.conv(w, bb, 3, 3, 1, 1, 1, True, "SAME")
    num_layers, _, pool, use_dilation = RES_SHAPES[model_cfg.name]
    if pool is not None:
        b.pool(*pool, 1, 1)

    def rate(idx):
        return 2 ** (idx // 3) if use_dilation else 1

    idx = 0
    for i in range(num_layers // 2):
        b.save()
        w0, b0 = _raw_conv(params, f"conv{idx}")
        b.conv(w0, b0, 3, 3, 1, 1, rate(idx), True, "SAME")
        b.affine(_stat_affine(stats, f"conv{idx}_bn"))
        idx += 1
        w1, b1 = _raw_conv(params, f"conv{idx}")
        b.conv(w1, b1, 3, 3, 1, 1, rate(idx), True, "SAME")
        idx += 1
        b.addsc(relu=False)
        b.affine(_stat_affine(stats, f"conv{2 * i + 1}_bn"))
    if num_layers % 2:
        w2, b2 = _raw_conv(params, f"conv{idx}")
        b.conv(w2, b2, 3, 3, 1, 1, rate(idx), True, "SAME")
        b.affine(_stat_affine(stats, f"conv{idx}_bn"))
    return b


def _build_dscnn(model_cfg: ModelConfig, params, stats) -> _OpListBuilder:
    """DS-CNN S/M/L: conv/BN-ReLU, then separable blocks."""
    b = _OpListBuilder()
    for block in NET_DEFS[model_cfg.name]:
        kh, kw = block.kernel
        sh, sw = block.stride
        if block.type == "conv":
            w, bb = _fold_conv_bn_2d(params, stats, block.name, f"{block.name}_bn")
            b.conv(w, bb, kh, kw, sh, sw, 1, True, "SAME")
        else:  # separable: depthwise + BN-ReLU, pointwise + BN-ReLU
            w, bb = _fold_conv_bn_2d(params, stats, f"{block.name}_dw", f"{block.name}_dw_bn")
            b.dwconv(w, bb, kh, kw, sh, sw, True)
            w, bb = _fold_conv_bn_2d(params, stats, f"{block.name}_pw", f"{block.name}_pw_bn")
            b.conv(w, bb, 1, 1, 1, 1, 1, True, "SAME")
    return b


def _dense_bias(params, name):
    b = params.get(f"{name}.bias")
    return None if b is None else _np(b).reshape(1, -1)


def _dense_wb(params, name):
    """nn.Linear [out, in] -> the Flax kernel [in, out], bias [1, out] | None."""
    return np.ascontiguousarray(_np(params[f"{name}.weight"]).T), _dense_bias(params, name)


def _flat_w(params, name, spatial, channels=None):
    """Dense kernel [T*F*C, U] -> [T, F, (C,) U] (Flax flattens channel fastest)."""
    w = _dense_wb(params, name)[0]
    t, f = spatial
    return w.reshape(t, f, -1) if channels is None else w.reshape(t, f, channels, -1)


def _build_kws(model_cfg: ModelConfig, params, feature_shape) -> Tuple[_OpListBuilder, int]:
    """The Google-KWS baselines -> (builder, input rank 3 or 4)."""
    arch = model_cfg.kws_architecture
    t_in, f_in, _ = feature_shape
    b = _OpListBuilder()

    if arch == "single_fc":
        w, bias = _dense_wb(params, "fc")
        b.flatten_dense(w.reshape(t_in, f_in, -1), bias)
        return b, 3

    if arch == "low_latency_svdf":
        rank = 2
        b.svdf(_np(params["weights_frequency"]), _np(params["weights_time"]),
               _np(params["bias"]).reshape(1, -1), rank)
        for name in ("fc1", "fc2", "fc3"):
            b.dense(*_dense_wb(params, name))
        return b, 3

    if arch == "conv":
        w, bias = _raw_conv(params, "conv1")
        b.conv(w, bias, 20, 8, 1, 1, 1, True, "SAME")
        b.maxpool(2, 2, 2, 2, "SAME")
        w, bias = _raw_conv(params, "conv2")
        b.conv(w, bias, 10, 4, 1, 1, 1, True, "SAME")
        to, fo = -(-t_in // 2), -(-f_in // 2)
        b.flatten_dense(_flat_w(params, "fc", (to, fo), 64), _dense_bias(params, "fc"))
        return b, 4

    if arch == "tiny_conv":
        w, bias = _raw_conv(params, "conv1")
        b.conv(w, bias, 10, 8, 2, 2, 1, True, "SAME")
        to, fo = -(-t_in // 2), -(-f_in // 2)
        b.flatten_dense(_flat_w(params, "fc", (to, fo), 8), _dense_bias(params, "fc"))
        return b, 4

    if arch == "trad_fpool3":
        w, bias = _raw_conv(params, "conv1")
        b.conv(w, bias, 20, 8, 1, 1, 1, True, "VALID")
        t1, f1 = t_in - 19, f_in - 7
        b.maxpool(1, 3, 1, 3, "VALID")
        f2 = (f1 - 3) // 3 + 1
        w, bias = _raw_conv(params, "conv2")
        b.conv(w, bias, 10, 4, 1, 1, 1, True, "VALID")
        t3, f3 = t1 - 9, f2 - 3
        b.flatten_dense(_flat_w(params, "lin", (t3, f3), 64), None)
        for name in ("fc1", "fc2"):
            b.dense(*_dense_wb(params, name))
        return b, 4

    if arch in ("low_latency_conv", "one_fstride4"):
        stride_f = 4 if arch == "one_fstride4" else 1
        kern = _kernel(params, "conv1")  # [T, 8, 1, U]
        w_full = np.transpose(kern[:, :, 0, :], (1, 0, 2)).copy()  # [8, T, U]
        b.tconv_full(w_full, _dense_bias(params, "conv1"), stride_f, True)
        fo = (f_in - 8) // stride_f + 1
        u = kern.shape[-1]
        if arch == "one_fstride4":
            b.flatten_dense(_dense_wb(params, "lin")[0].reshape(fo, u, -1), None)
            for name in ("fc1", "fc2", "fc3"):
                b.dense(*_dense_wb(params, name))
        else:
            w, bias = _dense_wb(params, "fc1")
            b.flatten_dense(w.reshape(fo, u, -1), bias)
            for name in ("fc2", "fc3"):
                b.dense(*_dense_wb(params, name))
        return b, 4

    raise ValueError(f"unsupported KWS architecture {arch!r}")


def build_op_list(model_cfg: ModelConfig, params: Mapping[str, Any],
                  stats: Mapping[str, Any], feature_shape):
    """-> (ops tuple, weight arrays, input rank 3 | 4), from the port's
    params / batch_stats mappings (models/convert.py): the JAX package's
    `build_op_list` op for op, the classifier tail included."""
    name = model_cfg.name
    input_rank = 4
    if name.startswith("ResNet2D8"):
        b = _build_tc2d(model_cfg, params, stats)
        b.gap()
        b.dense(*_dense_wb(params, "fc"))
    elif name.startswith("Res"):
        b = _build_res(model_cfg, params, stats)
        b.gap()
        b.dense(*_dense_wb(params, "fc"))
    elif name.startswith("DSCNN"):
        b = _build_dscnn(model_cfg, params, stats)
        b.gap()
        b.dense(*_dense_wb(params, "fc1"))
    elif name == "KWS":
        b, input_rank = _build_kws(model_cfg, params, feature_shape)
    else:
        raise ValueError(f"unsupported model {name!r}")
    return tuple(b.ops), b.weights, input_rank


# ---------------------------------------------------------------------------
# lowering: the op list -> the kernel's program
# ---------------------------------------------------------------------------


def valid_taps(n_out: int, n_in: int, k: int, stride: int, pad_lo: int, dil: int = 1) -> int:
    """Taps of a k-tap window over n_out outputs along one axis that meet
    the input (a tap on the zero padding needs no work)."""
    return sum(0 <= o * stride + i * dil - pad_lo < n_in for o in range(n_out) for i in range(k))


def window_geometry(t, f, keh, kew, sh, sw, padding):
    """TF-SAME / VALID window over a [t, f] map with effective kernel
    (keh, kew): (to, fo, low pad along t, low pad along f). SAME's low pad
    is total // 2, so an even kernel pads one more row on the high side."""
    if padding == "SAME":
        to, fo = -(-t // sh), -(-f // sw)
        pt = max((to - 1) * sh + keh - t, 0)
        pf = max((fo - 1) * sw + kew - f, 0)
    else:
        to, fo = (t - keh) // sh + 1, (f - kew) // sw + 1
        pt = pf = 0
    return to, fo, pt // 2, pf // 2


@dataclasses.dataclass
class _Op:
    """One step of the kernel's program; the int fields are OP_FIELDS."""

    kind: str
    src: int
    dst: int
    t_in: int
    f_in: int
    c_in: int
    t_out: int
    f_out: int
    c_out: int
    mode: str = "full"
    relu: bool = False
    relu2: bool = False
    res: int = -1
    kh: int = 1
    kw: int = 1
    sh: int = 1
    sw: int = 1
    dil: int = 1
    pad_t: int = 0
    pad_f: int = 0
    rank: int = 0
    n_chunks: int = 0
    chunk: int = 0
    c_pad: int = 0
    # flat-buffer offsets (-1: none) and the plain version's views of them
    w_off: int = -1
    w2_off: int = -1
    b_off: int = -1
    aff_off: int = -1
    w: Optional[Any] = None  # conv [taps, Ci, Co]; dense [K, U]; tconv [kw, T, U]; svdf [r][F, U]
    w2: Optional[Any] = None  # svdf: [r][T, U]
    b: Optional[torch.Tensor] = None
    aff: Optional[torch.Tensor] = None  # [2, C]

    def row(self) -> List[int]:
        ints = dict(kind=KINDS[self.kind], mode=MODES[self.mode], relu=int(self.relu),
                    relu2=int(self.relu2))
        return [ints[f] if f in ints else int(getattr(self, f)) for f in OP_FIELDS]

    @property
    def out_floats(self) -> int:
        return self.t_out * self.f_out * self.c_out


class _Weights:
    """The flat float32 weight buffer, each array at a 16-byte offset."""

    def __init__(self):
        self.pieces: List[np.ndarray] = []
        self.size = 0

    def put(self, a: np.ndarray, pad_last: bool = False) -> int:
        """Append `a` (its last axis zero-padded to a multiple of 4 when
        `pad_last`); its offset in floats."""
        a = np.asarray(a, np.float32)
        if pad_last and a.shape[-1] % 4:
            a = np.concatenate([a, np.zeros(a.shape[:-1] + (-a.shape[-1] % 4,), np.float32)], -1)
        off = self.size
        flat = a.ravel()
        self.pieces += [flat, np.zeros(-flat.size % 4, np.float32)]
        self.size += flat.size + (-flat.size % 4)
        return off


def _pad4(n: int) -> int:
    return n + (-n % 4)


def lower(ops, weights, feature_shape, ncls):
    """The JAX op list -> (list of _Op, flat weight array). Each _Op's
    views (w, b, aff, ...) are left as (offset, shape) pairs, made into
    device views by the caller."""
    buf = _Weights()
    prog: List[_Op] = []
    t, f, _ = feature_shape
    x = (INPUT, (t, f, 1))  # (slot, (t, f, c)) of the value ops read
    shortcut = None
    wi = 0

    def take(n=1):
        nonlocal wi
        out = weights[wi:wi + n]
        wi += n
        return out

    def new_slot():
        busy = {x[0], shortcut[0] if shortcut else None}
        return min(s for s in range(N_SLOTS) if s not in busy)

    def view(off, shape):
        return (off, tuple(shape))

    def with_bias(op, b):
        if b is not None:
            op.b_off = buf.put(np.asarray(b).ravel())
            op.b = view(op.b_off, (np.asarray(b).size,))

    for spec in ops:
        kind = spec[0]
        (ti, fi, ci) = x[1]
        if kind == "conv":
            _, kh, kw, sh, sw, dil, relu, padding, mode, role = spec
            w, b = take(2)
            co = w.shape[2]
            keh, kew = (kh - 1) * dil + 1, (kw - 1) * dil + 1
            to, fo, pt, pf = window_geometry(ti, fi, keh, kew, sh, sw, padding)
            op = _Op("conv", x[0], new_slot(), ti, fi, ci, to, fo, co, mode=mode, relu=relu,
                     kh=kh, kw=kw, sh=sh, sw=sw, dil=dil, pad_t=pt, pad_f=pf, c_pad=_pad4(co))
            op.w_off = buf.put(w, pad_last=True)
            op.w = view(op.w_off, (w.shape[0], w.shape[1], op.c_pad))
            with_bias(op, b)
            prog.append(op)
            out = (op.dst, (to, fo, co))
            if role == "down":
                shortcut = out
            elif role == "block0":
                shortcut = shortcut or x
                x = out
            else:
                x = out
        elif kind in ("affine", "addsc"):
            prev = prog[-1] if prog else None
            if prev is None or prev.kind != "conv" or prev.dst != x[0] or prev.aff_off >= 0 or (
                    kind == "addsc" and prev.res >= 0):
                raise ValueError(f"{kind} must follow a conv's output in the op list")
            if kind == "affine":
                (a,) = take()
                prev.aff_off = buf.put(a)
                prev.aff = view(prev.aff_off, a.shape)
            else:
                if shortcut is None or shortcut[1] != x[1]:
                    raise ValueError(f"addsc: shortcut {shortcut} does not match {x}")
                prev.res, prev.relu2 = shortcut[0], bool(spec[1])
                shortcut = None
        elif kind == "save":
            shortcut = x
        elif kind in ("pool", "maxpool"):
            _, ph, pw, sh, sw = spec[:5]
            to, fo, pt, pf = window_geometry(ti, fi, ph, pw, sh, sw,
                                             spec[5] if kind == "maxpool" else "VALID")
            op = _Op(kind, x[0], new_slot(), ti, fi, ci, to, fo, ci, kh=ph, kw=pw, sh=sh, sw=sw,
                     pad_t=pt, pad_f=pf)
            prog.append(op)
            x = (op.dst, (to, fo, ci))
        elif kind == "gap":
            op = _Op("gap", x[0], new_slot(), ti, fi, ci, 1, 1, ci, chunk=GAP_CHUNK,
                     n_chunks=-(-(ti * fi) // GAP_CHUNK))
            prog.append(op)
            x = (op.dst, (1, 1, ci))
        elif kind in ("dense", "flatten_dense"):
            _, relu, has_bias = spec
            (w,) = take()
            (b,) = take() if has_bias else (None,)
            w = np.asarray(w).reshape(-1, np.asarray(w).shape[-1])
            k, u = w.shape
            if k != ti * fi * ci:
                raise ValueError(f"{kind}: a [{k}, {u}] kernel on a {x[1]} input")
            op = _Op("dense", x[0], new_slot(), 1, 1, k, 1, 1, u, relu=relu, c_pad=_pad4(u))
            op.w_off = buf.put(w, pad_last=True)
            op.w = view(op.w_off, (k, op.c_pad))
            with_bias(op, b)
            prog.append(op)
            x = (op.dst, (1, 1, u))
        elif kind == "tconv_full":
            _, kw, sw, relu, has_bias = spec
            (w,) = take()
            (b,) = take() if has_bias else (None,)
            u = w.shape[2]
            if ci != 1 or w.shape[1] != ti:
                raise ValueError(f"tconv_full: a {w.shape} kernel on a {x[1]} input")
            fo = (fi - kw) // sw + 1
            op = _Op("tconv_full", x[0], new_slot(), ti, fi, 1, 1, fo, u, relu=relu, kw=kw,
                     sw=sw, c_pad=_pad4(u))
            op.w_off = buf.put(w, pad_last=True)
            op.w = view(op.w_off, (kw, ti, op.c_pad))
            with_bias(op, b)
            prog.append(op)
            x = (op.dst, (1, fo, u))
        elif kind == "svdf":
            rank = spec[1]
            parts = take(2 * rank + 1)
            u = parts[0].shape[1]
            if ci != 1:
                raise ValueError(f"svdf on a {x[1]} input")
            op = _Op("svdf", x[0], new_slot(), ti, fi, 1, 1, 1, u, relu=True, rank=rank,
                     c_pad=_pad4(u))
            offs = [buf.put(p, pad_last=True) for p in parts[:2 * rank]]
            op.w_off, op.w2_off = offs[0], offs[rank]
            op.w = [view(o, (fi, op.c_pad)) for o in offs[:rank]]
            op.w2 = [view(o, (ti, op.c_pad)) for o in offs[rank:]]
            with_bias(op, parts[-1])
            prog.append(op)
            x = (op.dst, (1, 1, u))
        else:
            raise ValueError(f"unknown op kind {kind!r}")
    if wi != len(weights) or not prog or x[1] != (1, 1, ncls):
        raise ValueError(f"op list ends on {x[1]} after {wi} of {len(weights)} weights")
    if shortcut is not None:
        raise ValueError("op list ends with an unused shortcut")
    prog[-1].dst = OUTPUT
    return prog, np.concatenate(buf.pieces) if buf.pieces else np.zeros(0, np.float32)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def is_gemm(op: _Op) -> bool:
    """Whether the kernel runs the step as its implicit GEMM: a conv in full
    or c1 mode, or a dense layer (a 1x1 conv over a 1x1 map)."""
    return op.kind == "dense" or (op.kind == "conv" and op.mode != "dw")


def gemm_plan(op: _Op, batch: int, blocks: int = H100_GRID_BLOCKS) -> Dict[str, int]:
    """The GEMM plan of a conv (full, c1) or dense step at `batch` on a grid
    of `blocks`: the `tile` (GEMM_TILES), M = batch x t_out x f_out rows in
    `tiles_m` tiles, N = c_out in `tiles_n`, K = taps x c_in (`k_total`) in
    32-wide slices, cut into `splits` parts of `split_slices` slices (the
    last part may be shorter). Units = tiles x splits.

    A step with fewer tiles than the grid has blocks is split until its
    units reach the grid or each part is MIN_K_PART long: parts of
    slices // ceil(blocks / tiles) slices, and never fewer than
    MIN_K_PART / 32; a thread per output adds the parts in split order.
    `vec` is 4 where c_in is a multiple of 4 (16-byte copies of the
    activations), else 1 (4-byte copies)."""
    tile = 1 if op.c_pad <= NARROW_N else 0
    bm, bn, bk = GEMM_TILES[tile]
    k_total = op.kh * op.kw * op.c_in
    m = batch * op.t_out * op.f_out
    tiles_m, tiles_n = _cdiv(m, bm), _cdiv(op.c_out, bn)
    slices = _cdiv(k_total, bk)
    per = max(_cdiv(MIN_K_PART, bk), slices // _cdiv(blocks, tiles_m * tiles_n))
    return dict(tile=tile, vec=4 if op.c_in % 4 == 0 else 1, k_total=k_total, tiles_m=tiles_m,
                tiles_n=tiles_n, splits=_cdiv(slices, per), split_slices=per)


def op_rows(program: List[_Op], batch: int, blocks: int = H100_GRID_BLOCKS):
    """-> (the kernel's op table at `batch`, one row of OP_FIELDS + PLAN_FIELDS
    per step; the floats the `partial` buffer needs: the largest of a split
    step's splits x M x c_out and gap's batch x n_chunks x c_in)."""
    rows, partial = [], 4
    for op in program:
        floats = max(op.t_in * op.f_in * op.c_in, op.t_out * op.f_out * max(op.c_out, op.c_pad))
        if batch * floats >= 2**31:
            raise ValueError(f"batch {batch}: a {op.t_out} x {op.f_out} x {op.c_out} step "
                             "exceeds the kernel's 32-bit item index")
        plan = gemm_plan(op, batch, blocks) if is_gemm(op) else {}
        rows.append(op.row() + [plan.get(f, 0) for f in PLAN_FIELDS])
        if plan.get("splits", 1) > 1:
            partial = max(partial, plan["splits"] * batch * op.t_out * op.f_out * op.c_out)
        elif op.kind == "gap":
            partial = max(partial, batch * op.n_chunks * op.c_in)
    return rows, partial


# ---------------------------------------------------------------------------
# the plan: the program and its weights on the device
# ---------------------------------------------------------------------------


class _K5Args(ctypes.Structure):
    """Mirror of struct K5Args in csrc/infer2d.cu (checked by size at load)."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("feats", "out", "wts", "ops", "ws", "partial")]
        + [(f, ctypes.c_int) for f in ("batch", "n_ops", "in_floats", "slot_floats", "ncls")]
    )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.bind("infer2d", _K5Args, ["k5_infer2d"], "k5_args_size", "k5_error_string")
    lib.k5_op_fields.restype = ctypes.c_int
    lib.k5_grid_size.restype = ctypes.c_int
    lib.k5_gemm_tile.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.k5_gemm_tile.restype = ctypes.c_int
    fields = len(OP_FIELDS) + len(PLAN_FIELDS)
    if lib.k5_op_fields() != fields:
        raise RuntimeError(f"K5Op has {lib.k5_op_fields()} fields, the host {fields}")
    tiles = tuple(tuple(lib.k5_gemm_tile(t, axis) for axis in range(3))
                  for t in range(len(GEMM_TILES)))
    if tiles != GEMM_TILES:
        raise RuntimeError(f"the kernel's GEMM tiles are {tiles}, the host plans {GEMM_TILES}")
    return lib


def build_kernels() -> None:
    """Build (if needed) and load the kernel library now, not at first launch."""
    _library()


def grid_blocks(device) -> int:
    """Blocks of the cooperative grid a launch on `device` uses (occupancy
    x SMs)."""
    with torch.cuda.device(device):
        return _library().k5_grid_size()


class FusedInfer2D:
    """infer(wavs [B, N] f32) -> logits [B, ncls] f32: the MFCC kernel of
    the config's DFT variant (K2, K8 or K9), then K5.

    Weights are folded and lowered once here and live on `device`; the
    input must be on the same device."""

    def __init__(self, model_cfg: ModelConfig, audio_cfg: AudioConfig,
                 params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                 device: torch.device):
        if not fused_infer2d_available(model_cfg, audio_cfg):
            raise ValueError(
                f"the 2D kernel does not serve model={model_cfg.name} "
                f"(kws_architecture={model_cfg.kws_architecture}) with this audio geometry "
                f"({audio_cfg.preprocess_method}, window {audio_cfg.window_size_samples}, "
                f"hop {audio_cfg.window_stride_samples})")
        self.device = resolve_device(device)
        self.audio = audio_cfg
        self.ncls = model_cfg.num_classes
        self.feature_shape = dsp.feature_shape(audio_cfg)
        ops, weights, _ = build_op_list(
            model_cfg, params, batch_stats, self.feature_shape)
        self.program, flat = lower(ops, weights, self.feature_shape, self.ncls)
        self.wts = torch.tensor(flat, device=self.device)

        def dev_view(spec):
            if spec is None:
                return None
            if isinstance(spec, list):
                return [dev_view(s) for s in spec]
            off, shape = spec
            return self.wts[off:off + int(np.prod(shape))].view(shape)

        for op in self.program:
            for name in ("w", "w2", "b", "aff"):
                setattr(op, name, dev_view(getattr(op, name)))
        self.slot_floats = _pad4(max([op.out_floats for op in self.program[:-1]] + [1]))
        self._grid = None
        self._tables: collections.OrderedDict[int, Tuple[torch.Tensor, int]] = (
            collections.OrderedDict())

    def grid_blocks(self) -> int:
        """The grid the plan splits K for: the launch's on the card, an
        H100's on the CPU."""
        if self._grid is None:
            self._grid = (grid_blocks(self.device) if self.device.type == "cuda"
                          else H100_GRID_BLOCKS)
        return self._grid

    def op_table(self, batch: int) -> torch.Tensor:
        """The kernel's op table at `batch` [n_ops, fields] int32 on the
        device. Made at the first call at a batch size and kept for the
        last MAX_TABLES sizes; the copy to the card goes from pinned memory
        without waiting for the stream."""
        return self._table(batch)[0]

    def partial_floats(self, batch: int) -> int:
        return self._table(batch)[1]

    def _table(self, batch: int) -> Tuple[torch.Tensor, int]:
        global k5_tables
        entry = self._tables.pop(batch, None)
        if entry is None:
            with span("k5.plan", batch=batch):
                rows, partial = op_rows(self.program, batch, self.grid_blocks())
                host = torch.tensor(rows, dtype=torch.int32)
                if self.device.type == "cuda":
                    host = host.pin_memory()
                entry = (host.to(self.device, non_blocking=True), partial)
            k5_tables += 1
        self._tables[batch] = entry
        if len(self._tables) > MAX_TABLES:
            self._tables.popitem(last=False)
        return entry

    def macs_per_utterance(self) -> int:
        """Multiply-adds one utterance needs: every conv tap that meets the
        map (taps over the zero padding need no work), the dense layers,
        tconv_full and svdf."""
        total = 0
        for op in self.program:
            if op.kind == "conv":
                ci = 1 if op.mode == "dw" else op.c_in
                total += (op.c_out * ci
                          * valid_taps(op.t_out, op.t_in, op.kh, op.sh, op.pad_t, op.dil)
                          * valid_taps(op.f_out, op.f_in, op.kw, op.sw, op.pad_f, op.dil))
            elif op.kind == "dense":
                total += op.c_in * op.c_out
            elif op.kind == "tconv_full":
                total += op.f_out * op.c_out * op.kw * op.t_in
            elif op.kind == "svdf":
                total += op.rank * op.c_out * op.t_in * (op.f_in + 1)
        return total

    def weight_bytes(self) -> int:
        return 4 * self.wts.numel()

    def kernel_args(self, feats: torch.Tensor, out: torch.Tensor, ws: torch.Tensor,
                    partial: torch.Tensor) -> _K5Args:
        """The launch's arguments; its `n_ops` may be cut to run a prefix of
        the program (the last kept step then writes its slot)."""
        t, f, _ = self.feature_shape
        return _K5Args(feats.data_ptr(), out.data_ptr(), self.wts.data_ptr(),
                       self.op_table(feats.shape[0]).data_ptr(), ws.data_ptr(),
                       partial.data_ptr(), feats.shape[0], len(self.program), t * f,
                       self.slot_floats, self.ncls)

    def buffers(self, batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(workspace, partial) for a launch at `batch`, uninitialised."""
        ws = torch.empty(N_SLOTS * batch * self.slot_floats, device=self.device,
                         dtype=torch.float32)
        partial = torch.empty(self.partial_floats(batch), device=self.device,
                              dtype=torch.float32)
        return ws, partial

    def __call__(self, wavs: torch.Tensor) -> torch.Tensor:
        return fused_infer2d(mfcc.fused_mfcc(wavs, self.audio), self)


def build_fused_infer2d(model_cfg: ModelConfig, audio_cfg: AudioConfig,
                        params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                        *, device) -> FusedInfer2D:
    """-> infer(wavs [B, N] f32) -> logits [B, num_classes] f32, with the
    port's params / batch_stats mappings (models/convert.py)."""
    return FusedInfer2D(model_cfg, audio_cfg, params, batch_stats, device)


# ---------------------------------------------------------------------------
# plain version and dispatch
# ---------------------------------------------------------------------------


def _windows(x: torch.Tensor, op: _Op, fill: float = 0.0):
    """The (i, j) window taps of a conv or pool over x [B, T, F, C], each
    [B, To, Fo, C], in the JAX kernel's order (i major)."""
    keh, kew = (op.kh - 1) * op.dil + 1, (op.kw - 1) * op.dil + 1
    span_t, span_f = op.sh * (op.t_out - 1) + 1, op.sw * (op.f_out - 1) + 1
    hi_t = max(span_t + keh - 1 - (op.t_in + op.pad_t), 0)
    hi_f = max(span_f + kew - 1 - (op.f_in + op.pad_f), 0)
    x = F.pad(x, (0, 0, op.pad_f, hi_f, op.pad_t, hi_t), value=fill)
    for i in range(op.kh):
        rows = x[:, i * op.dil:i * op.dil + span_t:op.sh]
        for j in range(op.kw):
            yield i * op.kw + j, rows[:, :, j * op.dil:j * op.dil + span_f:op.sw]


def _conv_ref(x: torch.Tensor, op: _Op, res: Optional[torch.Tensor]) -> torch.Tensor:
    w = op.w[..., :op.c_out]
    acc = None
    for tap, sl in _windows(x, op):
        if op.mode == "full":
            part = sl @ w[tap]
        else:  # c1: [B,To,Fo,1] * [1,Co]; dw: [B,To,Fo,C] * [1,C]
            part = sl * w[tap]
        acc = part if acc is None else acc + part
    y = acc + op.b
    if op.relu:
        y = torch.relu(y)
    if res is not None:
        y = y + res
        if op.relu2:
            y = torch.relu(y)
    if op.aff is not None:
        y = y * op.aff[0] + op.aff[1]
    return y


def _pool_ref(x: torch.Tensor, op: _Op) -> torch.Tensor:
    avg = op.kind == "pool"
    acc = None
    for _, sl in _windows(x, op, 0.0 if avg else float("-inf")):
        acc = sl if acc is None else (acc + sl if avg else torch.maximum(acc, sl))
    return acc * (1.0 / (op.kh * op.kw)) if avg else acc


def _dense_ref(x: torch.Tensor, op: _Op) -> torch.Tensor:
    y = x.reshape(x.shape[0], op.c_in) @ op.w[:, :op.c_out]
    if op.b is not None:
        y = y + op.b
    return torch.relu(y) if op.relu else y


def _tconv_full_ref(x: torch.Tensor, op: _Op) -> torch.Tensor:
    """x [B, T, F, 1], w [kw, T, U] -> [B, 1, Fo, U]: per f-tap, the whole
    time axis contracted."""
    span_f = op.sw * (op.f_out - 1) + 1
    acc = None
    for j in range(op.kw):
        sl = x[:, :, j:j + span_f:op.sw, 0]  # [B, T, Fo]
        part = sl.transpose(1, 2) @ op.w[j, :, :op.c_out]  # [B, Fo, U]
        acc = part if acc is None else acc + part
    if op.b is not None:
        acc = acc + op.b
    y = torch.relu(acc) if op.relu else acc
    return y[:, None]


def _svdf_ref(x: torch.Tensor, op: _Op) -> torch.Tensor:
    """x [B, T, F, 1] -> [B, U]: frequency filters, per-filter time dot, the
    rank components summed, ReLU(units + bias)."""
    frames = x[..., 0]
    acc = None
    for w_freq, w_time in zip(op.w, op.w2):
        acts = frames @ w_freq[:, :op.c_out]  # [B, T, U]
        part = (acts * w_time[:, :op.c_out]).sum(dim=1)
        acc = part if acc is None else acc + part
    return torch.relu(acc + op.b)


def fused_infer2d_reference(feats: torch.Tensor, plan: FusedInfer2D) -> torch.Tensor:
    """Plain PyTorch version of the kernel: features [B, T, F] -> logits
    [B, ncls], replaying the plan's program on its weights."""
    batch = feats.shape[0]
    slots: Dict[int, torch.Tensor] = {INPUT: feats.to(torch.float32)}
    out = None
    for op in plan.program:
        x = slots[op.src].reshape(batch, op.t_in, op.f_in, op.c_in)
        if op.kind == "conv":
            res = None if op.res < 0 else slots[op.res].reshape(batch, op.t_out, op.f_out,
                                                                 op.c_out)
            y = _conv_ref(x, op, res)
        elif op.kind in ("pool", "maxpool"):
            y = _pool_ref(x, op)
        elif op.kind == "gap":
            y = x.mean(dim=(1, 2))
        elif op.kind == "dense":
            y = _dense_ref(x, op)
        elif op.kind == "tconv_full":
            y = _tconv_full_ref(x, op)
        else:
            y = _svdf_ref(x, op)
        out = slots[op.dst] = y
    return out.reshape(batch, plan.ncls)


def fused_infer2d(feats: torch.Tensor, plan: FusedInfer2D) -> torch.Tensor:
    """Logits of features [B, T, F] f32: the kernel for a CUDA tensor, the
    plain version for a CPU tensor, an error for anything else."""
    global launches
    if feats.device != plan.device:
        raise ValueError(f"features on {feats.device}, 2D plan on {plan.device}")
    t, f, _ = plan.feature_shape
    if feats.dim() != 3 or tuple(feats.shape[1:]) != (t, f):
        raise ValueError(f"features must be [B, {t}, {f}], got {list(feats.shape)}")
    if feats.device.type == "cpu":
        return fused_infer2d_reference(feats, plan)
    if feats.device.type != "cuda":
        raise ValueError(f"no K5 kernel for device type {feats.device.type!r}")
    if feats.dtype != torch.float32:
        raise TypeError(f"features must be float32, got {feats.dtype}")
    if not feats.is_contiguous():
        raise ValueError("features must be contiguous")
    batch = feats.shape[0]
    out = torch.empty((batch, plan.ncls), device=feats.device, dtype=torch.float32)
    if batch == 0:
        return out
    ws, partial = plan.buffers(batch)
    _build.launch(_library(), "k5_infer2d", "k5_error_string",
                  plan.kernel_args(feats, out, ws, partial), feats.device)
    launches += 1
    return out
