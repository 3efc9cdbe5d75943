"""Temporal k x 1 convolution with its backward (counterpart of
tcresnet_tpu/ops/pallas/tconv.py, kernel K7).

A TF-SAME k x 1 conv without bias over the port's activation layout
x [B, Ci, T] and `models/layers.py::TemporalConv`'s weight [Co, Ci, k]
(the Flax kernel [k, 1, Ci, Co] transposed), so no transposes land on
the model's hot path. The kernels are `csrc/tconv.cu` (its source note
says what bounds them on the H100); this module holds:

- the plain PyTorch versions `tconv_fwd_reference`, `tconv_dx_reference`
  and `tconv_dw_reference`: tap sums over shifted, stride-decimated
  slices (the formulation of `ops/kernels/infer.py::_conv_step`), never
  `F.conv1d`, so they hold the kernels to the math and not to cuDNN;
- the kernels' host plans, pure functions of the shapes: `_fwd_plan`,
  `_dx_plan` (with `dx_phases`, the stride phases dx computes one grid
  slice each) and `_dw_plan`;
- the dispatching wrappers `tconv_fwd`, `tconv_dx`, `tconv_dw`: a CPU
  tensor goes to the plain version, a CUDA tensor to the kernel, anything
  else raises;
- `TemporalConvFn`, the `torch.autograd.Function` (the custom_vjp's
  counterpart), and `temporal_conv` over it. Its backward computes dx
  only when the input needs a gradient and dw only when the weight does:
  the JAX VJP always computes dx, but the first conv's input (the
  features) needs none;
- `pallas_temporal_conv`, the JAX function's signature and layout
  (x [B, T, 1, Ci], kernel [k, 1, Ci, Co] -> [B, To, 1, Co], float32),
  for the tests.

The TF-SAME geometry has one home, `models/layers.py::same_padding`.
The JAX package's batch tile, batch padding and zero-stuffed dy were
Mosaic artifacts and are left out.

`fwd_launches`, `dx_launches` and `dw_launches` count kernel launches and
nothing else (a dw launch runs its one or two passes).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from tcresnet_tpu_torch.models.layers import same_padding
from tcresnet_tpu_torch.ops.kernels import _build

# Kernel launches since import (or since a caller reset them to 0).
fwd_launches = 0
dx_launches = 0
dw_launches = 0

# fwd and dx: output rows (sample, position) per block (K7F_ROWS), n8 tiles
# of output channels per block at most (the template widths 1-9), k8 steps
# a slice of channels aims at, and the shared memory a block may use
_FWD_ROWS = 128
_FWD_MAX_NT = 9
_FWD_SLICE_STEPS = 18
_SMEM_LIMIT = 232448
# dw: rows (sample, position) a staged window holds (K7W_ROWS; two windows
# are staged at once) and floats a window's dy row takes (K7W_DROW, 4 mod
# 8: a fragment's lanes, channel g and row tig, read 32 distinct banks);
# the warps that split a block's column tiles
# (K7W_WN; the other two split its rows); blocks the grid aims at (two per
# SM of the H100's 132); rows a chunk holds at least; the most bytes of
# partials against the x and dy they sum; the most n8 tiles a warp takes
# beside 1-5 m16 tiles of output channels (K7_DW_TILES)
_DW_WINDOW = 128
_DW_DROW = _DW_WINDOW + 4
_DW_WN = 2
_DW_BLOCKS = 264
_DW_MIN_ROWS = 256
_DW_PARTIAL_SHARE = 0.5
_DW_MAX_NT = (8, 6, 5, 4, 3)


class _K7Args(ctypes.Structure):
    """Mirror of struct K7Args in csrc/tconv.cu."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("x", "w", "dy", "out", "partial")]
        + [(f, ctypes.c_int) for f in (
            "batch", "ci", "co", "k", "stride", "t", "to", "lo", "chunk", "nchunks",
            "smem_bytes", "ql", "slot_len", "xrow", "kslice", "nt", "mt", "groups")]
    )


class FwdPlan(NamedTuple):
    """How `k7_fwd_kernel` cuts one conv (csrc/tconv.cu says more): n8 tiles
    of output channels per block, the grid, the most samples a block's 128
    rows span, slots per sample in a staged row (To plus the halo
    (k - 1) // stride), slots of one phase's row, floats between two input
    channels' rows (8 mod 16: bank-conflict-free fragment loads), channel
    steps of 8 per slice, slices, shared memory bytes."""

    nt: int
    grid: Tuple[int, int]
    nb: int
    ql: int
    slot_len: int
    xrow: int
    kslice: int
    slices: int
    smem_bytes: int


class DxPlan(NamedTuple):
    """How `k7_dx_kernel` cuts one conv: n8 tiles of input channels per
    block, the grid (row blocks, channel blocks, stride phases), floats
    between two output channels' staged dy rows (8 mod 16), output-channel
    steps of 8 per slice, slices, shared memory bytes. The kernel derives
    each phase's rows from the shapes (`dx_phases`)."""

    nt: int
    grid: Tuple[int, int, int]
    xrow: int
    kslice: int
    slices: int
    smem_bytes: int


class DwPlan(NamedTuple):
    """How `k7_dw_kernel` cuts one conv: m16 tiles of output channels (all
    of them in every block), n8 tiles of (input channel, tap) columns per
    warp (a block has _DW_WN times as many), the grid (chunks, column
    blocks), samples per chunk, input channel groups of 8 a block stages
    at most, slots of one phase's x row, floats between two input
    channels' staged x rows (4 mod 8, as _DW_DROW), shared memory bytes
    (two window stages, or the warps' sums at the end if larger)."""

    mt: int
    nt: int
    grid: Tuple[int, int]
    chunk: int
    groups: int
    slot_len: int
    xrow: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _build.bind("tconv", _K7Args, ["k7_fwd", "k7_dx", "k7_dw"],
                       "k7_args_size", "k7_error_string")


def build_kernels() -> None:
    """Build (if needed) and load the kernel library now, not at first launch."""
    _library()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _padded(x: torch.Tensor, k: int, stride: int) -> Tuple[torch.Tensor, int, int]:
    """x [B, C, T] zero-padded for SAME: (xpad, To, span), where tap j
    reads xpad[..., j : j + span : stride]."""
    t = x.shape[-1]
    to, lo, _ = same_padding(t, k, stride)
    span = stride * (to - 1) + 1
    return F.pad(x, (lo, max(span + k - 1 - t - lo, 0))), to, span


def tconv_fwd_reference(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """y[b,co,o] = sum_j sum_ci x[b,ci,o*s+j-lo] w[co,ci,j]:
    x [B, Ci, T], w [Co, Ci, k] -> [B, Co, To]."""
    k = w.shape[-1]
    xpad, _, span = _padded(x, k, stride)
    y = None
    for j in range(k):
        part = w[:, :, j] @ xpad[:, :, j:j + span:stride]
        y = part if y is None else y + part
    return y


def tconv_dx_reference(dy: torch.Tensor, w: torch.Tensor, t: int, stride: int) -> torch.Tensor:
    """dx[b,ci,t] = sum_j sum_co w[co,ci,j] dy[b,co,(t+lo-j)/s] over the j
    with t+lo-j divisible by s and the quotient in [0, To): each tap's
    contribution added back onto the input rows it read.
    dy [B, Co, To], w [Co, Ci, k] -> [B, Ci, t]."""
    k = w.shape[-1]
    to, lo, _ = same_padding(t, k, stride)
    span = stride * (to - 1) + 1
    dxpad = dy.new_zeros((dy.shape[0], w.shape[1], max(span + k - 1, lo + t)))
    for j in range(k):
        dxpad[:, :, j:j + span:stride] += w[:, :, j].t() @ dy
    return dxpad[:, :, lo:lo + t]


def tconv_dw_reference(x: torch.Tensor, dy: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """dw[co,ci,j] = sum_b sum_o dy[b,co,o] x[b,ci,o*s+j-lo]:
    x [B, Ci, T], dy [B, Co, To] -> [Co, Ci, k]."""
    xpad, _, span = _padded(x, k, stride)
    return torch.stack(
        [torch.einsum("bot,bct->oc", dy, xpad[:, :, j:j + span:stride]) for j in range(k)],
        dim=-1)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check_cuda(name: str, **tensors: torch.Tensor) -> None:
    device = None
    for arg, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {x.device}, the kernel takes CUDA tensors")
        if device is not None and x.device != device:
            raise ValueError(f"{name}: tensors on {device} and {x.device}")
        device = x.device
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _check_shapes(x_shape, w_shape, dy_shape=None, stride: int = 1) -> None:
    if len(w_shape) != 3 or (x_shape is not None and (len(x_shape) != 3 or x_shape[1] != w_shape[1])):
        raise ValueError(f"want x [B, Ci, T] and w [Co, Ci, k], got {list(x_shape or ())} "
                         f"and {list(w_shape)}")
    if stride < 1 or w_shape[-1] < 1:
        raise ValueError(f"stride and k must be >= 1, got {stride} and {w_shape[-1]}")
    if dy_shape is not None and (len(dy_shape) != 3 or dy_shape[1] != w_shape[0]):
        raise ValueError(f"dy must be [B, {w_shape[0]}, To], got {list(dy_shape)}")


def _args(batch, ci, co, k, stride, t, **ptrs) -> _K7Args:
    to, lo, _ = same_padding(t, k, stride)
    a = _K7Args(batch=batch, ci=ci, co=co, k=k, stride=stride, t=t, to=to, lo=lo)
    for name, value in ptrs.items():
        setattr(a, name, value)
    return a


def _slice(c8: int, taps: int, xrow: int, nt: int, what: str) -> Tuple[int, int]:
    """(kslice, smem bytes) of a fwd or dx block: the most channel steps of
    8 a slice takes (about _FWD_SLICE_STEPS k8 steps with its taps) whose
    staged rows and weights fit a block's shared memory."""
    for kslice in range(max(1, min(c8, _FWD_SLICE_STEPS // taps)), 0, -1):
        smem = 4 * (8 * kslice * xrow + taps * kslice * nt * 64)
        if smem <= _SMEM_LIMIT:
            return kslice, smem
    raise ValueError(f"{what} stages more than {_SMEM_LIMIT} bytes of shared memory")


@functools.lru_cache(maxsize=None)
def _fwd_plan(batch: int, ci: int, co: int, k: int, t: int, stride: int) -> FwdPlan:
    """The fwd kernel's cut of a conv, a pure function of the shapes. A
    block's 128 rows m = n * To + o span at most nb samples; it stages,
    per input channel and stride phase, the slots its rows read (128 rows
    plus each sample's halo), for 8 * kslice channels at a time with their
    weights (all taps, its nt * 8 output channels, as float32 to be split
    on use)."""
    to, _, _ = same_padding(t, k, stride)
    halo = (k - 1) // stride
    ql = to + halo
    nb = min(batch, (_FWD_ROWS + to - 2) // to + 1)
    slot_len = min(_FWD_ROWS + nb * halo, nb * ql)
    raw = min(stride, k) * slot_len
    xrow = raw + (8 - raw) % 16
    gx, n8 = -(-batch * to // _FWD_ROWS), -(-co // 8)
    nt = min(n8, _FWD_MAX_NT)
    c8 = -(-ci // 8)
    kslice, smem = _slice(c8, k, xrow, nt, f"k7_fwd: a k={k} stride-{stride} conv over {t} rows")
    return FwdPlan(nt, (gx, -(-n8 // nt)), nb, ql, slot_len, xrow, kslice, -(-c8 // kslice), smem)


def _kernel_fwd(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    global fwd_launches
    (b, ci, t), (co, _, k) = x.shape, w.shape
    to, _, _ = same_padding(t, k, stride)
    y = torch.empty((b, co, to), device=x.device, dtype=torch.float32)
    if b == 0:
        return y
    p = _fwd_plan(b, ci, co, k, t, stride)
    a = _args(b, ci, co, k, stride, t, x=x.data_ptr(), w=w.data_ptr(), out=y.data_ptr(),
              smem_bytes=p.smem_bytes, ql=p.ql, slot_len=p.slot_len, xrow=p.xrow,
              kslice=p.kslice, nt=p.nt)
    _build.launch(_library(), "k7_fwd", "k7_error_string", a, x.device)
    fwd_launches += 1
    return y


def dx_phases(t: int, k: int, stride: int) -> Tuple[Tuple[int, int, int], ...]:
    """Per stride phase p of dx (the rows t with (t + lo) % stride == p):
    (q0, rows, taps), the first q of its rows t = stride * (q0 + r) + p - lo,
    its rows per sample and its taps j = p + stride * i, as `k7_dx_kernel`
    computes them."""
    _, lo, _ = same_padding(t, k, stride)
    out = []
    for p in range(stride):
        taps = -(-(k - p) // stride) if p < k else 0
        q0 = max(0, lo - p + stride - 1) // stride
        last = t - 1 + lo - p
        out.append((q0, 0 if last < 0 else max(0, last // stride - q0 + 1), taps))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _dx_plan(batch: int, ci: int, co: int, k: int, t: int, stride: int) -> DxPlan:
    """The dx kernel's cut of a conv, a pure function of the shapes. Phase
    p's rows m = n * rows + r, 128 a block, span at most nb samples; a block
    stages, per output channel, the dy slots its rows read (128 rows plus
    each sample's halo of taps - 1), for 8 * kslice channels at a time with
    the phase's taps of w^T for its nt * 8 input channels. The row stride
    fits the widest phase, the weights its most taps."""
    to, _, _ = same_padding(t, k, stride)
    phases = dx_phases(t, k, stride)
    window = 0
    for _, rows, taps in phases:
        if rows and taps:
            nb = min(batch, (_FWD_ROWS + rows - 2) // rows + 1)
            window = max(window, min(_FWD_ROWS + nb * (taps - 1), nb * (rows + taps - 1)))
    taps = max(tp for _, _, tp in phases)
    xrow = window + (8 - window) % 16
    n8 = -(-ci // 8)
    nt = min(n8, _FWD_MAX_NT)
    c8 = -(-co // 8)
    kslice, smem = _slice(c8, taps, xrow, nt, f"k7_dx: a k={k} stride-{stride} conv over {t} rows")
    return DxPlan(nt, (-(-batch * to // _FWD_ROWS), -(-n8 // nt), stride), xrow, kslice,
                  -(-c8 // kslice), smem)


def _kernel_dx(dy: torch.Tensor, w: torch.Tensor, t: int, stride: int) -> torch.Tensor:
    global dx_launches
    (b, co, _), (_, ci, k) = dy.shape, w.shape
    dx = torch.empty((b, ci, t), device=dy.device, dtype=torch.float32)
    if b == 0:
        return dx
    p = _dx_plan(b, ci, co, k, t, stride)
    a = _args(b, ci, co, k, stride, t, w=w.data_ptr(), dy=dy.data_ptr(), out=dx.data_ptr(),
              smem_bytes=p.smem_bytes, xrow=p.xrow, kslice=p.kslice, nt=p.nt)
    _build.launch(_library(), "k7_dx", "k7_error_string", a, dy.device)
    dx_launches += 1
    return dx


def _four_mod_eight(n: int) -> int:
    """The least row stride >= n floats that is 4 mod 8: 8 channels' rows
    then start on 8 distinct multiples of 4 banks, and a fragment's lanes
    (channel g, row tig) read 32 distinct banks."""
    return n + (4 - n) % 8


@functools.lru_cache(maxsize=None)
def _dw_plan(batch: int, ci: int, co: int, k: int, t: int, stride: int) -> DwPlan:
    """The dw kernel's cut of a conv, a pure function of the shapes, so the
    partials, and the fixed-order sum over them, are the same on every call.

    A block holds every output channel (mt <= 5) and _DW_WN * nt column
    tiles, nt the most a warp's registers hold beside mt (_DW_MAX_NT),
    spread evenly over the column blocks. The chunks, whole samples, are as
    many as bring the grid to about _DW_BLOCKS blocks, each of at least
    _DW_MIN_ROWS rows, while their partials (co * ci * k floats each,
    written once and read once) stay within _DW_PARTIAL_SHARE of the bytes
    of x and dy; or one chunk takes every row and writes dw itself. A
    geometry the kernel does not serve raises."""
    to, _, _ = same_padding(t, k, stride)
    mt = -(-co // 16)
    if mt > len(_DW_MAX_NT):
        raise ValueError(f"k7_dw: {co} output channels, more than the kernel's "
                         f"{16 * len(_DW_MAX_NT)}")
    n8 = k * -(-ci // 8)
    nt = min(-(-n8 // _DW_WN), _DW_MAX_NT[mt - 1])
    gy = -(-n8 // (_DW_WN * nt))
    nt = -(-n8 // (gy * _DW_WN))
    cols = _DW_WN * nt  # n8 tiles a block
    groups = max((min(u + cols, n8) - 1) // k - u // k + 1 for u in range(0, n8, cols))
    inputs = batch * (ci * t + co * to)
    chunks = max(1, min(-(-_DW_BLOCKS // gy), batch * to // _DW_MIN_ROWS,
                        int(_DW_PARTIAL_SHARE * inputs) // (co * ci * k)))
    chunk = -(-batch // chunks)
    halo = (k - 1) // stride
    nb = min(batch, (_DW_WINDOW + to - 2) // to + 1)
    slot_len = min(_DW_WINDOW + nb * halo, nb * (to + halo))
    xrow = _four_mod_eight(min(stride, k) * slot_len)
    smem = 4 * max(2 * (16 * mt * _DW_DROW + 8 * groups * xrow), 4 * mt * nt * 128)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"k7_dw: a k={k} stride-{stride} conv over {t} rows stages {smem} "
                         f"bytes of shared memory, more than {_SMEM_LIMIT}")
    return DwPlan(mt, nt, (-(-batch // chunk), gy), chunk, groups, slot_len, xrow, smem)


def _kernel_dw(x: torch.Tensor, dy: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    global dw_launches
    (b, ci, t), co = x.shape, dy.shape[1]
    if b == 0:
        return torch.zeros((co, ci, k), device=x.device, dtype=torch.float32)
    p = _dw_plan(b, ci, co, k, t, stride)
    dw = torch.empty((co, ci, k), device=x.device, dtype=torch.float32)
    nchunks = p.grid[0]
    partial = dw if nchunks == 1 else torch.empty((nchunks, co, ci * k), device=x.device,
                                                  dtype=torch.float32)
    a = _args(b, ci, co, k, stride, t, x=x.data_ptr(), dy=dy.data_ptr(), out=dw.data_ptr(),
              partial=partial.data_ptr(), chunk=p.chunk, nchunks=nchunks,
              smem_bytes=p.smem_bytes, slot_len=p.slot_len, xrow=p.xrow, nt=p.nt, mt=p.mt,
              groups=p.groups)
    _build.launch(_library(), "k7_dw", "k7_error_string", a, x.device)
    dw_launches += 1
    return dw


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def tconv_fwd(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x [B, Ci, T] f32, w [Co, Ci, k] f32 -> y [B, Co, ceil(T / stride)]:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    _check_shapes(x.shape, w.shape, stride=stride)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return tconv_fwd_reference(x, w, stride)
    _check_cuda("k7_fwd", x=x, w=w)
    return _kernel_fwd(x, w, stride)


def tconv_dx(dy: torch.Tensor, w: torch.Tensor, t: int, stride: int = 1) -> torch.Tensor:
    """dy [B, Co, To] f32, w [Co, Ci, k] f32 -> dx [B, Ci, t]."""
    _check_shapes(None, w.shape, dy.shape, stride)
    if dy.shape[-1] != same_padding(t, w.shape[-1], stride)[0]:
        raise ValueError(f"dy has {dy.shape[-1]} rows; a conv over {t} rows at "
                         f"stride {stride} gives {same_padding(t, w.shape[-1], stride)[0]}")
    if dy.device.type == "cpu" and w.device.type == "cpu":
        return tconv_dx_reference(dy, w, t, stride)
    _check_cuda("k7_dx", dy=dy, w=w)
    return _kernel_dx(dy, w, t, stride)


def tconv_dw(x: torch.Tensor, dy: torch.Tensor, k: int, stride: int = 1) -> torch.Tensor:
    """x [B, Ci, T] f32, dy [B, Co, To] f32 -> dw [Co, Ci, k]."""
    if x.dim() != 3 or dy.dim() != 3 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"want x [B, Ci, T] and dy [B, Co, To], got {list(x.shape)} "
                         f"and {list(dy.shape)}")
    if k < 1 or stride < 1 or dy.shape[-1] != same_padding(x.shape[-1], k, stride)[0]:
        raise ValueError(f"dy [.., {dy.shape[-1]}] does not match a k={k} stride-{stride} "
                         f"conv over {x.shape[-1]} rows")
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return tconv_dw_reference(x, dy, k, stride)
    _check_cuda("k7_dw", x=x, dy=dy)
    return _kernel_dw(x, dy, k, stride)


class TemporalConvFn(torch.autograd.Function):
    """y = conv(x, w) through the K7 wrappers, or through their plain
    versions on any device when `interpret` (the JAX package's
    "pallas-interpret", a test value)."""

    @staticmethod
    def forward(ctx, x, w, stride: int, interpret: bool):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.interpret = stride, interpret
        return (tconv_fwd_reference if interpret else tconv_fwd)(x, w, stride)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (tconv_dx_reference if ctx.interpret else tconv_dx)(
                dy, w, x.shape[-1], ctx.stride)
        if ctx.needs_input_grad[1]:
            dw = (tconv_dw_reference if ctx.interpret else tconv_dw)(
                x, dy, w.shape[-1], ctx.stride)
        return dx, dw, None, None


def temporal_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                  interpret: bool = False) -> torch.Tensor:
    """Differentiable TF-SAME conv: x [B, Ci, T], w [Co, Ci, k] -> [B, Co, To]."""
    return TemporalConvFn.apply(x, w, stride, interpret)


def pallas_temporal_conv(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
                         interpret: bool = False) -> torch.Tensor:
    """The JAX function's layout: x [B, T, 1, Ci], kernel [k, 1, Ci, Co] ->
    [B, To, 1, Co], computed in float32 (both inputs cast, as the JAX
    function casts them)."""
    b, t, one, ci = x.shape
    k, kw, ci2, co = kernel.shape
    if one != 1 or kw != 1 or ci2 != ci:
        raise ValueError(f"want x [B, T, 1, Ci] and kernel [k, 1, Ci, Co], got "
                         f"{list(x.shape)} and {list(kernel.shape)}")
    xs = x.to(torch.float32)[:, :, 0].transpose(1, 2)
    w = kernel.to(torch.float32)[:, 0].permute(2, 1, 0)
    y = temporal_conv(xs, w, stride, interpret)
    return y.transpose(1, 2)[:, :, None, :]
