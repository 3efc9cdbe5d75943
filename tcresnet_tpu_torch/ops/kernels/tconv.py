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
nothing else (a dw launch runs its two passes).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from tcresnet_tpu_torch.models.layers import same_padding
from tcresnet_tpu_torch.ops.kernels import _build

# Kernel launches since import (or since a caller reset them to 0).
fwd_launches = 0
dx_launches = 0
dw_launches = 0

# Shared memory a block stages its samples' rows in (floats): 48 KB.
_STAGE_FLOATS = 12288
_CT = 16  # output channels per fwd / dx block (K7_CT in csrc/tconv.cu)
_THREADS = 256
# dw aims at this many blocks (two per SM of the H100's 132)
_DW_BLOCKS = 264


class _K7Args(ctypes.Structure):
    """Mirror of struct K7Args in csrc/tconv.cu."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("x", "w", "dy", "out", "partial")]
        + [(f, ctypes.c_int) for f in (
            "batch", "ci", "co", "k", "stride", "t", "to", "lo", "nb", "chunk",
            "nchunks", "smem_bytes")]
    )


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


def _kernel_fwd(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    global fwd_launches
    (b, ci, t), (co, _, k) = x.shape, w.shape
    to, _, _ = same_padding(t, k, stride)
    y = torch.empty((b, co, to), device=x.device, dtype=torch.float32)
    if b == 0:
        return y
    tp = (to - 1) * stride + k
    nb = max(1, min(b, _STAGE_FLOATS // (ci * tp)))
    a = _args(b, ci, co, k, stride, t, x=x.data_ptr(), w=w.data_ptr(), out=y.data_ptr(),
              nb=nb, smem_bytes=4 * (ci * k * _CT + nb * ci * tp))
    _build.launch(_library(), "k7_fwd", "k7_error_string", a, x.device)
    fwd_launches += 1
    return y


def _kernel_dx(dy: torch.Tensor, w: torch.Tensor, t: int, stride: int) -> torch.Tensor:
    global dx_launches
    (b, co, to), (_, ci, k) = dy.shape, w.shape
    dx = torch.empty((b, ci, t), device=dy.device, dtype=torch.float32)
    if b == 0:
        return dx
    nb = max(1, min(b, _STAGE_FLOATS // (co * to)))
    a = _args(b, ci, co, k, stride, t, w=w.data_ptr(), dy=dy.data_ptr(), out=dx.data_ptr(),
              nb=nb, smem_bytes=4 * (co * k * _CT + nb * co * to))
    _build.launch(_library(), "k7_dx", "k7_error_string", a, dy.device)
    dx_launches += 1
    return dx


def _dw_plan(batch: int, ci: int, co: int, k: int, t: int, stride: int) -> Tuple[int, int, int]:
    """(samples staged at once, samples per partial, partials) of the dw
    kernel: a fixed function of the shapes, so the partials, and the
    fixed-order sum over them, are the same on every call."""
    to, _, _ = same_padding(t, k, stride)
    tp = (to - 1) * stride + k
    nb = max(1, min(batch, _STAGE_FLOATS // (ci * tp + co * to)))
    tiles = -(-co // 4) * -(-(ci * k) // 4)
    chunks = max(1, _DW_BLOCKS // -(-tiles // _THREADS))
    chunk = max(nb, -(-batch // chunks))
    return nb, chunk, -(-batch // chunk)


def _kernel_dw(x: torch.Tensor, dy: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    global dw_launches
    (b, ci, t), co = x.shape, dy.shape[1]
    to, _, _ = same_padding(t, k, stride)
    if b == 0:
        return torch.zeros((co, ci, k), device=x.device, dtype=torch.float32)
    dw = torch.empty((co, ci, k), device=x.device, dtype=torch.float32)
    nb, chunk, nchunks = _dw_plan(b, ci, co, k, t, stride)
    partial = torch.empty((nchunks, co, ci * k), device=x.device, dtype=torch.float32)
    tp = (to - 1) * stride + k
    a = _args(b, ci, co, k, stride, t, x=x.data_ptr(), dy=dy.data_ptr(), out=dw.data_ptr(),
              partial=partial.data_ptr(), nb=nb, chunk=chunk, nchunks=nchunks,
              smem_bytes=4 * nb * (ci * tp + co * to))
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
