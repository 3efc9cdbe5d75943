"""Batch norm in training mode with an optional ReLU after it: one autograd
Function whose forward and backward are the kernels of `csrc/batchnorm.cu`
on a CUDA tensor, and their plain PyTorch version otherwise.

It computes `models/layers.py::SlimBatchNorm`'s training branch (Flax's
BatchNorm with slim's epsilon), then `relu` where asked:

    mean = E[x], var = max(E[x^2] - E[x]^2, 0)        float32, per channel
    y = (x - mean) * rsqrt(var + eps) [* scale] [+ shift], in `out_dtype`
    running = momentum * running + (1 - momentum) * (mean, var)

and its gradient by hand (the clip's is jnp.maximum's: 1/2 at a tie, the
variance of a channel of zeros). With g = dy, masked by y > 0 under
`relu`, and n the elements a channel has:

    dx = mul * g + b * (x - mean) + c,   mul = rstd [* scale]
    b = 2 tie dvar / n,  dvar = -rstd^3 / 2 * sum g (x - mean) [* scale]
    c = -mul * sum g / n
    dscale = rstd * sum g (x - mean),  dshift = sum g

It saves x, the scale and shift and a [3C + 1] vector (mean, rstd, tie
factor, count); y is recomputed from x for the mask. Under a mesh in a
process group (`SlimBatchNorm.mesh`, `parallel/mesh.py`) the sums of x and
x^2 and the count, then the sums of g and g (x - mean), are all-reduced
over the data axis: the moments of the global batch, as the JAX package's
are under jit's global view, and their gradients summed over the ranks;
dscale and dshift stay this process's (the Trainer all-reduces them).

Routes: a CUDA tensor launches the kernels (`launches` counts each, six a
forward and backward) or raises; a CPU tensor, or a `meta` one (no values:
the FLOP counts of `utils/profiling.py`), takes the plain version, the same
forward arithmetic and the same backward formula in PyTorch operators
(float64 for a float64 input, as a gradient check needs). Each direction
is the span `model.batch_norm` (`phase`, `channels`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from tcresnet_tpu_torch.ops.kernels import _build
from tcresnet_tpu_torch.parallel import mesh as meshlib
from tcresnet_tpu_torch.utils.profiling import span

EPS = 1e-3  # slim.batch_norm's epsilon

# Kernel launches since import (or since a caller reset them to 0).
launches = 0

THREADS = 256  # BN_THREADS
SLOTS_PER_SM = 8  # 256-thread blocks an SM holds at once (2,048 threads)
REDUCE_WAVES = 4  # the reductions' blocks per slot, to balance a tail
MIN_CHUNK = 4096  # elements a reduction block walks at least
MAX_CHANNELS = 1024  # the normalise and dx kernels' tables: 5 x 4 KB of shared memory
DTYPES = (torch.float32, torch.bfloat16)


class _BnArgs(ctypes.Structure):
    """Mirror of struct BnArgs in csrc/batchnorm.cu."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in (
            "x", "dy", "out", "weight", "bias", "running_mean", "running_var", "partials",
            "sums", "stats", "coef", "dweight", "dbias")]
        + [("batch", ctypes.c_longlong)]
        + [(f, ctypes.c_int) for f in (
            "channels", "inner", "chunks", "sum_rows", "grid", "vec", "last", "in_bf16",
            "out_bf16", "relu")]
        + [(f, ctypes.c_float) for f in ("momentum", "one_minus_momentum", "eps")]
    )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _build.bind("batchnorm", _BnArgs,
                       ["bn_stats", "bn_finalize", "bn_normalize", "bn_grad_sums",
                        "bn_grad_finalize", "bn_grad_input"],
                       "bn_args_size", "bn_error_string")


def build_kernels() -> None:
    """Build (if needed) and load the kernel library now, not at first launch."""
    _library()


class Plan(NamedTuple):
    """The grids of one tensor: the reductions' (groups, chunks), a group a
    channel, or 32 channels channels-last, and a chunk `per` units, samples
    or (channels-last) rows of C, the last chunk maybe short; and the
    elementwise kernels' `grid` blocks, each walking the flat tensor in
    strides of the grid."""

    groups: int
    chunks: int
    per: int
    grid: int


def plan(batch: int, channels: int, inner: int, sms: int, last: bool = False) -> Plan:
    """The grids for a [batch, channels, inner] tensor (channels-last, [batch
    * inner, channels], where `last`) on a card of `sms` SMs: the reductions
    take REDUCE_WAVES waves of blocks where each still walks MIN_CHUNK
    elements (one chunk where the tensor is small), and the elementwise
    kernels one resident wave, or fewer blocks where the tensor has fewer
    4-element vectors a thread."""
    groups = -(-channels // 32) if last else channels
    units = batch * inner if last else batch
    unit_elems = min(32, channels) if last else inner
    want = -(-REDUCE_WAVES * SLOTS_PER_SM * sms // groups)
    chunks = max(1, min(units, want, units * unit_elems // MIN_CHUNK, 65535))
    per = -(-units // chunks) if units else 0
    chunks = -(-units // per) if units else 1
    total = batch * channels * inner
    grid = max(1, min(SLOTS_PER_SM * sms, -(-total // (THREADS * 4))))
    return Plan(groups, chunks, per, grid)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _affine(xf, mean, mul, bias, shape):
    y = (xf - mean.view(shape)) * mul.view(shape)
    return y if bias is None else y + bias.view(shape)


def _mul(rstd, weight):
    return rstd if weight is None else rstd * weight


def plain_forward(x, weight, bias, running_mean, running_var, momentum: float, relu: bool,
                  out_dtype, mesh):
    """(y, stats): the forward in PyTorch operators, and the [3C + 1] vector
    the backward reads (mean, rstd, tie factor, count)."""
    axes = [0] + list(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    c = x.shape[1]
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if meshlib.in_group(mesh):
        sums = torch.cat([xf.sum(axes), (xf * xf).sum(axes),
                          xf.new_full((1,), float(xf.numel() // c))])
        meshlib.all_reduce_(mesh, sums)
        mean, mean_sq, count = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1], sums[-1:]
    else:
        mean, mean_sq = xf.mean(axes), (xf * xf).mean(axes)
        count = xf.new_full((1,), float(xf.numel() // c))
    d = mean_sq - mean * mean
    var = torch.maximum(d, torch.zeros_like(mean))
    tie = torch.where(d > 0, 1.0, torch.where(d == 0, 0.5, 0.0)).to(d.dtype)
    running_mean.copy_(momentum * running_mean + (1.0 - momentum) * mean)
    running_var.copy_(momentum * running_var + (1.0 - momentum) * var)
    rstd = torch.rsqrt(var + EPS)
    y = _affine(xf, mean, _mul(rstd, weight), bias, shape).to(out_dtype)
    if relu:
        y = torch.relu(y)
    return y, torch.cat([mean, rstd, tie, count])


def plain_backward(dy, x, weight, bias, stats, relu: bool, mesh):
    """(dx, dscale, dshift) by the module's formula in PyTorch operators."""
    axes = [0] + list(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    c = x.shape[1]
    mean, rstd, tie, n = stats[:c], stats[c:2 * c], stats[2 * c:3 * c], stats[3 * c]
    mul = _mul(rstd, weight)
    xf = x.to(stats.dtype)
    g = dy.to(stats.dtype)
    if relu:
        g = g * (_affine(xf, mean, mul, bias, shape).to(dy.dtype) > 0)
    xc = xf - mean.view(shape)
    local = torch.cat([g.sum(axes), (g * xc).sum(axes)])
    sums = meshlib.all_reduce_(mesh, local.clone()) if meshlib.in_group(mesh) else local
    sum_g, sum_gx = sums[:c], sums[c:]
    dvar = -0.5 * rstd * rstd * rstd * _mul(sum_gx, weight)
    b = 2.0 * tie * dvar / n
    dx = mul.view(shape) * g + b.view(shape) * xc - (mul * sum_g / n).view(shape)
    dweight = None if weight is None else rstd * local[c:]
    dbias = None if bias is None else local[:c]
    return dx.to(x.dtype), dweight, dbias


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def check_inputs(x, weight, bias, running_mean, running_var, out_dtype) -> None:
    """What the kernels take: x float32 or bfloat16 of at least 2 dims and
    fewer than 2^31 elements, at most MAX_CHANNELS channels; y float32 or
    bfloat16; scale, shift and the running statistics float32 contiguous
    [C] on x's device. Raises otherwise."""
    if x.dtype not in DTYPES or out_dtype not in DTYPES:
        raise TypeError(f"batch norm kernels take float32 or bfloat16, got {x.dtype} -> "
                        f"{out_dtype}")
    if x.dim() < 2 or not 0 < x.shape[1] <= MAX_CHANNELS or x.numel() >= 2 ** 31:
        raise ValueError(f"batch norm kernels take [B, C, ...] with 1 <= C <= {MAX_CHANNELS} "
                         f"and fewer than 2^31 elements, got {list(x.shape)}")
    c = x.shape[1]
    for name, t in (("weight", weight), ("bias", bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        if t is not None and (t.device != x.device or t.dtype != torch.float32
                              or t.shape != (c,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous [{c}] float32 tensor on {x.device}, "
                             f"got {list(t.shape)} {t.dtype} on {t.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """x in a layout the kernels take: [B, C, ...] contiguous, or a 4D
    channels-last tensor (what cuDNN's 2D convs return on the card); a copy
    in the first where it is neither."""
    if x.is_contiguous() or (x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)):
        return x
    return x.contiguous()


def _args(x, p: Plan, **kw) -> _BnArgs:
    a = _BnArgs(x=x.data_ptr(), batch=x.shape[0], channels=x.shape[1],
                inner=x.numel() // max(1, x.shape[0] * x.shape[1]), chunks=p.chunks,
                grid=p.grid, last=int(not x.is_contiguous()),
                in_bf16=int(x.dtype == torch.bfloat16), eps=EPS)
    for k, v in kw.items():
        setattr(a, k, _ptr(v) if isinstance(v, torch.Tensor) or v is None else v)
    return a


def _plan(x: torch.Tensor) -> Plan:
    b, c = x.shape[:2]
    return plan(b, c, x.numel() // (b * c) if b else 1, _sms(x.device.index or 0),
                last=not x.is_contiguous())


def _vec(total: int, *tensors) -> int:
    """Whether the elementwise kernels may move 4 elements as one vector."""
    return int(total % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _launch(entry: str, args: _BnArgs, device) -> None:
    global launches
    _build.launch(_library(), entry, "bn_error_string", args, device)
    launches += 1


def _summed(partials: torch.Tensor, rows: int, c: int, mesh, count: bool):
    """The sums the coefficients come from and their rows: this process's
    partials, or under a process group their sum over the rows all-reduced
    over the data axis (1 row)."""
    if not meshlib.in_group(mesh):
        return partials, rows
    summed = partials[:rows * 2 * c].view(rows, 2 * c).sum(0)
    if count:
        summed = torch.cat([summed, partials[rows * 2 * c:]])
    return meshlib.all_reduce_(mesh, summed), 1


def kernel_forward(x, weight, bias, running_mean, running_var, momentum: float, relu: bool,
                   out_dtype, mesh):
    """(y, stats) by bn_stats, bn_finalize and bn_normalize, for x in a
    `kernel_layout`; y in x's layout."""
    check_inputs(x, weight, bias, running_mean, running_var, out_dtype)
    c = x.shape[1]
    p = _plan(x)
    partials = torch.empty(p.chunks * 2 * c + 1, dtype=torch.float64, device=x.device)
    _launch("bn_stats", _args(x, p, partials=partials), x.device)
    sums, rows = _summed(partials, p.chunks, c, mesh, count=True)
    stats = torch.empty(3 * c + 1, dtype=torch.float32, device=x.device)
    _launch("bn_finalize", _args(
        x, p, running_mean=running_mean, running_var=running_var, sums=sums, sum_rows=rows,
        stats=stats, momentum=momentum, one_minus_momentum=1.0 - momentum), x.device)
    y = torch.empty_like(x, dtype=out_dtype)
    _launch("bn_normalize", _args(
        x, p, out=y, weight=weight, bias=bias, stats=stats, vec=_vec(x.numel(), x, y),
        out_bf16=int(out_dtype == torch.bfloat16), relu=int(relu)), x.device)
    return y, stats


def kernel_backward(dy, x, weight, bias, stats, relu: bool, mesh):
    """(dx, dscale, dshift) by bn_grad_sums, bn_grad_finalize and
    bn_grad_input, for the x of `kernel_forward`; dy is copied into x's
    layout where it differs."""
    dy = dy.contiguous(memory_format=torch.contiguous_format if x.is_contiguous()
                       else torch.channels_last)
    c = x.shape[1]
    p = _plan(x)
    common = dict(dy=dy, weight=weight, bias=bias, stats=stats,
                  out_bf16=int(dy.dtype == torch.bfloat16), relu=int(relu))
    partials = torch.empty(p.chunks * 2 * c, dtype=torch.float64, device=x.device)
    _launch("bn_grad_sums", _args(x, p, partials=partials, **common), x.device)
    sums, rows = _summed(partials, p.chunks, c, mesh, count=False)
    coef = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    dweight = None if weight is None else torch.empty_like(weight)
    dbias = None if bias is None else torch.empty_like(bias)
    _launch("bn_grad_finalize", _args(
        x, p, partials=partials, sums=sums, sum_rows=rows, coef=coef, dweight=dweight,
        dbias=dbias, **common), x.device)
    dx = torch.empty_like(x)
    _launch("bn_grad_input", _args(x, p, out=dx, coef=coef, vec=_vec(x.numel(), x, dy, dx),
                                   **common), x.device)
    return dx, dweight, dbias


# ---------------------------------------------------------------------------
# the Function
# ---------------------------------------------------------------------------


def _route(x: torch.Tensor) -> bool:
    """True for the kernels (a CUDA tensor), False for the plain version (a
    CPU or meta tensor); raises for another device."""
    if x.device.type == "cuda":
        return True
    if x.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"no batch norm kernel for device type {x.device.type!r}")


class BatchNormReLU(torch.autograd.Function):
    """Batch norm in training mode [+ ReLU] (the module's notes)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, relu, out_dtype,
                mesh):
        with span("model.batch_norm", phase="forward", channels=x.shape[1]):
            if _route(x):
                x = kernel_layout(x)
                fwd = kernel_forward
            else:
                fwd = plain_forward
            y, stats = fwd(x, weight, bias, running_mean, running_var, momentum, relu,
                           out_dtype, mesh)
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.relu, ctx.mesh = relu, mesh
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, bias, stats = ctx.saved_tensors
        with span("model.batch_norm", phase="backward", channels=x.shape[1]):
            bwd = kernel_backward if _route(x) else plain_backward
            dx, dweight, dbias = bwd(dy, x, weight, bias, stats, ctx.relu, ctx.mesh)
        return dx, dweight, dbias, None, None, None, None, None, None


def batch_norm_train(x: torch.Tensor, weight: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], running_mean: torch.Tensor,
                     running_var: torch.Tensor, momentum: float, relu: bool = False,
                     out_dtype: Optional[torch.dtype] = None,
                     mesh: Optional[meshlib.Mesh] = None) -> torch.Tensor:
    """Batch norm of x [B, C, ...] over every dim but 1 with the batch's
    moments, the running statistics updated in place (Flax's `momentum`),
    then ReLU where `relu`; y in `out_dtype` (x's by default)."""
    return BatchNormReLU.apply(x, weight, bias, running_mean, running_var, float(momentum),
                               bool(relu), out_dtype or x.dtype, mesh)
