"""Depthwise 3x3 convolution for training, with its TF-SAME pad and bias:
one autograd Function whose forward and backward are the kernels of
`csrc/dwconv.cu`, on a CUDA tensor.

It computes on the card what `models/layers.py::Conv2d` composes
elsewhere for a depthwise conv (groups equal to its input and output
channels, a 3x3 window, dilation 1, SAME):

    y = conv2d(F.pad(x, pads), weight, bias, stride, groups=C)

with `pads` F.pad's (left, right, top, bottom) from `same_padding_2d`, and
its gradient: dx by the transposed stencil, dW and db summed over the
batch, each where autograd asks for it. `Conv2d` sends a conv here where
`takes(x)`; a CPU or `meta` tensor, or one PyTorch traces (`torch.export`,
on a card too), keeps the composition, whose operators are what the CPU
tests, the FLOP counts and an exported program see.

The kernels launch (`launches` counts each, three a forward and backward)
or raise; x is taken channels-last, copied there once where it is not,
and y and dx are channels-last. Where no gradient is wanted (serving) the
forward runs without the Function. They are two operators of the
`tcresnet_dwconv` library (`forward`, `backward`, which also launches the
finalize), so that PyTorch's FLOP counter sees them: `utils/profiling.py`
counts them as it counts the composition's `aten.convolution` and its
backward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from tcresnet_tpu_torch.ops.kernels import _build

# Kernel launches since import (or since a caller reset them to 0).
launches = 0

# What a stage may hold, forward and backward: one sample's maps for a
# slice of the channels (all of them where they fit), or more samples. The
# sizes, and banding the backward only at stride 2, are what the H100 ran
# fastest at DS-CNN L's two shapes (PERF.md §6).
FWD_STAGE_BYTES = 96 * 1024
BWD_STAGE_BYTES = 64 * 1024
MAX_THREADS = 256  # DW_MAX_THREADS
MIN_BAND = 4  # rows a work item walks at least: a band reloads its first window
MAX_SMEM = 227 * 1024  # DW_MAX_SMEM
TERMS = 10  # 9 taps and the bias: a partial row
DTYPES = (torch.float32, torch.bfloat16)


class _DwArgs(ctypes.Structure):
    """Mirror of struct DwArgs in csrc/dwconv.cu."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in (
            "x", "weight", "bias", "dy", "out", "partials", "dweight", "dbias")]
        + [("batch", ctypes.c_longlong)]
        + [(f, ctypes.c_int) for f in (
            "channels", "height", "width", "out_height", "out_width", "stride_h", "stride_w",
            "pad_top", "pad_left", "slice", "group", "rows", "band", "in_band", "chunks",
            "per_chunk", "smem", "vec", "bf16", "want_dx")]
    )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.bind("dwconv", _DwArgs, ["dw_forward", "dw_backward", "dw_finalize"],
                      "dw_args_size", "dw_error_string")
    lib.dw_blocks_per_sm.argtypes = [ctypes.POINTER(_DwArgs), ctypes.c_int]
    lib.dw_blocks_per_sm.restype = ctypes.c_int
    return lib


def build_kernels() -> None:
    """Build (if needed) and load the kernel library now, not at first launch."""
    _library()


# ---------------------------------------------------------------------------
# geometry and the grid
# ---------------------------------------------------------------------------


def out_size(n: int, lo: int, hi: int, stride: int) -> int:
    """Output rows of a 3-tap conv over n rows padded lo + hi."""
    return (n + lo + hi - 3) // stride + 1


class Tile(NamedTuple):
    """What a block holds: `slice` channels (a multiple of 4; the last of
    the `slices` maybe partly past C), `group` samples a stage, `rows`
    rows of threads (slice / 4 * rows threads), each taking work items of
    `band` output rows of a column (the forward, dW) or `in_band` rows of
    dx (input rows at stride 1, dy rows at stride 2), `smem` bytes: the
    slice's weights and bias as floats, then two stages (x, and dy after it
    in the backward), or the backward's [rows, 10, slice] sums where
    larger."""

    slice: int
    slices: int
    group: int
    rows: int
    band: int
    in_band: int
    smem: int


def _band(n_rows: int, cols: int, max_rows: int) -> int:
    """Rows a work item takes: cut each of `cols` columns of `n_rows` rows
    into as many bands as `max_rows` thread rows hold, none shorter than
    MIN_BAND (all of a column where it has fewer)."""
    bands = max(1, min(-(-n_rows // MIN_BAND), max_rows // max(1, cols)))
    return max(1, -(-n_rows // bands))


def tile(backward: bool, batch: int, channels: int, hw: Tuple[int, int],
         out_hw: Tuple[int, int], itemsize: int, stride_h: int) -> Tile:
    """The block's tile for a [batch, C, H, W] -> [batch, C, OH, OW] conv
    at `stride_h` along H: as many 4-channel vectors as keep one sample's
    stage within the direction's budget (then evened out over the slices),
    as many samples as still fit it, and a thread row for each output
    column of the group (input column in the backward's dx) up to
    MAX_THREADS; in the backward at stride 2 each column is cut into bands
    of rows besides (`_band`). Raises where one sample's maps for 4 channels
    do not fit the shared memory."""
    (h, w), (oh, ow) = hw, out_hw
    positions = h * w + (oh * ow if backward else 0)
    per_vec = positions * 4 * itemsize  # one sample, 4 channels
    c4 = -(-channels // 4)
    budget = BWD_STAGE_BYTES if backward else FWD_STAGE_BYTES
    vecs = max(1, min(c4, budget // per_vec, MAX_THREADS))
    slices = -(-c4 // vecs)
    vecs = -(-c4 // slices)
    group = max(1, min(batch, budget // (per_vec * vecs)))
    max_rows = MAX_THREADS // vecs
    banded = backward and stride_h == 2
    band = _band(oh, group * ow, max_rows) if banded else oh
    # dx walks input rows at stride 1 and dy rows at stride 2: oh either way
    in_band = _band(oh, group * w, max_rows) if banded else oh
    work = group * ow * -(-oh // band)
    if backward:
        work = max(work, group * w * -(-oh // in_band))
    rows = max(1, min(work, max_rows))
    stage = group * per_vec * vecs
    sums = rows * TERMS * 4 * vecs * 4 if backward else 0
    smem = TERMS * 4 * vecs * 4 + max(2 * stage, sums)
    if smem > MAX_SMEM:
        raise ValueError(f"a depthwise conv over {h}x{w} maps does not fit the kernel's shared "
                         f"memory ({smem} > {MAX_SMEM} bytes)")
    return Tile(4 * vecs, slices, group, rows, band, in_band, smem)


class Plan(NamedTuple):
    """A launch's tile and its grid: `slices` x `chunks` blocks, one
    resident wave, a chunk walking `per_chunk` groups of samples in order
    (the last chunk maybe fewer, none empty)."""

    tile: Tile
    chunks: int
    per_chunk: int


def plan(t: Tile, batch: int, sms: int, resident: int) -> Plan:
    """The grid for tile `t` on a card of `sms` SMs that holds `resident`
    of its blocks each: one wave of blocks over the slices, its chunks
    evened out over the batch's groups."""
    groups = max(1, -(-batch // t.group))
    chunks = max(1, min(groups, sms * max(1, resident) // t.slices, 65535))
    per = -(-groups // chunks)
    return Plan(t, -(-groups // per), per)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def check_inputs(x, weight, bias, stride, pads) -> None:
    """What the kernels take: x [B, C, H, W] float32 or bfloat16 with fewer
    than 2^31 elements, weight [C, 1, 3, 3] and bias [C] contiguous, in
    x's dtype on its device, strides 1 or 2, the TF-SAME pads of the map
    (the stride-2 dx relies on them to cover every input row). Raises
    otherwise."""
    from tcresnet_tpu_torch.models.layers import same_padding_2d

    if x.dtype not in DTYPES:
        raise TypeError(f"depthwise conv kernels take float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.numel() >= 2 ** 31 or x.shape[1] < 1:
        raise ValueError(f"depthwise conv kernels take [B, C, H, W] with fewer than 2^31 "
                         f"elements, got {list(x.shape)}")
    c = x.shape[1]
    for name, t, shape in (("weight", weight, (c, 1, 3, 3)), ("bias", bias, (c,))):
        if t is not None and (t.device != x.device or t.dtype != x.dtype
                              or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {list(shape)} {x.dtype} tensor on "
                             f"{x.device}, got {list(t.shape)} {t.dtype} on {t.device}")
    if any(s not in (1, 2) for s in stride):
        raise ValueError(f"depthwise conv kernels take strides 1 and 2, got {stride}")
    same = same_padding_2d(tuple(x.shape[2:]), (3, 3), tuple(stride))
    if tuple(pads) != same:
        raise ValueError(f"depthwise conv kernels take the TF-SAME pads {same}, got {pads}")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _resident(backward: bool, bf16: bool, stride_h: int, threads: int, smem: int) -> int:
    a = _DwArgs(slice=4, rows=threads, smem=smem, bf16=int(bf16), stride_h=stride_h)
    return _library().dw_blocks_per_sm(ctypes.byref(a), int(backward))


def _args(x, pads, out_hw, p: Plan, **kw) -> _DwArgs:
    t = p.tile
    a = _DwArgs(x=x.data_ptr(), batch=x.shape[0], channels=x.shape[1], height=x.shape[2],
                width=x.shape[3], out_height=out_hw[0], out_width=out_hw[1], pad_top=pads[2],
                pad_left=pads[0], slice=t.slice, group=t.group, rows=t.rows, band=t.band,
                in_band=t.in_band, chunks=p.chunks, per_chunk=p.per_chunk, smem=t.smem,
                bf16=int(x.dtype == torch.bfloat16))
    for k, v in kw.items():
        setattr(a, k, (None if v is None else v.data_ptr()) if not isinstance(v, int) else v)
    return a


def _plan(x, out_hw, backward: bool, stride_h: int) -> Plan:
    t = tile(backward, x.shape[0], x.shape[1], tuple(x.shape[2:]), out_hw, x.element_size(),
             stride_h)
    threads = t.slice // 4 * t.rows
    resident = _resident(backward, x.dtype == torch.bfloat16, stride_h, threads, t.smem)
    if resident < 1:
        raise RuntimeError(f"the depthwise conv kernel fits no block of {threads} threads and "
                           f"{t.smem} bytes of shared memory on an SM")
    return plan(t, x.shape[0], _sms(x.device.index or 0), resident)


def _launch(entry: str, args: _DwArgs, device) -> None:
    global launches
    _build.launch(_library(), entry, "dw_error_string", args, device)
    launches += 1


def _vec(c: int, *tensors) -> int:
    """Whether the staging and the stores may move 4 channels as one vector."""
    return int(c % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _out_hw(x, stride, pads) -> Tuple[int, int]:
    return (out_size(x.shape[2], pads[2], pads[3], stride[0]),
            out_size(x.shape[3], pads[0], pads[1], stride[1]))


def _cuda_forward(x, weight, bias, stride, pads):
    """The `tcresnet_dwconv::forward` operator on the card: y by dw_forward."""
    x = _channels_last(x)
    check_inputs(x, weight, bias, stride, pads)
    out_hw = _out_hw(x, stride, pads)
    y = torch.empty((x.shape[0], x.shape[1]) + out_hw, dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    if y.numel():
        p = _plan(x, out_hw, False, stride[0])
        _launch("dw_forward", _args(x, pads, out_hw, p, weight=weight, bias=bias, out=y,
                                    stride_h=stride[0], stride_w=stride[1],
                                    vec=_vec(x.shape[1], x, y)), x.device)
    return y


def _cuda_backward(dy, x, weight, stride, pads, mask):
    """The `tcresnet_dwconv::backward` operator on the card: (dx, dW, db) by
    dw_backward and dw_finalize, dx empty where mask[0] is false and db
    where mask[2] is (dW is always computed: its sums come with db's)."""
    x, dy = _channels_last(x), _channels_last(dy)
    check_inputs(x, weight, None, stride, pads)
    out_hw = _out_hw(x, stride, pads)
    if dy.dtype != x.dtype or tuple(dy.shape) != tuple(x.shape[:2]) + out_hw:
        raise ValueError(f"dy must be a {list(x.shape[:2]) + list(out_hw)} {x.dtype} tensor, "
                         f"got {list(dy.shape)} {dy.dtype}")
    dx = torch.empty_like(x) if mask[0] else x.new_empty(0)
    dw = torch.empty_like(weight)
    db = x.new_empty(x.shape[1] if mask[2] else 0)
    if not x.numel():
        dw.zero_()
        db.zero_()
    else:
        p = _plan(x, out_hw, True, stride[0])
        partials = torch.empty((p.chunks, TERMS, x.shape[1]), dtype=torch.float32,
                               device=x.device)
        common = dict(stride_h=stride[0], stride_w=stride[1], partials=partials)
        _launch("dw_backward", _args(
            x, pads, out_hw, p, weight=weight, dy=dy, out=dx if mask[0] else None,
            want_dx=int(mask[0]), vec=_vec(x.shape[1], x, dy, *((dx,) if mask[0] else ())),
            **common), x.device)
        _launch("dw_finalize", _args(x, pads, out_hw, p, dweight=dw,
                                     dbias=db if mask[2] else None, **common), x.device)
    return dx, dw, db


_OPS = torch.library.Library("tcresnet_dwconv", "DEF")
_OPS.define("forward(Tensor x, Tensor weight, Tensor? bias, int[2] stride, int[4] pads) -> Tensor")
_OPS.define("backward(Tensor dy, Tensor x, Tensor weight, int[2] stride, int[4] pads, "
            "bool[3] mask) -> (Tensor, Tensor, Tensor)")
_OPS.impl("forward", _cuda_forward, "CUDA")
_OPS.impl("backward", _cuda_backward, "CUDA")
forward_op = torch.ops.tcresnet_dwconv.forward
backward_op = torch.ops.tcresnet_dwconv.backward


def kernel_forward(x, weight, bias, stride, pads):
    """y by the kernel (channels-last)."""
    return forward_op(x, weight, bias, list(stride), list(pads))


def kernel_backward(dy, x, weight, stride, pads, mask, has_bias):
    """(dx, dW, db) by the kernels, None where `mask` wants none."""
    dx, dw, db = backward_op(dy, x, weight, list(stride), list(pads),
                             [mask[0], mask[1], mask[2] and has_bias])
    return (dx if mask[0] else None, dw if mask[1] else None,
            db if mask[2] and has_bias else None)


# ---------------------------------------------------------------------------
# the Function
# ---------------------------------------------------------------------------


def takes(x: torch.Tensor) -> bool:
    """Whether a depthwise conv of x runs the kernels: x on a card, and
    PyTorch not tracing the call (the fake tensors of `torch.export`, or
    torch.compile), which records PyTorch operators."""
    from tcresnet_tpu_torch.ops.dsp import _tracing

    return x.is_cuda and not _tracing()


class DepthwiseConv3x3(torch.autograd.Function):
    """The depthwise 3x3 conv with its pad and bias (the module's notes)."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, pads):
        y = kernel_forward(x, weight, bias, stride, pads)
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.pads, ctx.has_bias = stride, pads, bias is not None
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        mask = tuple(bool(m) for m in ctx.needs_input_grad[:3])
        dx, dw, db = kernel_backward(dy, x, weight, ctx.stride, ctx.pads, mask, ctx.has_bias)
        return dx, dw, db, None, None


def depthwise_conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                      stride: Tuple[int, int], pads: Tuple[int, int, int, int]) -> torch.Tensor:
    """The depthwise 3x3 conv of a CUDA x [B, C, H, W] by weight [C, 1, 3,
    3] (+ bias [C]) at `stride`, over x padded by F.pad's `pads` (left,
    right, top, bottom): through the Function where a gradient is wanted,
    else its forward alone."""
    stride, pads = tuple(stride), tuple(pads)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, weight, bias)):
        return DepthwiseConv3x3.apply(x, weight, bias, stride, pads)
    return kernel_forward(x, weight, bias, stride, pads)
