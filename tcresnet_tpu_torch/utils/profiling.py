"""Profiling hooks (counterpart of tcresnet_tpu/utils/profiling.py).

The tracer. `span(name, **attrs)` names a region of the program: the
training step's phases (`train.call` > `train.step` > `train.draw`,
`train.input`, `train.forward`, `train.backward` (with `train.all_reduce`
under a mesh), `train.optimizer`), a served request (`serve.request`),
K5's host plan (`k5.plan`) and a DS-CNN's depthwise convolutions
(`model.depthwise`, `layer` and `phase` forward or backward; the backward
one through `backward_span`, on autograd's thread). With the tracer off a
span is one shared no-op context: one flag test, no clock read, no
`record_function`, no CUDA event.
Inside `tracing(device_events)` each span is kept as a record: its name, an
id, the id of the span that encloses it, its attributes and its host start
and end on the spans' clock, and, with `device_events` on a CUDA process,
a CUDA event at its entry and at its exit on the current stream, whose
device milliseconds are read only by `drain()`. The records sit in memory,
at most `CAPACITY`, the oldest dropped first (`dropped()` counts them).
While a `torch.profiler` records, each span is also a `record_function`.

The spans' clock is Unix nanoseconds: `time.perf_counter_ns()` plus an
offset read when the tracer is turned on (`clock_ns()`). A profile's event
lies at `trace_start_ns(prof)` plus its `time_range` (microseconds) on the
same clock, so an idle gap of the device in a profile can be put down to
the innermost span open on the host at that moment.

`trace(log_dir)` records a `torch.profiler` trace of the code it wraps,
the host's operators and, on a card, its kernels and copies, with the
tracer on (device events off), and writes it as a Chrome trace
(`trace_<pid>.json`, readable in Perfetto or chrome://tracing) into
`log_dir` when the block exits: the program's spans lie on the kernels'
timeline.

`compiled_flops(fn, *args)` counts the floating-point operations of one
call, the counterpart of the JAX module's count from XLA's cost analysis;
`step_flops(cfg, batch)` and `inference_flops(cfg, batch)` count a
training step and a served batch on the configuration's plain path, the
denominators of an achieved FLOP rate.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional

import torch

# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

CAPACITY = 1 << 15  # records kept; past it the oldest are dropped and counted


class _Tracer:
    """The process's tracer: whether it is on, its records and its clock."""

    def __init__(self):
        self.on = False
        self.device_events = False
        self.depth = 0  # nested `tracing` blocks
        self.offset_ns = 0
        self.records: collections.deque = collections.deque(maxlen=CAPACITY)
        self.dropped = 0
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def keep(self, record: "_Span") -> None:
        if len(self.records) == self.records.maxlen:
            self.dropped += 1
        self.records.append(record)


_TRACER = _Tracer()


class _Off:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "attrs", "start_ns", "end_ns", "events", "stream",
                 "function")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.events = self.function = None

    def __enter__(self):
        t = _TRACER
        stack = t.stack()
        self.id = next(t.ids)
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        if torch.autograd._profiler_enabled():
            self.function = torch.profiler.record_function(self.name)
            self.function.__enter__()
        if t.device_events and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.stream = torch.cuda.current_stream()  # looked up once: ~6 us a call
            self.events[0].record(self.stream)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
        if self.function is not None:
            self.function.__exit__(*exc)
        _TRACER.stack().pop()
        _TRACER.keep(self)
        return False


def span(name: str, **attrs):
    """A named region of the program (see the module's notes): a context
    manager, the shared no-op one while the tracer is off."""
    if not _TRACER.on:
        return _OFF
    return _Span(name, attrs)


def backward_span(t: torch.Tensor, name: str, **attrs) -> torch.Tensor:
    """`t`, with a span `name` around the backward of the operation that
    made it: opened by a pre-hook and closed by a hook on `t.grad_fn`. The
    span records on the thread that runs that node, on a card autograd's
    device thread, where no span of the caller is open: it has no parent,
    and a reader places it in a step by its host times. While the tracer
    is off, or where `t` has no `grad_fn`, nothing is registered."""
    if not _TRACER.on or t.grad_fn is None:
        return t
    opened = []

    def pre(grad_outputs):
        opened.append(span(name, **attrs).__enter__())

    def post(grad_inputs, grad_outputs):
        if opened:
            opened.pop().__exit__(None, None, None)

    t.grad_fn.register_prehook(pre)
    t.grad_fn.register_hook(post)
    return t


@contextmanager
def tracing(device_events: bool = True):
    """Turn the tracer on for the block. The outermost block starts with an
    empty buffer and sets the clock's offset, and drops what is left of the
    records at its exit: read them with `drain()` inside it. An inner block
    sets `device_events` for its own extent."""
    t = _TRACER
    outer = t.depth == 0
    if outer:
        t.records = collections.deque(maxlen=CAPACITY)
        t.dropped = 0
        before = time.perf_counter_ns()
        unix = time.time_ns()
        t.offset_ns = unix - (before + time.perf_counter_ns()) // 2
    was = (t.on, t.device_events)
    t.on, t.device_events = True, device_events
    t.depth += 1
    try:
        yield
    finally:
        t.depth -= 1
        t.on, t.device_events = was
        if outer:
            t.records = collections.deque(maxlen=CAPACITY)


def clock_ns() -> int:
    """Now on the spans' clock (Unix nanoseconds)."""
    return time.perf_counter_ns() + _TRACER.offset_ns


def drain() -> List[Dict[str, object]]:
    """The finished spans' records, oldest first, and an empty buffer. Each
    is {name, id, parent (None outside any span), attrs, start_ns, end_ns
    (the spans' clock), device_ms (from its CUDA events, None without)};
    a record with events waits for its exit event here."""
    t = _TRACER
    records, t.records = t.records, collections.deque(maxlen=CAPACITY)
    out = []
    for r in records:
        device_ms = None
        if r.events is not None:
            r.events[1].synchronize()
            device_ms = r.events[0].elapsed_time(r.events[1])
        out.append({"name": r.name, "id": r.id, "parent": r.parent, "attrs": r.attrs,
                    "start_ns": r.start_ns + t.offset_ns, "end_ns": r.end_ns + t.offset_ns,
                    "device_ms": device_ms})
    return out


def dropped() -> int:
    """Records dropped at the cap since the outermost `tracing` began."""
    return _TRACER.dropped


def trace_start_ns(prof) -> int:
    """The time origin of a `torch.profiler` profile on the spans' clock: an
    event lies at this plus its `time_range` in microseconds."""
    return int(prof.profiler.kineto_results.trace_start_ns())


@contextmanager
def trace(log_dir: Optional[str]):
    """A torch.profiler trace of the block, with the tracer on (device
    events off), written to `log_dir` on exit (also when the block raises);
    does nothing when log_dir is falsy. Yields the profiler, or None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        with tracing(device_events=False):
            yield prof
    finally:
        prof.stop()
        out = Path(log_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"trace_{os.getpid()}.json"))


# ---------------------------------------------------------------------------
# FLOP counts
# ---------------------------------------------------------------------------

_aten = torch.ops.aten


def valid_taps(n: int, k: int, stride: int, dilation: int, lo: int, out: int) -> int:
    """The (output row, tap) pairs of a k-tap conv along one axis whose tap
    lands on one of the n input rows (not on the padding): output row o's
    tap j reads row o * stride + j * dilation - lo."""
    return sum(1 for o in range(out) for j in range(k)
               if 0 <= o * stride + j * dilation - lo < n)


class _ConvCount:
    """The custom formulas of `compiled_flops`. A conv counts 2 x (Ci /
    groups) x Co FLOPs for every (sample, output position, tap) whose tap
    lands on the input: XLA's convention, which puts no tap on the padding.
    The port pads explicitly (TF-SAME, `models/layers.py`), so the zero
    padding a conv reads is read off the `constant_pad_nd` that made its
    input, recorded by identity while the count runs."""

    def __init__(self):
        from torch.utils.weak import WeakIdKeyDictionary

        self.padded = WeakIdKeyDictionary()  # tensor -> (zero pads, unpadded shape)

    def pad(self, x, pad, value=0.0, out_val=None) -> int:
        if value == 0 and all(p >= 0 for p in pad):
            self.padded[out_val] = (tuple(pad), tuple(x.shape))
        return 0

    def macs(self, x, w, out_shape, stride, padding, dilation, transposed) -> int:
        """Multiply-adds of one pass of the conv over the taps that land on
        the input."""
        if transposed:
            raise NotImplementedError("compiled_flops counts no transposed conv")
        spatial = x.dim() - 2
        explicit, shape = self.padded.get(x, ((0,) * (2 * spatial), tuple(x.shape)))
        taps = 1
        for d in range(spatial):
            # F.pad's pads run from the last axis: (lo_last, hi_last, lo_prev, ...)
            lo = explicit[2 * (spatial - 1 - d)] if 2 * (spatial - 1 - d) < len(explicit) else 0
            taps *= valid_taps(shape[2 + d], w.shape[2 + d], stride[d], dilation[d],
                               lo + padding[d], out_shape[2 + d])
        return x.shape[0] * taps * w.shape[0] * w.shape[1]

    def forward(self, x, w, bias, stride, padding, dilation, transposed, output_padding,
                groups, out_val=None) -> int:
        return 2 * self.macs(x, w, out_val.shape, stride, padding, dilation, transposed)

    def backward(self, grad_out, x, w, bias_sizes, stride, padding, dilation, transposed,
                 output_padding, groups, output_mask, out_val=None) -> int:
        """dx and dw, each as many multiply-adds as the forward, where
        autograd asks for them (no dx into an input that needs no gradient)."""
        one = 2 * self.macs(x, w, grad_out.shape, stride, padding, dilation, transposed)
        return one * (int(output_mask[0]) + int(output_mask[1]))

    @staticmethod
    def depthwise_macs(x, stride, pads, out_hw) -> int:
        """Multiply-adds of one pass of the depthwise 3x3 conv of
        `ops/kernels/dwconv.py` over the taps that land on the input (its
        pad (left, right, top, bottom) read in place)."""
        taps = valid_taps(x.shape[2], 3, stride[0], 1, pads[2], out_hw[0]) \
            * valid_taps(x.shape[3], 3, stride[1], 1, pads[0], out_hw[1])
        return x.shape[0] * x.shape[1] * taps

    def depthwise_forward(self, x, w, bias, stride, pads, out_val=None) -> int:
        return 2 * self.depthwise_macs(x, stride, pads, out_val.shape[2:])

    def depthwise_backward(self, dy, x, w, stride, pads, mask, out_val=None) -> int:
        """dx and dW as `backward` counts them, where `mask` asks for them."""
        one = 2 * self.depthwise_macs(x, stride, pads, dy.shape[2:])
        return one * (int(mask[0]) + int(mask[1]))

    def mapping(self) -> dict:
        """`FlopCounterMode`'s custom mapping: each formula takes the raw
        arguments and output (`_get_raw`), not their shapes. The depthwise
        conv's kernels count as the composition they replace. The other
        conv operators PyTorch counts raise: nothing here reaches them, and
        their formula counts the padding."""
        from tcresnet_tpu_torch.ops.kernels import dwconv

        def refuse(*args, **kwargs):
            raise NotImplementedError("compiled_flops counts convs at aten.convolution only")

        formulas = {_aten.constant_pad_nd: self.pad, _aten.convolution: self.forward,
                    _aten.convolution_backward: self.backward,
                    dwconv.forward_op: self.depthwise_forward,
                    dwconv.backward_op: self.depthwise_backward}
        for op in (_aten._convolution, _aten.cudnn_convolution, _aten.convolution_overrideable,
                   _aten._slow_conv2d_forward):
            formulas[op] = refuse
        return {op: _raw(f) for op, f in formulas.items()}


def _raw(f):
    def formula(*args, **kwargs):
        return f(*args, **kwargs)

    formula._get_raw = True
    return formula


def compiled_flops(fn, *example_args) -> int:
    """FLOPs of one call `fn(*example_args)`, counted by PyTorch's
    `FlopCounterMode` as the call runs (on the `meta` device no value is
    computed): matmuls (mm, addmm, bmm, baddbmm) 2 x M x K x N, convs and
    their gradients by `_ConvCount` (only the taps that land on the input,
    as XLA counts them; PyTorch's own formula counts the padding too).
    Elementwise operations, reductions and a conv's bias count nothing;
    XLA's cost analysis, which the JAX package's `compiled_flops` reads,
    counts them too, so a whole model's count here is a little below
    JAX's.

    `FlopCounterMode` sees only PyTorch operators: a hand-written kernel,
    launched through ctypes, is invisible to it. A kernel launched during
    the call therefore raises, as does anything `fn` raises; there is no
    "unavailable" (the JAX function returns None where XLA gives no
    analysis). Count a configuration's plain path (`step_flops`,
    `inference_flops`)."""
    from torch.utils.flop_counter import FlopCounterMode

    from tcresnet_tpu_torch.ops.kernels import launch_counts, launches_since

    before = launch_counts()
    with FlopCounterMode(display=False, custom_mapping=_ConvCount().mapping()) as counter:
        fn(*example_args)
    launched = launches_since(before)
    if launched:
        raise RuntimeError(f"kernels launched inside the count, which cannot see them: {launched}")
    return int(counter.get_total_flops())


_META = torch.device("meta")


def _meta_model(cfg, training: bool):
    from tcresnet_tpu_torch.models import build_model
    from tcresnet_tpu_torch.ops import dsp

    model = build_model(cfg.model, dsp.feature_shape(cfg.audio), cfg.train.compute_dtype,
                        device=_META)
    return model.train(training)


def _meta_wavs(cfg, batch: int) -> torch.Tensor:
    return torch.empty(batch, cfg.audio.desired_samples, device=_META)


def step_flops(cfg, batch: int) -> int:
    """FLOPs of one training step of `cfg` at `batch` rows, counted on the
    plain path (`config.plain_config`) on the `meta` device, the same
    number whatever backend `cfg` names: the front end (`dsp.preprocess`),
    the model's forward in training mode, the loss (the Trainer's,
    `train.loss.training_loss`) and the gradient of every parameter, as
    `Trainer._one_step` takes them (dx wherever autograd needs it, so none
    into the features). The draws, the augmentation, batch norm, the
    optimizer and the EMA are gathers and elementwise work, which count
    nothing, as does fusing the front end with the augmentation (K3).
    Counting the Trainer's own step on the plain path gives the same
    number."""
    from tcresnet_tpu_torch.config import plain_config
    from tcresnet_tpu_torch.ops import dsp
    from tcresnet_tpu_torch.train.loss import training_loss

    cfg = plain_config(cfg)
    model = _meta_model(cfg, training=True)
    params = dict(model.named_parameters())

    def step(wavs, onehot):
        total, _, _ = training_loss(model(dsp.preprocess(wavs, cfg.audio)), onehot, params,
                                    cfg.model)
        return torch.autograd.grad(total, list(params.values()))

    onehot = torch.empty(batch, cfg.model.num_classes, device=_META)
    return compiled_flops(step, _meta_wavs(cfg, batch), onehot)


def inference_flops(cfg, batch: int) -> int:
    """FLOPs of serving `batch` wavs of `cfg` (wav -> softmax, the function
    `serve.export.compile_inference` compiles), counted on the plain path
    on the `meta` device."""
    from tcresnet_tpu_torch.config import plain_config
    from tcresnet_tpu_torch.ops import dsp

    cfg = plain_config(cfg)
    model = _meta_model(cfg, training=False)

    @torch.no_grad()
    def infer(wavs):
        return torch.softmax(model(dsp.preprocess(wavs, cfg.audio)), dim=-1)

    return compiled_flops(infer, _meta_wavs(cfg, batch))
