"""The depthwise convolutions of a training step: their frozen work, and
their device time inside the benchmarked step.

`work(cfg, batch)` runs the reference model's step from the features on
the `meta` device (as `flops.model_step_flops` does) and counts, at every
`aten.convolution` whose groups equal its input channels and its outputs,
and at its backward:

- operations: `flops`' convention, 2 per multiply-add over the taps that
  land on the input, the forward once and the backward once for each of
  dx and dW that autograd asks for;
- bytes: each tensor once, in its own dtype: the forward reads the
  unpadded input, the weight and the bias and writes the output; the
  backward reads dy and the unpadded input and writes dx (unpadded), dW
  and the bias's gradient, each where autograd asks for it.

`step_ms(run)` is the median over the traced pass's steps (`spans`) of the
device milliseconds of the program's `model.depthwise` spans, forward and
backward, each placed in the `train.step` whose host interval holds it
(the backward ones open on autograd's device thread, with no parent);
None where the program records no such span.
"""

from __future__ import annotations

import functools
import json
import math
import statistics
from typing import Optional, Tuple

import torch

from portbench.harness import flops, spans
from portbench.reference import frontend, models
from portbench.reference import train as ref_train

SPAN = "model.depthwise"


class _DepthwiseCount(flops._ConvCount):
    """`flops`' formulas, counting the depthwise convolutions alone and
    their bytes besides."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.bytes = 0

    def _unpadded(self, x) -> int:
        return math.prod(self.padded.get(x, (None, tuple(x.shape)))[1]) * x.element_size()

    @staticmethod
    def _depthwise(x, w, groups) -> bool:
        return 1 < groups == x.shape[1] == w.shape[0]

    def forward(self, x, w, bias, stride, padding, dilation, transposed, output_padding,
                groups, out_val=None) -> int:
        if self._depthwise(x, w, groups):
            self.ops += 2 * self.macs(x, w, out_val.shape, stride, padding, dilation, transposed)
            self.bytes += self._unpadded(x) + w.numel() * w.element_size() \
                + out_val.numel() * out_val.element_size() \
                + (0 if bias is None else bias.numel() * bias.element_size())
        return 0

    def backward(self, grad_out, x, w, bias_sizes, stride, padding, dilation, transposed,
                 output_padding, groups, output_mask, out_val=None) -> int:
        if self._depthwise(x, w, groups):
            dx, dw, db = (bool(m) for m in output_mask)
            one = 2 * self.macs(x, w, grad_out.shape, stride, padding, dilation, transposed)
            self.ops += one * (int(dx) + int(dw))
            size = w.element_size()
            self.bytes += grad_out.numel() * grad_out.element_size() + self._unpadded(x) \
                + (self._unpadded(x) if dx else 0) + (w.numel() * size if dw else 0) \
                + (math.prod(bias_sizes) * size if db and bias_sizes else 0)
        return 0


@functools.lru_cache(maxsize=None)
def _work(cfg_json: str, batch: int) -> Tuple[int, int]:
    from torch.utils.flop_counter import FlopCounterMode

    cfg = json.loads(cfg_json)
    arch = cfg["architecture"]
    g = frontend.Geometry.from_audio(cfg["audio"])
    kinds = {k: kind for k, (_, kind) in models.leaves(arch, g.coeffs).items()}
    weights = flops._meta_weights(cfg)
    names = [k for k in kinds if kinds[k] in ref_train.TRAINED]
    for k in names:
        weights[k].requires_grad_(True)
    labels = torch.zeros(batch, dtype=torch.long, device=flops.META)
    shape = models.dropout_shape(arch, batch)
    keep = None if shape is None else torch.ones(shape, dtype=torch.bool, device=flops.META)
    feats = torch.empty(batch, g.frames, g.coeffs, device=flops.META)
    counter = _DepthwiseCount()
    with FlopCounterMode(display=False, custom_mapping=counter.mapping()):
        loss = ref_train.loss_fn(weights, feats, labels, keep, cfg, arch, kinds, torch.float32)
        torch.autograd.grad(loss, [weights[k] for k in names])
    return counter.ops, counter.bytes


def work(cfg: dict, batch: int) -> Tuple[int, int]:
    """(operations, bytes) of the depthwise convolutions in one training
    step of `cfg` at `batch`; (0, 0) for a model without any."""
    return _work(flops._key(cfg), batch)


def step_ms(run) -> Optional[float]:
    recs = spans.records(run)
    steps = [r for r in recs if r["name"] == "train.step" and r["device_ms"] is not None]
    dw = [r for r in recs if r["name"] == SPAN and r["device_ms"] is not None]
    per_step = []
    for s in steps:
        inside = [r["device_ms"] for r in dw
                  if s["start_ns"] <= r["start_ns"] and r["end_ns"] <= s["end_ns"]]
        if inside:
            per_step.append(sum(inside))
    return statistics.median(per_step) if per_step else None
