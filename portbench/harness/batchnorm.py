"""The batch norms of a training step: their frozen bytes, and their device
time inside the benchmarked step.

`work_bytes(cfg, batch)` runs the reference model's forward from the
features on the `meta` device (as `dwconv.work` runs its step) and counts,
at every call of the family's `batch_norm` (`reference/models.py`), five
passes over that call's input, in its dtype: x read and y written in the
forward, dy read, x read and dx written in the backward. That is the least
any implementation of a batch norm and the ReLU after it moves; the [C]
statistics and parameters count nothing. 0 for a family without batch norm.

`step_ms(run)` is the median over the traced pass's steps (`spans`) of the
device milliseconds of the program's `model.batch_norm` spans, forward and
backward, summed per step, each placed in the `train.step` whose host
interval holds it (the backward ones may open on autograd's device thread,
with no parent); None where the program records no such span.
"""

from __future__ import annotations

import functools
import json
import statistics
from typing import Optional
from unittest import mock

import torch

from portbench.harness import flops, spans
from portbench.reference import frontend, models
from portbench.reference import train as ref_train

SPAN = "model.batch_norm"
PASSES = 5  # x, y forward; dy, x, dx backward


@functools.lru_cache(maxsize=None)
def _work_bytes(cfg_json: str, batch: int) -> int:
    cfg = json.loads(cfg_json)
    arch = cfg["architecture"]
    family = models.family(arch)
    if not hasattr(family, "batch_norm"):
        return 0
    g = frontend.Geometry.from_audio(cfg["audio"])
    kinds = {k: kind for k, (_, kind) in models.leaves(arch, g.coeffs).items()}
    weights = flops._meta_weights(cfg)
    labels = torch.zeros(batch, dtype=torch.long, device=flops.META)
    shape = models.dropout_shape(arch, batch)
    keep = None if shape is None else torch.ones(shape, dtype=torch.bool, device=flops.META)
    feats = torch.empty(batch, g.frames, g.coeffs, device=flops.META)
    inputs = []
    original = family.batch_norm

    def counted(x, *args, **kwargs):
        inputs.append(x.numel() * x.element_size())
        return original(x, *args, **kwargs)

    with mock.patch.object(family, "batch_norm", counted):
        ref_train.loss_fn(weights, feats, labels, keep, cfg, arch, kinds, torch.float32)
    return PASSES * sum(inputs)


def work_bytes(cfg: dict, batch: int) -> int:
    """Bytes the batch norms of one training step of `cfg` at `batch` move
    at least."""
    return _work_bytes(flops._key(cfg), batch)


def step_ms(run) -> Optional[float]:
    recs = spans.records(run)
    steps = [r for r in recs if r["name"] == "train.step" and r["device_ms"] is not None]
    bn = [r for r in recs if r["name"] == SPAN and r["device_ms"] is not None]
    per_step = []
    for s in steps:
        inside = [r["device_ms"] for r in bn
                  if s["start_ns"] <= r["start_ns"] and r["end_ns"] <= s["end_ns"]]
        if inside:
            per_step.append(sum(inside))
    return statistics.median(per_step) if per_step else None
