"""What `correct` is decided by must fail what it should, at a size a CPU
test run holds:

- the control, the plain reference in bfloat16 in the program's place,
  fails at least one of each cell's limits, where the program passes all;
- a run with the timed path broken underneath reads `correct` false, once
  for each fault the cell can have: a training step that returns its state
  unchanged; half of each batch left out, the mean taken over the rest; an
  answer altered where it is produced. (No cell spans chips, so none can
  leave out an exchange between them.) Besides, a training step whose
  learning rate is 5% high, and one whose gradient of a single leaf is off
  by half, the last layer's or the first's, read `correct` false.
"""

from __future__ import annotations

import pytest
import torch

from portbench.harness import run as harness
from portbench.tests.conftest import SEED, SERVE, TRAIN

CPU = torch.device("cpu")


def _driver(cell, seconds):
    r = harness.Run(cell, SEED, seconds, False, CPU)
    d = r.driver = cell.kind.Driver(r)
    d.setup()
    if seconds:
        d.window(seconds)
    d.release()
    return d


@pytest.mark.parametrize("name,seconds", [(TRAIN, 0.0), (SERVE, 1.0)])
def test_the_control_fails_where_the_program_passes(small_cell, name, seconds):
    limits = harness.limits(name)
    d = _driver(small_cell(name), seconds)
    program, control = d.check(), d.control()
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control


def test_the_training_faults_fail_the_limits(small_cell):
    limits = harness.limits(TRAIN)
    d = _driver(small_cell(TRAIN), 0.0)
    d.check()
    for fault, numbers in d.faults().items():
        assert any(numbers[k] > limits[k] for k in limits), (fault, numbers)
    assert limits["change_median_gap"] < 1.0  # a state left unchanged reads 1


def _run(cell):
    return harness.run_cell(harness.Run(cell, SEED, 1.0, False, CPU))


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(small_cell, monkeypatch):
    from tcresnet_tpu_torch.train import optim

    def unchanged(self, grads, state):
        return {k: torch.zeros_like(g) for k, g in grads.items()}, state

    monkeypatch.setattr(optim.UnitOptimizer, "update", unchanged)
    assert _run(small_cell(TRAIN))["correct"] is False


def _wrap_update(monkeypatch, before=None, after=None):
    from tcresnet_tpu_torch.train import optim

    real = optim.UnitOptimizer.update

    def update(self, grads, state):
        grads = before(dict(grads)) if before else grads
        updates, new = real(self, grads, state)
        return (after(updates) if after else updates), new

    monkeypatch.setattr(optim.UnitOptimizer, "update", update)


def test_a_step_whose_learning_rate_is_5pct_high_is_not_correct(small_cell, monkeypatch):
    _wrap_update(monkeypatch, after=lambda u: {k: 1.05 * v for k, v in u.items()})
    assert _run(small_cell(TRAIN))["correct"] is False


@pytest.mark.parametrize("leaf", ["fc.weight", "conv0_conv.weight"])
def test_one_wrong_leaf_of_the_gradient_is_not_correct(small_cell, monkeypatch, leaf):
    def wrong(grads):
        grads[leaf] = 1.5 * grads[leaf]
        return grads

    _wrap_update(monkeypatch, before=wrong)
    out = _run(small_cell(TRAIN))
    assert out["correct"] is False
    assert out["checks"]["grad_leaf_worst"]["value"] > out["checks"]["grad_leaf_worst"]["limit"]


def test_a_step_on_half_its_batch_is_not_correct(small_cell, monkeypatch):
    from tcresnet_tpu_torch.train.trainer import Trainer

    real = Trainer._loss

    def half(self, logits, labels):
        keep = logits.shape[0] // 2
        return real(self, logits[:keep], labels[:keep])

    monkeypatch.setattr(Trainer, "_loss", half)
    assert _run(small_cell(TRAIN))["correct"] is False


def _patch_entry(monkeypatch, wrap):
    from tcresnet_tpu_torch.serve import export

    real = export.build_inference_fn

    def build(*args, **kwargs):
        return wrap(real(*args, **kwargs))

    monkeypatch.setattr(export, "build_inference_fn", build)


def test_an_altered_answer_is_not_correct(small_cell, monkeypatch):
    def wrap(fn):
        def altered(x):
            out = fn(x).clone()
            out[0] = out[0].roll(1)
            return out
        return altered

    _patch_entry(monkeypatch, wrap)
    assert _run(small_cell(SERVE))["correct"] is False


def test_a_batch_half_answered_is_not_correct(small_cell, monkeypatch):
    def wrap(fn):
        return lambda x: fn(x[: max(1, x.shape[0] // 2)])

    _patch_entry(monkeypatch, wrap)
    assert _run(small_cell(SERVE))["correct"] is False
