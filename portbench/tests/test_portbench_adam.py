"""The reference Adam step against the port's, on the CPU: the update
rule on random tensors, the first gradient read back from the port's state,
and a small Res trained three steps through the port's Trainer and through
the reference, compared as a training cell compares them."""

from __future__ import annotations

import json

import pytest
import torch

from portbench.harness import run as harness
from portbench.harness import spec
from portbench.reference import train as ref_train
from portbench.reference.optimizers import adam
from portbench.tests.conftest import SEED
from tcresnet_tpu_torch.train.optim import UnitOptimizer, scale_updates

OPTIM = {"optimizer": "adam", "adam_epsilon": 1e-8}


def _tensors(gen, scale=1.0):
    return {"w": scale * torch.randn(64, 9, generator=gen),
            "b": scale * torch.randn(17, generator=gen)}


def test_reference_adam_matches_the_ports_unit_adam_scaled_by_lr():
    gen = torch.Generator().manual_seed(3)
    mine = port = _tensors(gen)
    start = {k: v.clone() for k, v in mine.items()}
    unit = UnitOptimizer("adam", adam_epsilon=OPTIM["adam_epsilon"])
    port_state, state = unit.init(port), adam.init(mine)
    assert ref_train.optimizer(OPTIM) is adam
    for lr in (0.1, 0.1, 0.01):
        grads = _tensors(gen, 1e-2)
        updates, port_state = unit.update(grads, port_state)
        port = {k: port[k] + u for k, u in scale_updates(updates, lr).items()}
        mine, state = adam.step(mine, grads, state, lr, OPTIM)
    assert state["t"] == 3 and int(port_state["count"]) == 3
    for k in mine:  # a step moves by about lr: compare the moves in units of lr, to float32's
        # rounding of a few operations on values of order 1 (m/(1 - b1^t) and the like)
        torch.testing.assert_close((mine[k] - start[k]) / 0.1, (port[k] - start[k]) / 0.1,
                                   rtol=1e-5, atol=1e-6)


def test_first_grad_reads_the_gradient_back_from_the_ports_state():
    gen = torch.Generator().manual_seed(5)
    params, grads = _tensors(gen), _tensors(gen, 1e-3)
    unit = UnitOptimizer("adam")
    _, state = unit.update(grads, unit.init(params))
    for k, g in grads.items():  # mu = (1 - b1) g, one rounding each way
        torch.testing.assert_close(adam.first_grad(state, k), g, rtol=3e-7, atol=0)


def _res_train_cell() -> spec.Cell:
    """Res8Narrow (6 layers of 19 maps, the 4 x 3 front pool) on its recipe
    (Adam at lr 0.1, weight decay 1e-5), at batch 8 on 64 clips."""
    cfg = json.loads((spec.BENCH_DIR / "configs" / "Res15.json").read_text())
    cfg["model"] = {**cfg["model"], "name": "Res8Narrow"}
    cfg["architecture"] = {"family": "Res", "layers": 6, "channels": 19, "dilation": False,
                           "pool": [4, 3], "classes": 12}
    cfg["train"] = {**cfg["train"], "batch_size": 8}
    cfg["dataset"] = {**cfg["dataset"], "clips": 64}
    traffic = json.loads((spec.BENCH_DIR / "traffic" / "train_steps.json").read_text())
    traffic.update(steps_per_call=1, warmup_calls=1)
    kind = spec.load_module(spec.BENCH_DIR / "traffic" / "train.py", "portbench_kind_train")
    return spec.Cell("res8narrow_train_b8", 1, cfg, traffic, kind)


# Both sides run float32 on the CPU with the same draws and weights; they
# differ by their front ends' arithmetic (the MFCCs agree to 1e-4 on values
# near -150) and the order of their sums. Each limit is some times the most
# that four seeds read (SEED, 11, 12, 13) and far below the 5%-high learning
# rate's 0.05 on both change gaps:
TOLERANCES = {
    # one forward pass and the mean loss over 8 rows: read 9.6e-8 at most
    "loss1_gap": 1e-5,
    # one backward pass, by rows (a map's or a class's gradient): read 3.3e-5
    "grad_row_median_gap": 1e-4,
    # Adam moves each element by about lr whatever its gradient's size, so a
    # rounding where |g| is small moves it too, and three steps at lr 0.1
    # carry it into the later gradients: read 2.4e-4
    "change_median_gap": 1e-3,
    # the worst leaf is a small one (fc's 12 rows, a layer's 19 maps): read
    # 3.3e-5 for the gradient and 8.3e-4 for the change
    "grad_leaf_worst": 1e-3,
    "change_leaf_worst": 1e-2,
}


@pytest.fixture(scope="module")
def res_adam():
    """The port's Trainer and the reference over the same three steps, and
    the reference with its learning rate 5% high."""
    r = harness.Run(_res_train_cell(), SEED, 0.0, False, torch.device("cpu"))
    d = r.driver = r.cell.kind.Driver(r)
    d.setup()
    d.release()
    return d.check(), d.faults()["lr_high"]


def test_a_res_trained_with_adam_matches_the_reference(res_adam):
    program, _ = res_adam
    assert set(program) == set(TOLERANCES)
    assert all(program[k] <= TOLERANCES[k] for k in TOLERANCES), program


def test_the_same_comparison_fails_a_learning_rate_5pct_high(res_adam):
    _, lr_high = res_adam
    assert any(lr_high[k] > TOLERANCES[k] for k in TOLERANCES), lr_high
