"""A reference family and an optimizer are found by name: one put under the
lookup's names here (no file written) runs through the training step, the
frozen counts and the weights' draw; a name without a file raises
KeyError; and TCResNet8-1.0's reference steps reproduce the readings taken
before families and optimizers moved into files of their own."""

from __future__ import annotations

import json
import sys
import types

import pytest
import torch
import torch.nn.functional as F

from portbench.harness import flops, spec, synth
from portbench.reference import frontend, models, strict
from portbench.reference import train as ref_train
from portbench.tests.conftest import SEED

WIDTH, BATCH = 6, 4


def _toy_family(seen: list) -> types.ModuleType:
    """A k x 1 convolution over time, a batch norm with a shift and no scale
    (a trained bias), ReLU, the mean over time, dropout and an fc."""
    mod = types.ModuleType("portbench.reference.families.toy")

    def leaves(arch, coeffs):
        out = {"conv.weight": ((arch["width"], coeffs, 3), "conv")}
        models.bn_leaves(out, "conv_bn", arch["width"], scale=False)
        out["fc.weight"] = ((arch["classes"], arch["width"]), "fc")
        return out

    def forward(w, feats, arch, training, keep=None, dtype=torch.float32, record=None):
        seen.append(None if keep is None else tuple(keep.shape))
        x = F.conv1d(feats.transpose(1, 2).to(dtype), w["conv.weight"].to(dtype)).float()
        x = F.relu(models.batch_norm(x, w, "conv_bn", training, record)).mean(-1)
        if training:
            x = torch.where(keep, x / arch["dropout_keep_prob"], 0.0)
        return (x.to(dtype) @ w["fc.weight"].to(dtype).t()).float()

    def dropout_shape(arch, batch):
        return batch, arch["width"]

    mod.leaves, mod.forward, mod.dropout_shape = leaves, forward, dropout_shape
    return mod


def _toy_optimizer(steps: list) -> types.ModuleType:
    """Plain SGD that keeps the last gradient as its state."""
    mod = types.ModuleType("portbench.reference.optimizers.toysgd")

    def init(params):
        return {}

    def step(params, grads, state, lr, optim):
        steps.append(lr)
        return ({k: params[k].detach() - lr * g for k, g in grads.items()},
                {f"g/{k}": g for k, g in grads.items()})

    mod.init, mod.step = init, step
    mod.first_grad = lambda state, name: state[f"g/{name}"]
    return mod


def _config(name: str) -> dict:
    return json.loads((spec.BENCH_DIR / "configs" / f"{name}.json").read_text())


def test_a_family_and_an_optimizer_are_found_by_name(monkeypatch):
    seen, steps = [], []
    monkeypatch.setitem(sys.modules, "portbench.reference.families.toy", _toy_family(seen))
    monkeypatch.setitem(sys.modules, "portbench.reference.optimizers.toysgd",
                        _toy_optimizer(steps))
    cfg = _config("TCResNet8-1.0")
    cfg["architecture"] = {"family": "Toy", "width": WIDTH, "classes": 12,
                           "dropout_keep_prob": 0.5}
    cfg["optim"] = {**cfg["optim"], "optimizer": "toysgd"}
    cfg["dataset"] = {**cfg["dataset"], "clips": 32}
    g = frontend.Geometry.from_audio(cfg["audio"])

    w = synth.glorot_weights(cfg["architecture"], g.coeffs, SEED, "cpu")
    assert set(w) == {"conv.weight", "conv_bn.bias", "conv_bn.running_mean",
                      "conv_bn.running_var", "fc.weight"}
    assert torch.equal(w["conv_bn.bias"], torch.zeros(WIDTH)) and w["conv.weight"].std() > 0
    assert ref_train.trained_names(cfg["architecture"], g.coeffs) == [
        "conv.weight", "conv_bn.bias", "fc.weight"]

    data = synth.tone_dataset(cfg["dataset"], SEED, "cpu")
    with strict():
        out = ref_train.run_steps(cfg, w, data, 7, 2, BATCH)
    assert steps == [0.1, 0.1] and seen == [(BATCH, WIDTH)] * 2
    assert all(torch.isfinite(torch.tensor(out["losses"])))
    assert set(out["change"]) == {"conv.weight", "conv_bn.bias", "fc.weight"}
    assert float(out["change"]["conv_bn.bias"].abs().max()) > 0  # the bias trains

    # forward: conv 2 x B x (frames - 2) x 3 taps x coeffs x width, fc 2 x B x width x
    # classes; backward: the conv's weight gradient once, the fc's two products
    conv = 2 * BATCH * (g.frames - 2) * 3 * g.coeffs * WIDTH
    fc = 2 * BATCH * WIDTH * 12
    assert flops.model_step_flops(cfg, BATCH) == 2 * conv + 3 * fc
    assert flops.step_flops(cfg, BATCH) > flops.model_step_flops(cfg, BATCH)
    assert flops.infer_flops(cfg, BATCH) > conv + fc


@pytest.mark.parametrize("lookup,file", [
    (lambda: models.leaves({"family": "NoSuchNet"}, 40), "families/nosuchnet.py"),
    (lambda: models.forward({}, torch.zeros(1, 4, 40), {"family": "No.Such"}, False),
     "families/no.such.py"),
    (lambda: ref_train.optimizer({"optimizer": "nosuchopt"}), "optimizers/nosuchopt.py"),
])
def test_an_unknown_name_raises_key_error_naming_the_file(lookup, file):
    with pytest.raises(KeyError, match=file.replace(".", r"\.")):
        lookup()


# TCResNet8-1.0 at batch 8 on 64 clips, three reference steps in float32 on
# one CPU thread from SEED: the losses and fc.weight's change (its float64
# norm), read before the families and optimizers moved into files of their own.
# Taken with torch 2.13.0+cpu on an x86-64 CPU whose torch capability reads
# AVX512, and reproduced with torch 2.11.0+cu128 on another x86-64 host. The
# CPU convolutions' algorithm follows the torch build and the instruction
# set, so another build may read other bits with the reference unchanged:
# then take the values anew from the reference as it stood before any change.
GOLDEN_LOSSES = ("0x1.638c840000000p+1", "0x1.2c1af80000000p+1", "0x1.8edeb60000000p+1")
GOLDEN_FC_CHANGE_NORM = "0x1.95f39d4f0d6d9p-1"


def test_tcresnet8_steps_reproduce_the_readings_from_before_the_lookup():
    cfg = _config("TCResNet8-1.0")
    cfg["dataset"] = {**cfg["dataset"], "clips": 64}
    g = frontend.Geometry.from_audio(cfg["audio"])
    data = synth.tone_dataset(cfg["dataset"], SEED, "cpu")
    w = synth.glorot_weights(cfg["architecture"], g.coeffs, SEED, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the sums' order follows the thread count
    try:
        with strict():
            out = ref_train.run_steps(cfg, w, data, synth.derive(SEED, "trainer") & 0x7FFFFFFF,
                                      3, 8)
    finally:
        torch.set_num_threads(threads)
    assert tuple(x.hex() for x in out["losses"]) == GOLDEN_LOSSES
    norm = float(torch.linalg.vector_norm(out["change"]["fc.weight"].double()))
    assert norm.hex() == GOLDEN_FC_CHANGE_NORM
