"""The benchmark's plain reference against the port's plain path, on the
CPU at small sizes. These tests import the port; the reference does not.
They also pin the frozen operation counts to the port's `step_flops` and
`inference_flops` at both configurations."""

from __future__ import annotations

import json

import pytest
import torch

from portbench.harness import flops, spec, synth
from portbench.reference import augment, draws, frontend, models
from tcresnet_tpu_torch.config import ExperimentConfig, get_preset
from tcresnet_tpu_torch.models import build_model
from tcresnet_tpu_torch.ops import augment as port_aug
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.ops.kernels.augment import augment_reference
from tcresnet_tpu_torch.utils.profiling import inference_flops, step_flops

CONFIGS = ("TCResNet8-1.0", "Res15")


def config(name):
    return json.loads((spec.BENCH_DIR / "configs" / f"{name}.json").read_text())


def port_config(cfg):
    return ExperimentConfig.from_json(json.dumps(cfg))


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_runs_the_preset(name):
    cfg = config(name)
    want = get_preset(name)
    if "batch_size" in cfg["reduced"]:
        want = want.replace(train=want.train.__class__(
            **{**want.train.__dict__, "batch_size": cfg["batch_size"]}))
    assert port_config(cfg) == want


@pytest.mark.parametrize("name", CONFIGS)
def test_leaves_are_the_port_models_weights(name):
    cfg = config(name)
    pc = port_config(cfg)
    g = frontend.Geometry.from_audio(cfg["audio"])
    model = build_model(pc.model, dsp.feature_shape(pc.audio), device="cpu")
    port = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    ref = {k: shape for k, (shape, _) in models.leaves(cfg["architecture"], g.coeffs).items()}
    assert port == ref


def test_mfcc_matches_the_port():
    cfg = config("TCResNet8-1.0")
    g = frontend.Geometry.from_audio(cfg["audio"])
    wavs = torch.rand(3, g.samples, generator=torch.Generator().manual_seed(0)) * 2 - 1
    mine = frontend.mfcc(wavs, g)
    port = dsp.mfcc(wavs, port_config(cfg).audio)
    assert mine.shape == port.shape == (3, g.frames, g.coeffs)
    torch.testing.assert_close(mine, port, atol=1e-4, rtol=1e-5)


def test_draws_and_augmentation_match_the_trainer():
    """The reference's draws are the Trainer's: rows, then the augmentation
    scalars, from the generator of (seed, step)."""
    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.train.trainer import step_seed

    cfg = config("TCResNet8-1.0")
    pc = port_config(cfg)
    data = synth.tone_dataset({**cfg["dataset"], "clips": 32}, 7, "cpu")
    seed, step, batch, n = 2 ** 31 + 5, 3, 16, cfg["dataset"]["samples"]
    gen = torch.Generator().manual_seed(step_seed(seed, step))
    idx, _, silent = DeviceDataset.sample_indices(
        (data["wavs"], data["labels"], data["silent"]), gen, batch)
    scalars = port_aug.draw_scalars(gen, silent, pc.augment, data["noise"], n, True)
    port = augment_reference(data["wavs"], idx, scalars, data["noise"], n)
    port_keep = torch.rand((batch, 48), generator=gen) < 0.5

    d = draws.draw_step(seed, step, batch, 32, cfg["augment"], data["noise"].shape[0],
                        data["noise"].shape[1], n, "cpu")
    assert torch.equal(d.rows, idx) and torch.equal(d.shifts, scalars.shifts)
    assert torch.equal(d.clips, scalars.clips) and torch.equal(d.offs, scalars.offs)
    assert torch.equal(d.vols, scalars.vols)
    mine = augment.augment_rows(data["wavs"], data["silent"], data["noise"], d.rows, d.shifts,
                                d.clips, d.offs, d.vols, n)
    assert torch.equal(mine, port)
    assert torch.equal(draws.dropout_keep(d.generator, (batch, 48), 0.5, "cpu"), port_keep)


def _load(model, weights):
    with torch.no_grad():
        for k, t in model.state_dict().items():
            t.copy_(weights[k])


def test_tc_resnet_matches_the_port_in_training():
    cfg = config("TCResNet8-1.0")
    pc = port_config(cfg)
    g = frontend.Geometry.from_audio(cfg["audio"])
    w = synth.glorot_weights(cfg["architecture"], g.coeffs, 11, "cpu")
    model = build_model(pc.model, dsp.feature_shape(pc.audio), device="cpu").train()
    _load(model, w)
    feats = torch.randn(6, g.frames, g.coeffs, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(9)
    port = model(feats[..., None], generator=gen)
    keep = draws.dropout_keep(torch.Generator().manual_seed(9), (6, 48), 0.5, "cpu")
    mine = models.forward(w, feats, cfg["architecture"], True, keep)
    torch.testing.assert_close(mine, port, atol=1e-5, rtol=1e-5)


def test_res15_matches_the_port_in_inference():
    cfg = config("Res15")
    pc = port_config(cfg)
    g = frontend.Geometry.from_audio(cfg["audio"])
    pool = synth.clip_pool(cfg["dataset"], 4, 3, "cpu")
    w = synth.calibrate(cfg, synth.glorot_weights(cfg["architecture"], g.coeffs, 3, "cpu"),
                        pool, cfg["weights"]["logit_std"])
    model = build_model(pc.model, dsp.feature_shape(pc.audio), device="cpu")
    _load(model, w)
    feats = frontend.mfcc(pool[:2], g)
    with torch.no_grad():
        port = model(feats[..., None])
    mine = models.forward(w, feats, cfg["architecture"], False)
    torch.testing.assert_close(mine, port, atol=1e-4, rtol=1e-4)


def test_calibrated_logits_spread_as_set():
    cfg = config("Res15")
    g = frontend.Geometry.from_audio(cfg["audio"])
    pool = synth.clip_pool(cfg["dataset"], 8, 4, "cpu")
    w = synth.calibrate(cfg, synth.glorot_weights(cfg["architecture"], g.coeffs, 4, "cpu"),
                        pool, 3.0)
    logits = models.forward(w, frontend.mfcc(pool, g), cfg["architecture"], False)
    assert abs(float(logits.std()) - 3.0) < 1e-3


@pytest.mark.parametrize("name,batch", [("TCResNet8-1.0", 8192), ("Res15", 256),
                                        ("TCResNet8-1.0", 3), ("Res15", 1)])
def test_frozen_counts_equal_the_ports(name, batch):
    cfg = config(name)
    pc = port_config(cfg)
    assert flops.step_flops(cfg, batch) == step_flops(pc, batch)
    assert flops.infer_flops(cfg, batch) == inference_flops(pc, batch)


def test_counts_are_linear_in_the_batch():
    for name in CONFIGS:
        cfg = config(name)
        assert flops.infer_flops(cfg, 7) == 7 * flops.infer_flops(cfg, 1)
        assert flops.model_step_flops(cfg, 5) == 5 * flops.model_step_flops(cfg, 1)


def test_fewest_frontend_work_is_below_the_dense_count():
    cfg = config("Res15")
    g = frontend.Geometry.from_audio(cfg["audio"])
    dense = flops.infer_flops(cfg, 1) - flops._cached("model", flops._key(cfg), 1)
    assert 0 < frontend.fewest_flops(g) < dense
