"""The stage profiler of the port (`python -m tcresnet_tpu_torch.tools.profile_scaling`)
on the CPU: each stage body against the JAX package's functions fed the
same draws, and the CLI's rows and table."""

import dataclasses
import inspect
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu.ops import dsp as jdsp
from tcresnet_tpu.ops.pallas.augment import _fused_augment_impl, _fused_gather_augment_impl
from tcresnet_tpu_torch.config import AudioConfig, AugmentConfig, ExperimentConfig
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset
from tcresnet_tpu_torch.ops import augment as aug
from tcresnet_tpu_torch.ops.kernels.augment import AugmentScalars
from tcresnet_tpu_torch.tools import profile_scaling
from tests.test_torch_config import to_jax_config
from tests.test_torch_train import BATCH, N, P, step_draws

torch.set_num_threads(1)

ROWS = 40
SUM_RTOL = 1e-5


def _cfg():
    return ExperimentConfig(
        audio=AudioConfig(clip_duration_ms=200, num_mel_bins=32, num_mfccs=20),
        augment=AugmentConfig(background_frequency=0.8, background_max_volume=0.3))


def _jax_stage_sums(stage, cfg, host, draws) -> list:
    """Each iteration's sum of squares through the JAX package: decode,
    the JAX augmentation kernels in interpret mode (bit-exact to its XLA
    path given the same draws) or the gather kernel, then its front end."""
    padded = np.zeros((ROWS, P), np.int16)
    padded[:, :N] = host.wavs
    noise = jnp.asarray(host.noise_bank)
    jaudio = to_jax_config(cfg.audio)
    sums = []
    for d in draws:
        idx = d["idx"]
        keeps = np.where(host.is_silent[idx], 0.0, 1.0).astype(np.float32)
        scalars = tuple(jnp.asarray(a) for a in d["scalars"]) + (jnp.asarray(keeps),)
        if stage == "gather_augment_mfcc":
            x = _fused_gather_augment_impl(jnp.asarray(padded.reshape(ROWS, P // 128, 128)),
                                           jnp.asarray(idx), scalars, noise, N, True)
        else:
            decoded = host.wavs[idx].astype(np.float32) * np.float32(1.0 / 32768.0)
            x = _fused_augment_impl(jnp.asarray(decoded), scalars, noise, N, True)
        if stage != "augment_xla":
            x = jdsp.preprocess(x, jaudio)
        sums.append(float(np.sum(np.asarray(x, np.float64) ** 2)))
    return sums


@pytest.mark.parametrize("stage", ["augment_xla", "mfcc", "gather_augment_mfcc"])
def test_stage_body_matches_the_jax_stage(monkeypatch, stage):
    """The stage body with injected indices and augmentation scalars: each
    iteration's sum of squares within 1e-5 relative of the JAX stage's."""
    cfg = _cfg()
    host = make_synthetic_dataset(num_samples=ROWS, num_classes=4, desired_samples=N, seed=6)
    data = DeviceDataset(host, "cpu")
    draws = step_draws(3, BATCH)
    calls = {"indices": 0, "scalars": 0}

    def fake_indices(arrays, generator, batch_size, sample_row=None):
        idx = torch.tensor(draws[calls["indices"]]["idx"])
        calls["indices"] += 1
        return idx, arrays[1][idx.long()], arrays[2][idx.long()]

    def fake_scalars(generator, is_silent, aug_cfg, noise_bank, n, is_training):
        d = draws[calls["scalars"]]
        calls["scalars"] += 1
        keeps = torch.where(is_silent, 0.0, 1.0).to(torch.float32)
        return AugmentScalars(*(torch.tensor(a) for a in d["scalars"]), keeps)

    monkeypatch.setattr(DeviceDataset, "sample_indices", staticmethod(fake_indices))
    monkeypatch.setattr(aug, "draw_scalars", fake_scalars)
    body = profile_scaling.stage_body(stage, cfg, data, BATCH)
    got = [float(body(i, torch.zeros(()))) for i in range(len(draws))]
    assert calls == {"indices": 3, "scalars": 3}
    want = _jax_stage_sums(stage, cfg, host, draws)
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=0)
    assert len(set(want)) == 3


def test_cli_prints_rows_and_table(capsys):
    stages = [s for s in profile_scaling.STAGES if s != "step"]
    rows = profile_scaling.main(["--device", "cpu", "--batches", "8", "--dataset-size", "64",
                                 "--n1", "1", "--n2", "2", "--stages", *stages])
    out = capsys.readouterr().out
    printed = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert printed == rows
    assert [r["stage"] for r in rows] == stages
    for r in rows:
        assert r["batch"] == 8 and r["device"] == "cpu" and r["card"] is None
        assert r["launches"] == {}  # the plain versions launch nothing
        assert r["us_per_iter"] == r["host_us_per_iter"]  # one clock on the CPU
        assert np.isfinite(r["enqueue_us_per_iter"])
        assert r["us_per_utt"] == pytest.approx(r["us_per_iter"] / 8)
        assert r["utt_per_s"] == pytest.approx(8e6 / r["us_per_iter"])
    table = out[out.index("batch |"):].splitlines()
    assert table[0] == "batch | " + " | ".join(f"{s} µs" for s in stages)
    assert table[1].startswith("    8 | ") and len(table[1].split("|")) == len(stages) + 1


def test_step_stage_takes_its_steps_a_call():
    """Fifty steps a call by default, as the JAX tool; two here."""
    assert profile_scaling.STEP_STEPS == 50
    assert inspect.signature(profile_scaling.step_seconds).parameters[
        "steps_per_call"].default == profile_scaling.STEP_STEPS
    cfg = profile_scaling.base_config(profile_scaling.parse_args(["--device", "cpu"]))
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, use_synthetic=True))
    host = make_synthetic_dataset(num_samples=32, num_classes=12, desired_samples=16000)
    sec = profile_scaling.step_seconds(cfg, DeviceDataset(host, "cpu"), 4, "float32",
                                       steps_per_call=2)
    assert sec["device"] == sec["host"] and np.isfinite(sec["host"])


def test_defaults_are_the_jax_tools():
    args = profile_scaling.parse_args([])
    assert (args.batches, args.stages, args.dataset_size, args.n1, args.n2, args.dtype,
            args.dsp_backend) == ([1024, 2048, 4096, 8192],
                                  ["sample", "augment", "augment_xla", "mfcc", "step"],
                                  24_100, 10, 60, "bfloat16", "xla")
    with pytest.raises(SystemExit):
        profile_scaling.parse_args(["--n1", "5", "--n2", "5"])
