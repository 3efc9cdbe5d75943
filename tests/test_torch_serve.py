"""Serving entry point of the PyTorch port against the JAX one."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tcresnet_tpu_torch.config import AudioConfig, ExperimentConfig, ModelConfig, TrainConfig
from tcresnet_tpu.serve.export import build_inference_fn as jax_build_inference_fn
from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
from tcresnet_tpu_torch.ops import dsp as tdsp
from tcresnet_tpu_torch.ops.kernels import infer as k4
from tcresnet_tpu_torch.serve import export
from tcresnet_tpu_torch.serve.benchmark import (
    benchmark_compiled,
    benchmark_on_device,
    format_report,
)
from tcresnet_tpu_torch.serve.export import auto_fused_max_batch, build_inference_fn
from tests.test_torch_config import to_jax_config

torch.set_num_threads(1)


def _cfg(**audio):
    return ExperimentConfig(
        audio=AudioConfig(clip_duration_ms=160, num_mfccs=20, num_mel_bins=32, **audio),
        model=ModelConfig(name="TCResNet8", num_classes=12),
        train=TrainConfig(),
    )


def _inputs(cfg, batch=5, seed=0):
    seeded = seeded_variables(cfg.model, tdsp.feature_shape(cfg.audio), seed)
    wavs = np.random.default_rng(seed + 1).uniform(
        -1, 1, (batch, cfg.audio.desired_samples)).astype(np.float32)
    return seeded, wavs


@pytest.mark.parametrize("backend", ["xla", "fused", "auto"])
def test_backends_match_jax(backend):
    """wav -> softmax of each backend within 1e-5 of the JAX function of
    the same name (the JAX fused kernel runs in interpret mode)."""
    cfg = _cfg()
    seeded, wavs = _inputs(cfg)
    jfn = jax_build_inference_fn(to_jax_config(cfg), seeded, backend=backend,
                                 _interpret=backend == "fused")
    want = np.asarray(jax.device_get(jfn(wavs)))
    fn = build_inference_fn(cfg, variables_from_jax(cfg.model, **seeded), backend=backend, device="cpu")
    got = fn(torch.tensor(wavs)).numpy()
    assert got.shape == want.shape == (5, 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_features_only_matches_jax():
    cfg = _cfg()
    seeded, _ = _inputs(cfg)
    feats = np.random.default_rng(2).standard_normal(
        (3,) + tdsp.feature_shape(cfg.audio)).astype(np.float32)
    want = np.asarray(jax_build_inference_fn(to_jax_config(cfg), seeded, include_preprocess=False)(feats))
    fn = build_inference_fn(cfg, variables_from_jax(cfg.model, **seeded), include_preprocess=False,
                            device="cpu")
    np.testing.assert_allclose(fn(torch.tensor(feats)).numpy(), want, rtol=0, atol=1e-5)


def test_auto_routes_by_device_and_batch(monkeypatch):
    """On a CPU tensor "auto" is the plain path at every batch size; the
    fused kernel is chosen only for a CUDA tensor at batch <= the table's
    limit."""
    cfg = _cfg()
    seeded, wavs = _inputs(cfg)
    v = variables_from_jax(cfg.model, **seeded)
    calls = []
    real = k4.fused_infer
    monkeypatch.setattr(k4, "fused_infer", lambda x, plan: calls.append(x.shape) or real(x, plan))
    auto = build_inference_fn(cfg, v, backend="auto", device="cpu")
    xla = build_inference_fn(cfg, v, backend="xla", device="cpu")
    np.testing.assert_array_equal(auto(torch.tensor(wavs)).numpy(),
                                  xla(torch.tensor(wavs)).numpy())
    assert calls == []
    assert auto_fused_max_batch("TCResNet8") == 32
    assert auto_fused_max_batch("NoSuchNet") == 32
    assert auto_fused_max_batch("KWS") == 4


def test_errors():
    cfg = _cfg()
    seeded, wavs = _inputs(cfg)
    v = variables_from_jax(cfg.model, **seeded)
    with pytest.raises(ValueError, match="ema_params"):
        build_inference_fn(cfg, v, use_ema=True, device="cpu")
    with pytest.raises(ValueError, match="include_preprocess"):
        build_inference_fn(cfg, v, include_preprocess=False, backend="fused", device="cpu")
    raw = dataclasses.replace(cfg, audio=dataclasses.replace(
        cfg.audio, preprocess_method="no_preprocessing"))
    with pytest.raises(ValueError, match="supported"):
        build_inference_fn(raw, v, backend="fused", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        build_inference_fn(cfg, v, backend="tpu", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        build_inference_fn(cfg, v, precision="high", device="cpu")
    with pytest.raises(ValueError, match="device"):
        build_inference_fn(cfg, v, device=None)
    fn = build_inference_fn(cfg, v, backend="fused", device="cpu")
    with pytest.raises(ValueError, match="meta"):
        fn(torch.tensor(wavs).to("meta"))


def test_use_ema_uses_ema_params():
    """With EMA weights present they replace params (zeros -> uniform
    softmax), as in the JAX package."""
    cfg = _cfg()
    seeded, wavs = _inputs(cfg)
    zeros = jax.tree_util.tree_map(np.zeros_like, seeded["params"])
    v = variables_from_jax(cfg.model, seeded["params"], seeded["batch_stats"], ema_params=zeros)
    for backend in ("xla", "fused"):
        out = build_inference_fn(cfg, v, use_ema=True, backend=backend,
                                 device="cpu")(torch.tensor(wavs)).numpy()
        np.testing.assert_allclose(out, 1.0 / 12, atol=1e-6)


def test_precision_highest_turns_tf32_off_and_restores():
    seen = []

    def probe(x):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return x

    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        export._with_matmul_precision(probe, "highest")(torch.zeros(1))
        assert seen == [(False, False)]
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        assert export._with_matmul_precision(probe, None) is probe
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def test_benchmark_harness_protocol():
    """10 warmup + 50 timed runs, host clock; the CUDA-event variant
    refuses a CPU input rather than timing the CPU."""
    calls = []
    stats = benchmark_compiled(lambda x: calls.append(1), torch.zeros(1))
    assert len(calls) == 60 and stats["count"] == 50
    assert stats["min"] <= stats["median"] <= stats["max"]
    assert format_report(stats).startswith("count=50 ")
    with pytest.raises(ValueError, match="CUDA"):
        benchmark_on_device(lambda x: x, torch.zeros(1))
