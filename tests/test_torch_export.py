"""Deployment of the port (tcresnet_tpu_torch.serve.export: compile_inference,
export_serialized, load_serialized; the adaptive device protocol of
serve.benchmark; the export CLI) against the JAX package's, on the CPU at
tests/test_torch_serve.py's small geometry (160 ms, 20 MFCCs, 32 mel bins).

Tolerance: 1e-5 in softmax, the repo's parity gate (tests/test_serve.py)."""

import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tcresnet_tpu.serve import benchmark as jbench
from tcresnet_tpu.serve import export as jexport
from tcresnet_tpu_torch.models.convert import variables_from_jax
from tcresnet_tpu_torch.ops import dsp as tdsp
from tcresnet_tpu_torch.serve import benchmark as tbench
from tcresnet_tpu_torch.serve import export as texport
from tcresnet_tpu_torch.tools import export as export_cli
from tcresnet_tpu_torch.tools import train as train_cli
from tests.test_torch_config import to_jax_config
from tests.test_torch_serve import _cfg, _inputs

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SOFTMAX_ATOL = 1e-5


def _setup(batch=4, seed=0):
    cfg = _cfg()
    seeded, wavs = _inputs(cfg, batch=batch, seed=seed)
    return cfg, seeded, variables_from_jax(cfg.model, **seeded), wavs


def _feats(cfg, batch, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (batch,) + tdsp.feature_shape(cfg.audio)).astype(np.float32)


@pytest.mark.parametrize("include_preprocess", [True, False], ids=["wav", "features"])
def test_compile_inference_matches_jax(include_preprocess):
    """The traced program at one batch equals JAX's AOT executable; both
    report the same input shape; another batch raises."""
    cfg, seeded, v, wavs = _setup()
    x = wavs if include_preprocess else _feats(cfg, 4)
    jfn, jshape = jexport.compile_inference(to_jax_config(cfg), seeded, 4, include_preprocess)
    fn, shape = texport.compile_inference(cfg, v, 4, include_preprocess, device="cpu")
    assert shape == jshape == x.shape
    got = fn(torch.tensor(x))
    assert type(got) is torch.Tensor and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(jfn(x)), rtol=0, atol=SOFTMAX_ATOL)
    with pytest.raises(ValueError, match="compiled for input"):
        fn(torch.tensor(x[:2]))
    with pytest.raises(ValueError, match="meta"):
        fn(torch.tensor(x).to("meta"))


def test_serialized_round_trip_matches_jax():
    """export_serialized -> load_serialized equals JAX's
    load_serialized(export_serialized(...)), on the artifact's own device
    and with the device named."""
    cfg, seeded, v, wavs = _setup(batch=2)
    want = np.asarray(jexport.load_serialized(
        jexport.export_serialized(to_jax_config(cfg), seeded, 2, platforms=("cpu",)))(wavs))
    data = texport.export_serialized(cfg, v, 2, device="cpu")
    assert isinstance(data, bytes) and len(data) > 1000
    for device in (None, "cpu"):
        got = texport.load_serialized(data, device=device)(torch.tensor(wavs)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=SOFTMAX_ATOL)
    with pytest.raises(Exception):
        texport.load_serialized(data)(torch.tensor(wavs[:1]))


def test_kernel_backends_export_as_the_plain_path():
    """A run trained through the kernels (K7 convs, the fused front end)
    exports the same function: the traced program runs the per-op convs
    and front end."""
    cfg, seeded, v, wavs = _setup(batch=2)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, conv_backend="pallas"),
                      audio=dataclasses.replace(cfg.audio, dsp_backend="pallas"))
    want = texport.build_inference_fn(cfg, v, device="cpu")(torch.tensor(wavs)).numpy()
    got = texport.load_serialized(texport.export_serialized(cfg, v, 2, device="cpu"))(
        torch.tensor(wavs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=SOFTMAX_ATOL)


def test_use_ema():
    """use_ema without ema_params raises; zero EMA params give a uniform
    softmax, in the compiled callable and in the artifact (as
    tests/test_serve.py holds JAX's)."""
    cfg, seeded, v, wavs = _setup(batch=2)
    with pytest.raises(ValueError, match="ema_params"):
        texport.compile_inference(cfg, v, 2, use_ema=True, device="cpu")
    with pytest.raises(ValueError, match="ema_params"):
        texport.export_serialized(cfg, v, 2, use_ema=True, device="cpu")
    zeros = jax.tree_util.tree_map(np.zeros_like, seeded["params"])
    ve = variables_from_jax(cfg.model, seeded["params"], seeded["batch_stats"], ema_params=zeros)
    fn, _ = texport.compile_inference(cfg, ve, 2, use_ema=True, device="cpu")
    art = texport.load_serialized(texport.export_serialized(cfg, ve, 2, use_ema=True, device="cpu"))
    for out in (fn(torch.tensor(wavs)), art(torch.tensor(wavs))):
        np.testing.assert_allclose(out.numpy(), 1.0 / 12, atol=SOFTMAX_ATOL)


EXPORT_FIRST = """
import numpy as np, torch
from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.serve import export
from tests.test_torch_serve import _cfg
cfg = _cfg()
v = variables_from_jax(cfg.model, **seeded_variables(cfg.model, dsp.feature_shape(cfg.audio), 0))
wavs = torch.tensor(np.random.default_rng(1).uniform(-1, 1, (2, cfg.audio.desired_samples))
                    .astype(np.float32))
program = export.load_serialized(export.export_serialized(cfg, v, 2, device="cpu"))
eager = export.build_inference_fn(cfg, v, device="cpu")(wavs)
feats = dsp.preprocess(wavs, cfg.audio)
assert type(eager) is torch.Tensor and type(feats) is torch.Tensor, (type(eager), type(feats))
assert type(eager.abs().max().item()) is float
assert torch.equal(eager, program(wavs)), (eager - program(wavs)).abs().max()
assert dsp._cached_constant.cache_info().currsize > 0
print("real")
"""


def test_export_before_any_eager_call_caches_no_traced_tensor():
    """In a fresh process (the constant cache is process-wide), an export
    before any eager call leaves later eager calls returning real tensors,
    equal to the exported program's output. A cached fake tensor made every
    later `dsp.preprocess` return one."""
    proc = subprocess.run([sys.executable, "-c", EXPORT_FIRST], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0 and proc.stdout.strip() == "real", proc.stderr[-3000:]


SEQUENCES = {
    "converges-at-5": ([10.0, 11.0, 10.5, 9.8, 10.2, 50.0], dict()),
    "trimmed-at-8": ([10.0, 100.0, 10.0, 10.0, 1.0, 10.0, 10.0, 10.5, 10.0], dict()),
    "never": ([1.0, 100.0] * 8, dict(max_repeats=12)),
    "repeats-2": ([5.0, 5.1, 9.0], dict(repeats=2)),
    "tight-target": ([10.0, 10.4, 10.8, 11.2, 11.6, 12.0, 12.4, 10.1, 10.2],
                     dict(target_spread=0.1, max_repeats=9)),
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_adaptive_rule_matches_jax(case, monkeypatch):
    """The same samples through the port's rule and through JAX's
    benchmark_on_device (its host clock fed so that each of its samples is
    the next value) stop at the same sample with the same statistics."""
    values, kw = SEQUENCES[case]
    clock = []
    for s in values:  # JAX's t0, t1, t2 of one sample: ((t2 - t1) - (t1 - t0)) * 1e6 = s
        clock += [0.0, 0.0, s * 1e-6]
    ticks = iter(clock)
    monkeypatch.setattr(jbench, "time", types.SimpleNamespace(perf_counter=lambda: next(ticks)))
    want = jbench.benchmark_on_device(lambda x: x * 2.0, np.zeros(1, np.float32),
                                      warmup_runs=1, num_runs=1, chain_factor=2, **kw)
    fed = iter(values)
    samples, converged = tbench.sample_until_converged(lambda: next(fed), **kw)
    got = tbench.adaptive_stats(samples, converged)
    assert got["repeats"] == want["repeats"] and got["converged"] == want["converged"]
    for key in ("avg", "min", "max", "std"):
        assert got[key] == pytest.approx(want[key], rel=1e-9, abs=1e-12), key


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """A run of the port's train CLI on the CPU (synthetic data, 8 steps, a
    checkpoint every 4, EMA on, a small learning rate so that the softmax
    is not saturated), promoted under best/valid/accuracy."""
    run = tmp_path_factory.mktemp("export") / "run"
    train_cli.main([
        "--device", "cpu", "--synthetic", "--synthetic-samples", "128",
        "--clip-duration-ms", "160", "--batch-size", "16", "--max-step", "8",
        "--step-save-checkpoint", "4", "--train-dir", str(run),
        "--cfg", "audio.num_mfccs=20", "--cfg", "audio.num_mel_bins=32",
        "--cfg", "optim.lr_list=[0.001,0.001,0.001]", "--cfg", "optim.use_ema=true"])
    return run


def test_cli_exports_latest_and_best(trained_run, tmp_path):
    """The CLI restores the run's config and checkpoint (the latest, or the
    promoted best), passes its gates, and writes an artifact that reloads
    to the run's softmax."""
    from tcresnet_tpu_torch.tools.train import load_run_config
    from tcresnet_tpu_torch.train.checkpoint import CheckpointManager

    out = tmp_path / "m.pt2"
    res = export_cli.main(["--train-dir", str(trained_run), "--device", "cpu", "--batch-size",
                           "2", "--output", str(out), "--fused-kernel", "--use-ema"])
    assert res["compiled_err"] <= SOFTMAX_ATOL and res["artifact_err"] <= SOFTMAX_ATOL
    assert res["fused_err_highest"] <= SOFTMAX_ATOL
    assert res["artifact_bytes"] == out.stat().st_size > 1000
    cfg = load_run_config(trained_run)
    raw = CheckpointManager(trained_run / "ckpt").restore_raw()
    x = torch.tensor(np.random.default_rng(0).uniform(
        -1, 1, (2, cfg.audio.desired_samples)).astype(np.float32))
    want = texport.build_inference_fn(cfg, raw, use_ema=True, device="cpu")(x)
    assert float(want.max()) < 0.99  # not saturated: the gates compare something
    got = texport.load_serialized(out.read_bytes())(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=SOFTMAX_ATOL)

    res = export_cli.main(["--train-dir", str(trained_run), "--device", "cpu",
                           "--best-metric", "accuracy", "--no-preprocess"])
    assert res["compiled_err"] <= SOFTMAX_ATOL
    assert res["input_shape"] == [1, *tdsp.feature_shape(cfg.audio)]


def test_cli_failures_exit_nonzero(trained_run, monkeypatch):
    """A failed gate, a missing best and --benchmark off the card exit
    with an error."""
    real = texport.load_serialized
    monkeypatch.setattr(texport, "load_serialized",
                        lambda data, device=None: lambda x: real(data, device)(x) + 1e-3)
    with pytest.raises(SystemExit, match="parity gate failed") as e:
        export_cli.main(["--train-dir", str(trained_run), "--device", "cpu", "--output",
                         str(trained_run / "bad.pt2")])
    assert e.value.code != 0
    with pytest.raises(SystemExit, match="No promoted best"):
        export_cli.main(["--train-dir", str(trained_run), "--device", "cpu",
                         "--best-metric", "nonesuch"])
    with pytest.raises(SystemExit, match="card"):
        export_cli.main(["--train-dir", str(trained_run), "--device", "cpu", "--benchmark"])
