"""Kernel K4's port (tcresnet_tpu_torch.ops.kernels.infer) against the JAX
whole-model kernel run in interpret mode. The kernel itself is tested on
the card by tests/test_torch_cuda.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tcresnet_tpu_torch.config import AudioConfig, ModelConfig
from tcresnet_tpu.ops.pallas import infer as jinfer
from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
from tcresnet_tpu_torch.ops import dsp as tdsp
from tcresnet_tpu_torch.ops.kernels import _build
from tcresnet_tpu_torch.ops.kernels import infer as k4
from tests.test_torch_config import to_jax_config

torch.set_num_threads(1)

# tolerances of tests/test_pallas_infer.py: f32 logits and softmax, and
# the bf16-operand DFT (accumulation order differs)
LOGIT_TOL = dict(atol=5e-4, rtol=1e-4)
SOFTMAX_ATOL = 1e-5
BF16_TOL = dict(atol=5e-3, rtol=5e-3)


def _setup(name, wm=1.0, ncls=12, preprocess="mfcc", n=2560, matmul="float32", seed=0):
    """tests/test_pallas_infer.py's small geometry: 160 ms, 20 MFCCs, 32 mel."""
    audio = AudioConfig(clip_duration_ms=n // 16, num_mfccs=20, num_mel_bins=32,
                        preprocess_method=preprocess, dsp_matmul_dtype=matmul)
    model = ModelConfig(name=name, num_classes=ncls, width_multiplier=wm)
    seeded = seeded_variables(model, tdsp.feature_shape(audio), seed)
    return model, audio, seeded


def _wavs(batch, n, seed=11):
    return np.random.default_rng(seed).uniform(-1, 1, (batch, n)).astype(np.float32)


CASES = {
    "TCResNet8-1.0": dict(name="TCResNet8"),
    "TCResNet14-1.5": dict(name="TCResNet14", wm=1.5),
    "log-mel": dict(name="TCResNet8", preprocess="log_mel_spectrogram"),
    "7-classes": dict(name="TCResNet8", ncls=7),
    "bf16-dft": dict(name="TCResNet8", matmul="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax_kernel(case):
    """The kernel's plain version == build_fused_infer(interpret=True), at
    batch 3 and 5."""
    model, audio, seeded = _setup(**CASES[case])
    jfn = jinfer.build_fused_infer(to_jax_config(model), to_jax_config(audio), seeded["params"], seeded["batch_stats"],
                                   tb=4, interpret=True)
    v = variables_from_jax(model, **seeded)
    plan = k4.build_fused_infer(model, audio, v["params"], v["batch_stats"], device="cpu")
    for batch in (3, 5):
        wavs = _wavs(batch, audio.desired_samples)
        want = np.asarray(jax.device_get(jfn(wavs)))
        got = plan(torch.tensor(wavs)).numpy()
        assert got.shape == want.shape == (batch, model.num_classes)
        if audio.dsp_matmul_dtype == "bfloat16":
            np.testing.assert_allclose(got, want, **BF16_TOL)
            assert (got.argmax(-1) == want.argmax(-1)).all()
        else:
            np.testing.assert_allclose(got, want, **LOGIT_TOL)
            sm = lambda a: np.asarray(jax.nn.softmax(a, axis=-1))  # noqa: E731
            np.testing.assert_allclose(sm(got), sm(want), atol=SOFTMAX_ATOL)


@pytest.mark.parametrize("name,wm", [("TCResNet8", 1.0), ("TCResNet14", 1.5)])
def test_layer_spec_folds_exactly_like_jax(name, wm):
    """Same roles, taps and strides, and bit-identical folded weights."""
    model, _, seeded = _setup(name, wm=wm)
    jspec, jfc = jinfer.build_layer_spec(to_jax_config(model), seeded["params"], seeded["batch_stats"])
    v = variables_from_jax(model, **seeded)
    spec, fc = k4.build_layer_spec(model, v["params"], v["batch_stats"])
    assert [(e["role"], e["k"], e["stride"], e["relu"]) for e in spec] == [
        (e["role"], e["k"], e["stride"], e["relu"]) for e in jspec]
    for e, je in zip(spec, jspec):
        np.testing.assert_array_equal(e["wb"][0], je["wb"][0])
        np.testing.assert_array_equal(e["wb"][1], je["wb"][1].reshape(-1))
    np.testing.assert_array_equal(fc, jfc)


def test_availability_gates():
    good = AudioConfig()
    for name in ("TCResNet8", "TCResNet14"):
        assert k4.fused_infer_available(ModelConfig(name=name), good)
        assert k4.fused_infer_available(ModelConfig(name=name, width_multiplier=1.5), good)
    assert k4.fused_infer_available(ModelConfig(), dataclasses.replace(
        good, preprocess_method="log_mel_spectrogram"))
    assert k4.fused_infer_available(ModelConfig(), dataclasses.replace(
        good, window_size_ms=40.0, window_stride_ms=20.0))
    # conv widths 12 / 18 at width 0.75: padded to 12 / 20 for the kernel
    assert k4.fused_infer_available(ModelConfig(width_multiplier=0.75), good)
    assert k4.fused_infer_available(ModelConfig(width_multiplier=0.5), good)
    assert not k4.fused_infer_available(ModelConfig(name="Res8"), good)
    assert not k4.fused_infer_available(ModelConfig(name="ResNet2D8"), good)
    for bad in (dataclasses.replace(good, window_size_ms=25.0),
                dataclasses.replace(good, preprocess_method="no_preprocessing"),
                # shared memory: a 10 s clip's features and conv buffers
                dataclasses.replace(good, clip_duration_ms=10000)):
        assert not k4.fused_infer_available(ModelConfig(), bad)
    with pytest.raises(ValueError, match="does not serve"):
        k4.build_fused_infer(ModelConfig(name="TCResNet8"),
                             dataclasses.replace(good, window_size_ms=25.0), {}, {},
                             device="cpu")


WIDTHS = (0.5, 0.75, 1.0, 1.25, 1.5)


@pytest.mark.parametrize("wm", WIDTHS)
@pytest.mark.parametrize("name", ["TCResNet8", "TCResNet14"])
def test_availability_equals_jax_at_every_width(name, wm):
    """The kernel serves every width the JAX kernel serves, at the presets'
    1 s MFCC-40 and at the tests' 160 ms geometry."""
    model = ModelConfig(name=name, width_multiplier=wm)
    for audio in (AudioConfig(), _setup(name, wm)[1]):
        want = jinfer.fused_infer_available(to_jax_config(model), to_jax_config(audio))
        assert k4.fused_infer_available(model, audio) == want


@pytest.mark.parametrize("name,wm", [("TCResNet8", 1.25), ("TCResNet14", 1.25),
                                     ("TCResNet8", 0.4)])
def test_widths_padded_to_four(name, wm):
    """Widths that are not multiples of 4 (20/30/40/60 at 1.25; 6/9/12/19 at
    0.4, where 9 and 12 pad alike across a down conv) are laid out padded
    with zeros: every conv's weights and bias beyond the model's widths are
    0, the shapes are `_conv_shapes`', and the plain version over them
    matches JAX's K4 in interpret mode (logits, softmax 1e-5)."""
    model, audio, seeded = _setup(name, wm=wm)
    v = variables_from_jax(model, **seeded)
    plan = k4.build_fused_infer(model, audio, v["params"], v["batch_stats"], device="cpu")
    spec, fc = k4.build_layer_spec(model, v["params"], v["batch_stats"])
    shapes = k4._conv_shapes(model, plan.geom.fe.frames)
    assert [c.w.shape[1] for c in plan.convs] == [c for _, c in shapes]
    assert all(c.w.shape[1] % 4 == 0 and c.w.shape[1] - 4 < e["wb"][0].shape[1]
               for c, e in zip(plan.convs, spec))
    for c, e in zip(plan.convs, spec):
        w, b = e["wb"]
        k, co = c.k, w.shape[1]
        ci = w.shape[0] // k
        pw = c.w.numpy().reshape(k, -1, c.w.shape[1])
        np.testing.assert_array_equal(pw[:, :ci, :co], w.reshape(k, ci, co))
        assert not pw[:, ci:].any() and not pw[:, :, co:].any() and not c.b[co:].any()
    np.testing.assert_array_equal(plan.fc.numpy()[:fc.shape[0]], fc)
    assert not plan.fc[fc.shape[0]:].any()
    jfn = jinfer.build_fused_infer(to_jax_config(model), to_jax_config(audio), seeded["params"],
                                   seeded["batch_stats"], tb=4, interpret=True)
    wavs = _wavs(3, audio.desired_samples)
    want, got = np.asarray(jax.device_get(jfn(wavs))), plan(torch.tensor(wavs)).numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    sm = lambda a: np.asarray(jax.nn.softmax(a, axis=-1))  # noqa: E731
    np.testing.assert_allclose(sm(got), sm(want), rtol=0, atol=SOFTMAX_ATOL)


@pytest.mark.parametrize("name", ["TCResNet8", "TCResNet14"])
def test_fused_backend_at_width_125_matches_jax(name):
    """backend="fused" at width 1.25 (K4's plain version on the CPU) within
    1e-5 in softmax of JAX's fused backend in interpret mode, as
    tests/test_torch_serve.py::test_backends_match_jax holds width 1.0."""
    from tcresnet_tpu.serve.export import build_inference_fn as jax_build_inference_fn
    from tcresnet_tpu_torch.config import ExperimentConfig
    from tcresnet_tpu_torch.serve.export import build_inference_fn

    model, audio, seeded = _setup(name, wm=1.25)
    cfg = ExperimentConfig(audio=audio, model=model)
    wavs = _wavs(5, audio.desired_samples)
    jfn = jax_build_inference_fn(to_jax_config(cfg), seeded, backend="fused", _interpret=True)
    fn = build_inference_fn(cfg, variables_from_jax(model, **seeded), backend="fused",
                            device="cpu")
    np.testing.assert_allclose(fn(torch.tensor(wavs)).numpy(), np.asarray(jfn(wavs)),
                               rtol=0, atol=SOFTMAX_ATOL)


def test_cpu_tensor_takes_the_plain_version_only():
    """A CPU input runs the plain version and launches nothing; an input
    on another device than the plan, or of another device type, raises."""
    model, audio, seeded = _setup("TCResNet8")
    v = variables_from_jax(model, **seeded)
    plan = k4.build_fused_infer(model, audio, v["params"], v["batch_stats"], device="cpu")
    wavs = torch.tensor(_wavs(2, audio.desired_samples))
    before = k4.launches
    np.testing.assert_array_equal(k4.fused_infer(wavs, plan).numpy(),
                                  k4.fused_infer_reference(wavs, plan).numpy())
    assert k4.launches == before
    with pytest.raises(ValueError):
        k4.fused_infer(wavs.to("meta"), plan)


def test_build_names_the_library_by_source_and_refuses_without_nvcc(monkeypatch, tmp_path):
    path = _build.library_path("infer")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libinfer_")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-DX",))
    assert _build.library_path("infer") != path
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if not (_build.Path("/usr/local/cuda/bin/nvcc")).is_file():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()
