"""Card-only tests of the PyTorch port's CUDA kernels: K4 (csrc/infer.cu),
K1 and K6 (csrc/augment.cu), K2 (csrc/mfcc.cu) and K3 (csrc/frontend.cu).

Each test carries the `cuda` marker and skips without a CUDA card (a CUDA
kernel has no CPU mode; the plain versions are tested against JAX in
tests/test_torch_{infer,augment,mfcc,train}.py). This file imports no JAX,
so it also runs on a machine with the card and without JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

from tcresnet_tpu.config import AudioConfig, AugmentConfig, ExperimentConfig, ModelConfig
from tcresnet_tpu.config import OptimConfig, TrainConfig, get_preset
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset
from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
from tcresnet_tpu_torch.ops import augment as aug
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.ops.kernels import augment as k16
from tcresnet_tpu_torch.ops.kernels import frontend as k3
from tcresnet_tpu_torch.ops.kernels import infer as k4
from tcresnet_tpu_torch.ops.kernels import mfcc as k2
from tcresnet_tpu_torch.serve.export import build_inference_fn
from tcresnet_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.cuda

# the JAX package's kernel tolerances (tests/test_pallas_infer.py,
# tests/test_pallas_frontend.py)
LOGIT_TOL = dict(atol=5e-4, rtol=1e-4)
SOFTMAX_ATOL = 1e-5
FEATURE_ATOL = 1e-4
BF16_TOL = dict(atol=5e-3, rtol=5e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 is a CUDA kernel with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _variables(model_cfg, audio_cfg, device, seed=0):
    v = variables_from_jax(**seeded_variables(model_cfg, dsp.feature_shape(audio_cfg), seed))
    return {k: {n: t.to(device) for n, t in d.items()} for k, d in v.items()}


def _wavs(batch, n, device, seed=11):
    return torch.tensor(
        np.random.default_rng(seed).uniform(-1, 1, (batch, n)).astype(np.float32),
        device=device)


@pytest.mark.parametrize("preset,preprocess", [("TCResNet8-1.0", "mfcc"),
                                               ("TCResNet14-1.5", "mfcc"),
                                               ("TCResNet8-1.0", "log_mel_spectrogram")])
def test_kernel_matches_plain_version(cuda_device, preset, preprocess):
    """Full geometry, odd and even batches: kernel == plain version."""
    cfg = get_preset(preset)
    audio = dataclasses.replace(cfg.audio, preprocess_method=preprocess)
    v = _variables(cfg.model, audio, cuda_device)
    plan = k4.build_fused_infer(cfg.model, audio, v["params"], v["batch_stats"],
                                device=cuda_device)
    for batch in (1, 3, 5, 64):
        wavs = _wavs(batch, audio.desired_samples, cuda_device, seed=batch)
        before = k4.launches
        got = k4.fused_infer(wavs, plan)
        torch.cuda.synchronize()
        assert k4.launches == before + 1
        want = k4.fused_infer_reference(wavs, plan)
        torch.testing.assert_close(got, want, **LOGIT_TOL)
        torch.testing.assert_close(torch.softmax(got, -1), torch.softmax(want, -1),
                                   atol=SOFTMAX_ATOL, rtol=0)


def test_kernel_checks_its_input(cuda_device):
    model = ModelConfig(name="TCResNet8")
    audio = AudioConfig(clip_duration_ms=160, num_mfccs=20, num_mel_bins=32)
    v = _variables(model, audio, cuda_device)
    plan = k4.build_fused_infer(model, audio, v["params"], v["batch_stats"], device=cuda_device)
    wavs = _wavs(4, audio.desired_samples, cuda_device)
    with pytest.raises(TypeError):
        k4.fused_infer(wavs.double(), plan)
    with pytest.raises(ValueError):
        k4.fused_infer(wavs[:, :-160].contiguous(), plan)
    with pytest.raises(ValueError):
        k4.fused_infer(wavs.t().contiguous().t(), plan)
    with pytest.raises(ValueError):
        k4.fused_infer(wavs.cpu(), plan)
    torch.testing.assert_close(k4.fused_infer(wavs, plan),
                               k4.fused_infer_reference(wavs, plan), **LOGIT_TOL)


def test_auto_serves_small_batches_through_the_kernel(cuda_device):
    cfg = ExperimentConfig(
        audio=AudioConfig(clip_duration_ms=160, num_mfccs=20, num_mel_bins=32),
        model=ModelConfig(name="TCResNet8"), train=TrainConfig())
    v = _variables(cfg.model, cfg.audio, cuda_device)
    auto = build_inference_fn(cfg, v, backend="auto", device=cuda_device)
    ref = build_inference_fn(cfg, v, backend="xla", precision="highest", device=cuda_device)
    x = _wavs(40, cfg.audio.desired_samples, cuda_device)
    before = k4.launches
    small, big = auto(x[:1].contiguous()), auto(x)  # 40 > the table's 32: plain path
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    torch.testing.assert_close(small, ref(x[:1].contiguous()), atol=SOFTMAX_ATOL, rtol=0)
    torch.testing.assert_close(big, ref(x), atol=SOFTMAX_ATOL, rtol=0)


def _augment_case(device, n, rows=32, batch=8, seed=0, naive=True):
    gen = torch.Generator(device=device).manual_seed(seed)
    data = torch.randint(-32768, 32768, (rows, n), generator=gen, device=device,
                         dtype=torch.int32).to(torch.int16)
    noise = torch.rand((3, 2 * n), generator=gen, device=device) - 0.5
    idx = torch.randint(0, rows, (batch,), generator=gen, device=device, dtype=torch.int32)
    silent = torch.rand(batch, generator=gen, device=device) < 0.25
    cfg = AugmentConfig(background_frequency=0.8, background_max_volume=0.5,
                        naive_background_mix=naive)
    scalars = aug.draw_scalars(gen, silent, cfg, noise, n, True)
    return data, idx, noise, scalars


@pytest.mark.parametrize("n,batch,naive", [(16000, 8, True), (16000, 37, False), (2003, 5, True)])
@pytest.mark.parametrize("quantize", [False, True])
def test_augment_kernels_bit_exact(cuda_device, n, batch, naive, quantize):
    """K1 and K6 equal their plain version bit for bit."""
    data, idx, noise, scalars = _augment_case(cuda_device, n, batch=batch, naive=naive)
    b1, b6 = k16.k1_launches, k16.k6_launches
    got = k16.fused_gather_augment(data, idx, scalars, noise, n, quantize)
    want = k16.augment_reference(data, idx, scalars, noise, n, quantize)
    decoded = DeviceDataset.decode_rows(data, idx, n)
    got6 = k16.fused_augment(decoded, scalars, noise, quantize)
    torch.cuda.synchronize()
    assert (k16.k1_launches, k16.k6_launches) == (b1 + 1, b6 + 1)
    assert torch.equal(got, want) and torch.equal(got6, want)


@pytest.mark.parametrize("method,matmul", [("mfcc", "float32"), ("log_mel_spectrogram", "float32"),
                                           ("mfcc", "bfloat16")])
def test_mfcc_kernel_matches_plain(cuda_device, method, matmul):
    cfg = dataclasses.replace(AudioConfig(), preprocess_method=method, dsp_matmul_dtype=matmul)
    wavs = _wavs(5, 16000, cuda_device, seed=3)
    before = k2.launches
    got = k2.fused_mfcc(wavs, cfg)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    want = k2.fused_mfcc_reference(wavs, cfg)
    assert got.shape == want.shape == (5, 98, dsp.feature_width(cfg))
    # bf16 operands, f32 sums in another order: the JAX package's bf16 tolerance
    tol = dict(atol=FEATURE_ATOL, rtol=0) if matmul == "float32" else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    feats = dsp.preprocess(wavs, dataclasses.replace(cfg, dsp_backend="pallas"))
    torch.testing.assert_close(feats[..., 0], got, atol=0, rtol=0)


def test_frontend_kernel_equals_k2_of_k1(cuda_device):
    cfg = AudioConfig()
    data, idx, noise, scalars = _augment_case(cuda_device, 16000, batch=6, seed=4)
    before = k3.launches
    got = k3.frontend_features(data, idx, scalars, noise, cfg, 16000)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    two = k2.fused_mfcc(k16.fused_gather_augment(data, idx, scalars, noise, 16000), cfg)
    assert torch.equal(got, two)
    plain = k3.frontend_reference(data, idx, scalars, noise, cfg, 16000)
    torch.testing.assert_close(got, plain, atol=FEATURE_ATOL, rtol=0)


def test_new_kernels_check_their_input(cuda_device):
    data, idx, noise, scalars = _augment_case(cuda_device, 2560)
    with pytest.raises(TypeError):
        k16.fused_gather_augment(data.float(), idx, scalars, noise, 2560)
    with pytest.raises(ValueError):
        k16.fused_gather_augment(data, idx.long(), scalars, noise, 2560)
    with pytest.raises(ValueError):
        k16.fused_gather_augment(data, idx, scalars, noise[:, :100].contiguous(), 2560)
    with pytest.raises(TypeError):
        k2.fused_mfcc(_wavs(2, 16000, cuda_device).double(), AudioConfig())
    with pytest.raises(ValueError):
        k2.fused_mfcc(_wavs(2, 16000, cuda_device),
                      dataclasses.replace(AudioConfig(), window_size_ms=25.0))
    with pytest.raises(ValueError):
        k3.frontend_features(data, idx, scalars._replace(vols=scalars.vols.double()), noise,
                             AudioConfig(clip_duration_ms=160), 2560)


@pytest.mark.parametrize("fuse", ["on", "off"])
def test_trainer_steps_go_through_the_kernels(cuda_device, tmp_path, fuse):
    cfg = ExperimentConfig(
        audio=AudioConfig(clip_duration_ms=160, num_mfccs=20, num_mel_bins=32,
                          dsp_backend="pallas", frontend_fuse=fuse),
        augment=AugmentConfig(backend="pallas"),
        model=ModelConfig(name="TCResNet8", num_classes=4),
        optim=OptimConfig(lr_list=(0.1,), boundaries=()),
        train=TrainConfig(batch_size=32, compute_dtype="bfloat16"))
    ds = DeviceDataset(make_synthetic_dataset(num_samples=64, num_classes=4,
                                              desired_samples=2560, seed=1), cuda_device)
    trainer = Trainer(cfg, ds, workdir=tmp_path)
    counts = (k16.k1_launches, k2.launches, k3.launches)
    summary = trainer.train_steps(3, start=0)
    torch.cuda.synchronize()
    delta = (k16.k1_launches - counts[0], k2.launches - counts[1], k3.launches - counts[2])
    assert delta == ((0, 0, 3) if fuse == "on" else (3, 3, 0))
    assert np.isfinite(float(summary["total_loss"]))
