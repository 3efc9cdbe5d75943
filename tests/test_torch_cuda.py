"""Card-only tests of the PyTorch port's CUDA kernels: K4 (csrc/infer.cu),
K1 and K6 (csrc/augment.cu), K2, K8 and K9 (csrc/mfcc.cu), K3 in its three
DFT variants (csrc/frontend.cu), K7 (csrc/tconv.cu) and K5
(csrc/infer2d.cu), and that the `xla` and `fused` serving paths wait on
the device in no call (sync-debug mode "error").

Each test carries the `cuda` marker and skips without a CUDA card (a CUDA
kernel has no CPU mode; the plain versions are tested against JAX in
tests/test_torch_{infer,augment,mfcc,dft_variants,train,train2d,tconv,infer2d}.py).
This file imports no JAX,
so it also runs on a machine with the card and without JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

from tcresnet_tpu_torch.config import AudioConfig, AugmentConfig, ExperimentConfig, ModelConfig
from tcresnet_tpu_torch.config import OptimConfig, TrainConfig, get_preset
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset
from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
from tcresnet_tpu_torch.ops import augment as aug
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.ops.kernels import augment as k16
from tcresnet_tpu_torch.ops.kernels import frontend as k3
from tcresnet_tpu_torch.ops.kernels import infer as k4
from tcresnet_tpu_torch.ops.kernels import infer2d as k5
from tcresnet_tpu_torch.ops.kernels import mfcc as k2
from tcresnet_tpu_torch.ops.kernels import tconv as k7
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
    v = variables_from_jax(model_cfg, **seeded_variables(model_cfg, dsp.feature_shape(audio_cfg), seed))
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


@pytest.mark.parametrize("preset,preprocess,matmul", [("TCResNet8-1.0", "mfcc", "float32"),
                                                      ("TCResNet14-1.5", "mfcc", "float32"),
                                                      ("TCResNet8-1.0", "log_mel_spectrogram",
                                                       "float32"),
                                                      ("TCResNet8-1.0", "mfcc", "bfloat16")])
def test_k4_on_k2_stage_matches_plain_and_is_batch_invariant(cuda_device, preset, preprocess,
                                                             matmul):
    """K4 on K2's tensor-core stage at batch 1, 3, 64 and 1024 (split
    16-row tiles, 64- and 128-row tiles) against its plain version, at the
    kernel gates (the bf16 DFT at its tolerance, argmax equal); two calls,
    and its two paths (the conv stacks in the stage's blocks, and in a
    kernel of their own), equal bit for bit; an utterance alone equal to
    its row of the batch bit for bit; the counters back at 0 after every
    call."""
    cfg = get_preset(preset)
    audio = dataclasses.replace(cfg.audio, preprocess_method=preprocess, dsp_matmul_dtype=matmul)
    v = _variables(cfg.model, audio, cuda_device)
    plan = k4.build_fused_infer(cfg.model, audio, v["params"], v["batch_stats"],
                                device=cuda_device)
    for batch in (1, 3, 64, 1024):
        wavs = _wavs(batch, audio.desired_samples, cuda_device, seed=batch)
        before = k4.launches
        got, again = k4.fused_infer(wavs, plan), k4.fused_infer(wavs, plan)
        torch.cuda.synchronize()
        assert k4.launches == before + 2
        assert torch.equal(got, again)
        plan.force_two_kernels = not plan.two_kernels(batch)
        other = k4.fused_infer(wavs, plan)
        plan.force_two_kernels = None
        assert torch.equal(got, other)
        assert not plan.count.any() and not plan.done.any()
        want = k4.fused_infer_reference(wavs, plan)
        if matmul == "bfloat16":
            torch.testing.assert_close(got, want, **BF16_TOL)
            assert torch.equal(got.argmax(-1), want.argmax(-1))
        else:
            torch.testing.assert_close(got, want, **LOGIT_TOL)
            torch.testing.assert_close(torch.softmax(got, -1), torch.softmax(want, -1),
                                       atol=SOFTMAX_ATOL, rtol=0)
        for row in sorted({0, batch // 2, batch - 1}):
            assert torch.equal(k4.fused_infer(wavs[row:row + 1].contiguous(), plan),
                               got[row:row + 1])


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
    # a geometry that is not hop-decomposable (400 % 160 != 0) takes the
    # plain feature, as the JAX package does, and launches nothing
    cfg = dataclasses.replace(AudioConfig(), window_size_ms=25.0)
    wavs = _wavs(2, 16000, cuda_device)
    before = (k2.launches, k2.plain_routes)
    got = k2.fused_mfcc(wavs, cfg)
    torch.cuda.synchronize()
    assert (k2.launches, k2.plain_routes) == (before[0], before[1] + 1)
    torch.testing.assert_close(got, dsp.mfcc(wavs, cfg), atol=1e-5, rtol=0)
    # a radix4 clip past K9's frames (254) runs K2's stage, not the plain
    # feature
    cfg = dataclasses.replace(AudioConfig(), dft_variant="radix4", clip_duration_ms=2560)
    wavs = _wavs(2, 40960, cuda_device)
    before = (k2.launches, k2.radix4_launches, k2.plain_routes)
    got = k2.fused_mfcc(wavs, cfg)
    torch.cuda.synchronize()
    assert (k2.launches, k2.radix4_launches, k2.plain_routes) == (before[0] + 1, *before[1:])
    torch.testing.assert_close(got, k2.fused_mfcc_reference(wavs, cfg, "radix4"),
                               atol=FEATURE_ATOL, rtol=0)
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


GEOMETRIES = {"30/10": AudioConfig(),
              "40/20": AudioConfig(window_size_ms=40.0, window_stride_ms=20.0, num_mfccs=10)}


@pytest.mark.parametrize("variant", ["phases", "radix4"])
@pytest.mark.parametrize("geometry,method,matmul", [
    ("30/10", "mfcc", "float32"), ("30/10", "log_mel_spectrogram", "float32"),
    ("40/20", "mfcc", "float32"), ("40/20", "mfcc", "bfloat16")])
def test_k8_k9_match_plain(cuda_device, variant, geometry, method, matmul):
    """K8 (phases) and K9 (radix4) at 1 s against their plain versions."""
    cfg = dataclasses.replace(GEOMETRIES[geometry], preprocess_method=method,
                              dsp_matmul_dtype=matmul, dft_variant=variant)
    wavs = _wavs(7, 16000, cuda_device, seed=5)
    counter = f"{variant}_launches"
    before = getattr(k2, counter), k2.launches
    got = k2.fused_mfcc(wavs, cfg)
    torch.cuda.synchronize()
    assert (getattr(k2, counter), k2.launches) == (before[0] + 1, before[1])
    want = k2.fused_mfcc_reference(wavs, cfg, variant)
    assert got.shape == want.shape == (7,) + dsp.feature_shape(cfg)[:2]
    tol = dict(atol=FEATURE_ATOL, rtol=0) if matmul == "float32" else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    feats = dsp.preprocess(wavs, dataclasses.replace(cfg, dsp_backend="pallas"))
    torch.testing.assert_close(feats[..., 0], got, atol=0, rtol=0)


@pytest.mark.parametrize("geometry", ["30/10", "40/20", "25/12.5"])
def test_k2_batch_one_equals_its_row_of_a_batch(cuda_device, geometry):
    """K2 of one clip equals that clip's row of a batch of 1536 bit for
    bit, at 400/200 too (staged chunks of 224 samples, the constant's rows
    past each hop zero): a row's sum does not depend on the tile it lands in;
    two calls give the same bits; where K8 serves the geometry, K2 equals
    it (one stage)."""
    cfg = (dataclasses.replace(AudioConfig(), window_size_ms=25.0, window_stride_ms=12.5)
           if geometry == "25/12.5" else GEOMETRIES[geometry])
    wavs = _wavs(1536, 16000, cuda_device, seed=8)
    before = k2.launches
    got = k2.fused_mfcc(wavs, cfg)
    assert k2.launches == before + 1
    assert torch.equal(got, k2.fused_mfcc(wavs, cfg))
    for i in (0, 1, 97, 777, 1535):
        assert torch.equal(k2.fused_mfcc(wavs[i:i + 1], cfg), got[i:i + 1])
    if geometry != "25/12.5":
        assert torch.equal(got, k2.fused_mfcc(wavs, dataclasses.replace(cfg, dft_variant="phases")))
    torch.testing.assert_close(got, k2.fused_mfcc_reference(wavs, cfg), atol=FEATURE_ATOL, rtol=0)


def test_k2_long_window_takes_tiles_of_fewer_rows(cuda_device):
    """A 256 ms window at a 256 ms hop over 1.024 s: a 16-row tile's span
    does not fit a block, so K2 takes 8-row tiles (on the 16-row product,
    its rows past the tile clamped); within FEATURE_ATOL of the plain
    version at batch 1 and 8, batch 1 equal to its row of batch 8."""
    cfg = AudioConfig(window_size_ms=256.0, window_stride_ms=256.0, clip_duration_ms=1024,
                      num_mfccs=10)
    n = cfg.desired_samples
    g = k2.front_end_geometry(cfg, n)
    nnz = k2.tc_mel_constants(*dsp.mel_args(cfg))[1].size
    assert k2.fused_mfcc_available(cfg, n) and k2.tc_tile_plan(1, g, nnz).rows == 8
    wavs = _wavs(8, n, cuda_device, seed=9)
    got = k2.fused_mfcc(wavs, cfg)
    torch.testing.assert_close(got, k2.fused_mfcc_reference(wavs, cfg), atol=FEATURE_ATOL,
                               rtol=0)
    assert torch.equal(k2.fused_mfcc(wavs[3:4], cfg), got[3:4])


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_k8_batch_one_equals_its_row_of_a_batch(cuda_device, geometry):
    """K8 of one clip equals that clip's row of a batch of 1536 bit for
    bit: a row's sum does not depend on the tile it lands in (16-row tiles
    at batch 1, 128 or 64 rows at 1536, any row of a tile); two calls give
    the same bits."""
    cfg = dataclasses.replace(GEOMETRIES[geometry], dft_variant="phases")
    wavs = _wavs(1536, 16000, cuda_device, seed=6)
    got = k2.fused_mfcc(wavs, cfg)
    assert torch.equal(got, k2.fused_mfcc(wavs, cfg))
    for i in (0, 1, 97, 777, 1535):
        assert torch.equal(k2.fused_mfcc(wavs[i:i + 1], cfg), got[i:i + 1])


@pytest.mark.parametrize("variant", ["phases", "radix4"])
def test_k3_variants_equal_their_mfcc_of_k1(cuda_device, variant):
    """K3's phases and radix4 entry points equal K8(K1(x)) / K9(K1(x)) bit
    for bit, and their plain version within the feature tolerance."""
    cfg = dataclasses.replace(GEOMETRIES["40/20"], dft_variant=variant)
    data, idx, noise, scalars = _augment_case(cuda_device, 16000, batch=6, seed=4)
    before = getattr(k3, f"{variant}_launches")
    got = k3.frontend_features(data, idx, scalars, noise, cfg, 16000)
    torch.cuda.synchronize()
    assert getattr(k3, f"{variant}_launches") == before + 1
    two = k2.fused_mfcc(k16.fused_gather_augment(data, idx, scalars, noise, 16000), cfg)
    assert torch.equal(got, two)
    plain = k3.frontend_reference(data, idx, scalars, noise, cfg, 16000)
    torch.testing.assert_close(got, plain, atol=FEATURE_ATOL, rtol=0)


@pytest.mark.parametrize("variant", ["phases", "radix4"])
def test_trainer_steps_go_through_the_variant_kernels(cuda_device, tmp_path, variant):
    """DSCNNS with adam: frontend_fuse "on" launches K3 in the variant once
    per step, "off" K1 and K8 / K9."""
    for fuse in ("on", "off"):
        cfg = ExperimentConfig(
            audio=AudioConfig(clip_duration_ms=160, window_size_ms=40.0, window_stride_ms=20.0,
                              num_mfccs=10, dsp_backend="pallas", frontend_fuse=fuse,
                              dft_variant=variant),
            augment=AugmentConfig(backend="pallas"),
            model=ModelConfig(name="DSCNNS", num_classes=4, weight_decay=0.0),
            optim=OptimConfig(optimizer="adam", lr_list=(5e-4,), boundaries=()),
            train=TrainConfig(batch_size=32))
        ds = DeviceDataset(make_synthetic_dataset(num_samples=64, num_classes=4,
                                                  desired_samples=2560, seed=1), cuda_device)
        trainer = Trainer(cfg, ds, workdir=tmp_path / fuse)
        counter = f"{variant}_launches"
        counts = (k16.k1_launches, getattr(k2, counter), getattr(k3, counter))
        summary = trainer.train_steps(3, start=0)
        torch.cuda.synchronize()
        delta = (k16.k1_launches - counts[0], getattr(k2, counter) - counts[1],
                 getattr(k3, counter) - counts[2])
        assert delta == ((0, 0, 3) if fuse == "on" else (3, 3, 0))
        assert np.isfinite(float(summary["total_loss"]))


# (k, stride, Ci, Co, T) of every TCResNet8-1.0 conv, then two of TCResNet14-1.5,
# then an even tap count at stride 3 over 36 channels (not a multiple of 8)
K7_GEOMETRIES = [(3, 1, 40, 16, 98), (1, 2, 16, 24, 98), (9, 2, 16, 24, 98), (9, 1, 24, 24, 49),
                 (1, 2, 24, 32, 49), (9, 2, 24, 32, 49), (9, 1, 32, 32, 25), (1, 2, 32, 48, 25),
                 (9, 2, 32, 48, 25), (9, 1, 48, 48, 13), (9, 2, 36, 48, 25), (9, 1, 72, 72, 13),
                 (4, 3, 36, 36, 98)]


@pytest.mark.parametrize("k,stride,ci,co,t", K7_GEOMETRIES)
def test_tconv_kernels_match_plain(cuda_device, k, stride, ci, co, t):
    """K7 fwd, dx and dw against the plain versions at batch 1, 8 and 1536:
    fwd and dx within the CPU test's tolerances (f32 sums in another
    order); dw, up to 150,528 products per entry summed in another order,
    within 1e-5 of max|dw|; fwd, dx and dw give the same bits twice."""
    gen = torch.Generator(device=cuda_device).manual_seed(k * 100 + ci)
    to = -(-t // stride)
    for b in (1, 8, 1536):
        x = torch.randn(b, ci, t, device=cuda_device, generator=gen)
        w = torch.randn(co, ci, k, device=cuda_device, generator=gen) * 0.1
        dy = torch.randn(b, co, to, device=cuda_device, generator=gen)
        before = (k7.fwd_launches, k7.dx_launches, k7.dw_launches)
        y, y2 = k7.tconv_fwd(x, w, stride), k7.tconv_fwd(x, w, stride)
        dx, dx2 = k7.tconv_dx(dy, w, t, stride), k7.tconv_dx(dy, w, t, stride)
        dw, dw2 = k7.tconv_dw(x, dy, k, stride), k7.tconv_dw(x, dy, k, stride)
        torch.cuda.synchronize()
        assert (k7.fwd_launches, k7.dx_launches, k7.dw_launches) == (
            before[0] + 2, before[1] + 2, before[2] + 2)
        torch.testing.assert_close(y, k7.tconv_fwd_reference(x, w, stride), atol=1e-5, rtol=1e-5)
        assert torch.equal(y, y2)
        torch.testing.assert_close(dx, k7.tconv_dx_reference(dy, w, t, stride),
                                   atol=2e-4, rtol=1e-4)
        assert torch.equal(dx, dx2)
        want = k7.tconv_dw_reference(x, dy, k, stride)
        assert (dw - want).abs().max().item() <= 1e-5 * want.abs().max().item()
        assert torch.equal(dw, dw2)


def test_tconv_kernels_check_their_input(cuda_device):
    x, w = torch.randn(2, 4, 10, device=cuda_device), torch.randn(5, 4, 3, device=cuda_device)
    with pytest.raises(TypeError):
        k7.tconv_fwd(x.double(), w.double())
    with pytest.raises(ValueError):
        k7.tconv_fwd(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError):
        k7.tconv_fwd(x, w.cpu())
    empty = k7.tconv_fwd(x[:0], w)
    assert empty.shape == (0, 5, 10)


def test_trainer_convs_go_through_k7(cuda_device, tmp_path):
    """A bf16 step of TCResNet8 with conv_backend="pallas": 10 fwd, 10 dw
    and 9 dx launches (the features need no dx)."""
    cfg = ExperimentConfig(
        audio=AudioConfig(clip_duration_ms=160, num_mfccs=20, num_mel_bins=32),
        model=ModelConfig(name="TCResNet8", num_classes=4, conv_backend="pallas"),
        optim=OptimConfig(lr_list=(0.1,), boundaries=()),
        train=TrainConfig(batch_size=32, compute_dtype="bfloat16"))
    ds = DeviceDataset(make_synthetic_dataset(num_samples=64, num_classes=4,
                                              desired_samples=2560, seed=1), cuda_device)
    trainer = Trainer(cfg, ds, workdir=tmp_path)
    before = (k7.fwd_launches, k7.dx_launches, k7.dw_launches)
    summary = trainer.train_steps(2, start=0)
    torch.cuda.synchronize()
    assert (k7.fwd_launches - before[0], k7.dx_launches - before[1],
            k7.dw_launches - before[2]) == (20, 18, 20)
    assert np.isfinite(float(summary["total_loss"]))


# ---------------------------------------------------------------------------
# K5: the 2D families' op-list kernel
# ---------------------------------------------------------------------------

K5_CASES = [("TCResNet2D8Pool-1.0", None), ("Res8Narrow", None), ("Res15Narrow", None),
            ("DSCNNM", None), ("KWSfpool3", "conv"), ("KWSfpool3", "trad_fpool3"),
            ("KWSfpool3", "low_latency_svdf"), ("KWSfpool3", "one_fstride4")]


def _k5_plan(preset, arch, device, seed=0):
    cfg = get_preset(preset)
    if arch is not None:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, kws_architecture=arch))
    v = _variables(cfg.model, cfg.audio, device, seed)
    return cfg, k5.build_fused_infer2d(cfg.model, cfg.audio, v["params"], v["batch_stats"],
                                       device=device)


@pytest.mark.parametrize("preset,arch", K5_CASES, ids=[a or p for p, a in K5_CASES])
def test_k5_matches_plain_version(cuda_device, preset, arch):
    """Full preset geometry, odd and even batches: K5 == its plain version,
    one launch per call, and two calls give the same bits."""
    cfg, plan = _k5_plan(preset, arch, cuda_device)
    for batch in (1, 5, 32):
        feats = k2.fused_mfcc(_wavs(batch, cfg.audio.desired_samples, cuda_device, seed=batch),
                              cfg.audio)
        before = k5.launches
        got, again = k5.fused_infer2d(feats, plan), k5.fused_infer2d(feats, plan)
        torch.cuda.synchronize()
        assert k5.launches == before + 2
        assert torch.equal(got, again)
        want = k5.fused_infer2d_reference(feats, plan)
        torch.testing.assert_close(got, want, **LOGIT_TOL)
        torch.testing.assert_close(torch.softmax(got, -1), torch.softmax(want, -1),
                                   atol=SOFTMAX_ATOL, rtol=0)


# the presets chip_smoke.py times (phase 20)
K5_TIMED = ["TCResNet2D8-1.0", "Res15", "DSCNNL", "KWSfpool3"]


@pytest.mark.parametrize("preset", K5_TIMED)
def test_k5_matches_plain_version_at_batch_1024(cuda_device, preset):
    """The timed presets at batch 1 (the most K parts) and 1024 (the
    widest grid of tiles): K5 == its plain version, and two calls give the
    same bits."""
    cfg, plan = _k5_plan(preset, None, cuda_device)
    for batch in (1, 1024):
        feats = k2.fused_mfcc(_wavs(batch, cfg.audio.desired_samples, cuda_device, seed=7),
                              cfg.audio)
        before = k5.launches
        got, again = k5.fused_infer2d(feats, plan), k5.fused_infer2d(feats, plan)
        torch.cuda.synchronize()
        assert k5.launches == before + 2
        assert torch.equal(got, again)
        want = k5.fused_infer2d_reference(feats, plan)
        torch.testing.assert_close(got, want, **LOGIT_TOL)
        torch.testing.assert_close(torch.softmax(got, -1), torch.softmax(want, -1),
                                   atol=SOFTMAX_ATOL, rtol=0)


@pytest.mark.parametrize("preset", K5_TIMED)
def test_xla_serving_path_does_not_synchronise(cuda_device, preset):
    """backend="xla" (dsp.preprocess + the model on cuDNN) at batch 1 and
    1024 under torch.cuda.set_sync_debug_mode("error"): no call waits for
    the device, so its device time can be taken behind a device-side sleep
    (chip_smoke.py, phase 20). The first calls run before the mode is on."""
    cfg = get_preset(preset)
    v = _variables(cfg.model, cfg.audio, cuda_device)
    xla = build_inference_fn(cfg, v, backend="xla", precision="highest", device=cuda_device)
    batches = [_wavs(b, cfg.audio.desired_samples, cuda_device, seed=b) for b in (1, 1024)]
    warm = [xla(x) for x in batches]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):  # the mode is on: .item() waits
            torch.ones(1, device=cuda_device).item()
        again = [xla(x) for x in batches]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(warm, again):
        torch.testing.assert_close(a, b, atol=SOFTMAX_ATOL, rtol=0)


@pytest.mark.parametrize("preset", K5_TIMED)
def test_fused_serving_path_does_not_synchronise(cuda_device, preset):
    """backend="fused" (K2 + K5) under sync-debug mode "error", at batch
    sizes the plan has not seen: making a batch's op table and copying it to
    the card waits for the device in no call. The front end's constants are
    made by a first call before the mode is on."""
    cfg = get_preset(preset)
    v = _variables(cfg.model, cfg.audio, cuda_device)
    fused = build_inference_fn(cfg, v, backend="fused", device=cuda_device)
    fused(_wavs(2, cfg.audio.desired_samples, cuda_device))
    batches = [_wavs(b, cfg.audio.desired_samples, cuda_device, seed=b) for b in (1, 7, 1024)]
    torch.cuda.synchronize()
    before = k5.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [fused(x) for x in batches]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert k5.launches == before + 3
    ref = build_inference_fn(cfg, v, backend="xla", precision="highest", device=cuda_device)
    for x, y in zip(batches, got):
        torch.testing.assert_close(y, ref(x), atol=SOFTMAX_ATOL, rtol=0)


def test_k5_meets_the_jax_golden(cuda_device):
    """K2 + K5 softmax within 1e-5 of tcresnet_tpu_torch/testdata/infer2d_golden.npz."""
    from pathlib import Path

    golden = np.load(Path(__file__).resolve().parent.parent
                     / "tcresnet_tpu_torch/testdata/infer2d_golden.npz")
    for i, preset in enumerate(str(p) for p in golden["presets"]):
        cfg, plan = _k5_plan(preset, None, cuda_device, int(golden["param_seed"]))
        wavs = _wavs(int(golden["batch"]), cfg.audio.desired_samples, cuda_device,
                     seed=int(golden["wav_seed"]))
        got = torch.softmax(plan(wavs), -1).cpu().numpy()
        np.testing.assert_allclose(got, golden["softmax"][i], rtol=0, atol=SOFTMAX_ATOL)


def test_k5_fused_backend_launches_k2_then_k5(cuda_device):
    """backend="fused" for a 2D preset on the card: one K2 and one K5
    launch per request, nothing on the plain path; "auto" the same up to
    the family's batch and the plain path above it."""
    cfg = get_preset("DSCNNS")
    v = _variables(cfg.model, cfg.audio, cuda_device)
    fused = build_inference_fn(cfg, v, backend="fused", device=cuda_device)
    auto = build_inference_fn(cfg, v, backend="auto", device=cuda_device)
    ref = build_inference_fn(cfg, v, backend="xla", precision="highest", device=cuda_device)
    x = _wavs(9, cfg.audio.desired_samples, cuda_device)
    before = (k2.launches, k5.launches)
    one = fused(x)
    small, big = auto(x[:8].contiguous()), auto(x)  # 9 > DS-CNN's 8: plain path
    torch.cuda.synchronize()
    assert (k2.launches, k5.launches) == (before[0] + 2, before[1] + 2)
    torch.testing.assert_close(one, ref(x), atol=SOFTMAX_ATOL, rtol=0)
    torch.testing.assert_close(small, ref(x[:8].contiguous()), atol=SOFTMAX_ATOL, rtol=0)
    torch.testing.assert_close(big, ref(x), atol=SOFTMAX_ATOL, rtol=0)


def test_k5_checks_its_input(cuda_device):
    cfg, plan = _k5_plan("DSCNNS", None, cuda_device)
    feats = k2.fused_mfcc(_wavs(4, cfg.audio.desired_samples, cuda_device), cfg.audio)
    with pytest.raises(TypeError):
        k5.fused_infer2d(feats.double(), plan)
    with pytest.raises(ValueError):
        k5.fused_infer2d(feats[:, :-1].contiguous(), plan)
    with pytest.raises(ValueError):
        k5.fused_infer2d(feats.transpose(0, 1).contiguous().transpose(0, 1), plan)
    with pytest.raises(ValueError):
        k5.fused_infer2d(feats.cpu(), plan)
    assert k5.fused_infer2d(feats[:0], plan).shape == (0, cfg.model.num_classes)
    assert k5.grid_blocks(cuda_device) >= torch.cuda.get_device_properties(
        cuda_device).multi_processor_count


@pytest.mark.parametrize("name", ["TCResNet8", "TCResNet14"])
def test_k4_at_width_125_matches_plain(cuda_device, name):
    """Widths 20/30/40/60 (padded to 4 on the host) through K4 against its
    plain version, two calls bit-equal."""
    cfg = get_preset(f"{name}-1.0")
    model = dataclasses.replace(cfg.model, width_multiplier=1.25)
    v = _variables(model, cfg.audio, cuda_device)
    plan = k4.build_fused_infer(model, cfg.audio, v["params"], v["batch_stats"],
                                device=cuda_device)
    for batch in (1, 8):
        wavs = torch.tensor(np.random.default_rng(batch).uniform(
            -1, 1, (batch, cfg.audio.desired_samples)).astype(np.float32), device=cuda_device)
        got = k4.fused_infer(wavs, plan)
        assert torch.equal(got, k4.fused_infer(wavs, plan))
        want = k4.fused_infer_reference(wavs, plan)
        torch.testing.assert_close(got, want, **LOGIT_TOL)
        assert (torch.softmax(got, -1) - torch.softmax(want, -1)).abs().max() <= SOFTMAX_ATOL


def test_compile_inference_graph_and_moved_artifact(cuda_device):
    """The CUDA graph of the xla path equals the uncaptured call, also
    after the memory the process freed since the capture is filled with
    NaN (the graph reads the weights in place: they must stay alive), and
    refuses another batch; an artifact traced on the CPU, loaded onto the
    card, meets the card's xla path (TF32 off)."""
    import gc

    from tcresnet_tpu_torch.serve.export import (
        compile_inference, export_serialized, load_serialized)

    cfg = get_preset("TCResNet8-1.0")
    v = _variables(cfg.model, cfg.audio, cuda_device)
    compiled, shape = compile_inference(cfg, v, 4, device=cuda_device)
    gc.collect()
    junk = [torch.full((1 << 18,), float("nan"), device=cuda_device) for _ in range(64)]
    eager = build_inference_fn(cfg, v, device=cuda_device)
    x = torch.tensor(np.random.default_rng(4).uniform(-1, 1, shape).astype(np.float32),
                     device=cuda_device)
    assert (compiled(x) - eager(x)).abs().max() <= SOFTMAX_ATOL
    del junk
    with pytest.raises(ValueError, match="compiled for input"):
        compiled(x[:2])
    data = export_serialized(cfg, _variables(cfg.model, cfg.audio, "cpu"), 4, device="cpu")
    moved = load_serialized(data, device=cuda_device)(x)
    assert moved.device == x.device and (moved - eager(x)).abs().max() <= SOFTMAX_ATOL


def test_streaming_on_the_card_matches_the_batch_model(cuda_device):
    from tcresnet_tpu_torch.models import build_model
    from tcresnet_tpu_torch.serve import streaming

    cfg = ModelConfig(name="KWS", kws_architecture="low_latency_svdf", num_classes=12)
    shape = (49, 40, 1)
    v = variables_from_jax(cfg, **seeded_variables(cfg, shape, 0))
    params = {n: t.to(cuda_device) for n, t in v["params"].items()}
    model = build_model(cfg, shape, device=cuda_device)
    model.load_state_dict({**v["params"], **v["batch_stats"]})
    frames = torch.tensor(np.random.default_rng(0).normal(size=shape[:2]).astype(np.float32),
                          device=cuda_device)
    with torch.no_grad():
        want = torch.softmax(model(frames[None, :, :, None])[0], -1)
    mem = streaming.init_state(49, device=cuda_device)
    for i in range(0, 49, 7):
        probs, mem = streaming.streaming_step(params, mem, frames[i:i + 7])
    assert (probs - want).abs().max() <= 1e-4


# ---- the 128-row product (csrc/dft_wgmma.cuh) ----


def _loud_rows(device, n, batch, seed=958):
    """Synthetic dataset rows (loud tones: MFCCs up to ~160) augmented by K1."""
    ds = DeviceDataset(make_synthetic_dataset(num_samples=48, num_classes=12, desired_samples=n,
                                              seed=0), device)
    gen = torch.Generator(device=device).manual_seed(seed)
    idx, _, silent = DeviceDataset.sample_indices(ds.arrays, gen, batch)
    scalars = aug.draw_scalars(gen, silent, get_preset("TCResNet8-1.0").augment, ds.noise_bank,
                               n, True)
    return k16.fused_gather_augment(ds.wavs, idx, scalars, ds.noise_bank, n)


def _mfcc_float64(wavs, cfg):
    """MFCC of float32 wavs in float64 from the port's float32 constants:
    frames @ windowed DFT -> power -> mel -> log -> DCT."""
    win, hop = cfg.window_size_samples, cfg.window_stride_samples
    fft = dsp.fft_length_for(win)
    bins = fft // 2 + 1

    def const(a):
        return torch.tensor(np.asarray(a, np.float64), device=wavs.device)

    reim = wavs.double().unfold(1, win, hop) @ const(dsp.windowed_rdft_matrix(win, fft))
    power = reim[..., :bins] ** 2 + reim[..., bins:] ** 2
    mel = const(dsp.linear_to_mel_weight_matrix(*dsp.mel_args(cfg)))
    return torch.log(power @ mel + 1e-6) @ const(dsp.dct_ii_matrix(cfg.num_mel_bins,
                                                                    cfg.num_mfccs))


WG_GEOMETRIES = {"30/10": AudioConfig(),
                 "20/10": AudioConfig(window_size_ms=20.0, window_stride_ms=10.0)}


@pytest.mark.parametrize("method", ["mfcc", "log_mel_spectrogram"])
@pytest.mark.parametrize("geometry", sorted(WG_GEOMETRIES))
def test_wgmma_product_meets_plain_and_float64(cuda_device, geometry, method):
    """K2 at batch 1536 takes the 128-row product (counted in
    `wgmma_launches`): within FEATURE_ATOL of the plain version on seeded
    wavs, and on loud dataset rows within FEATURE_ATOL of a float64 MFCC
    (3xTF32 exact to float32, not TF32 alone)."""
    cfg = dataclasses.replace(WG_GEOMETRIES[geometry], preprocess_method=method)
    g = k2.front_end_geometry(cfg, 16000)
    assert k2.tc_tile_plan(1536, g, k2.front_end(cfg, 16000, cuda_device).nnz).rows == 128
    wavs = _wavs(1536, 16000, cuda_device, seed=21)
    before = k2.wgmma_launches
    got = k2.fused_mfcc(wavs, cfg)
    torch.cuda.synchronize()
    assert k2.wgmma_launches == before + 1
    torch.testing.assert_close(got, k2.fused_mfcc_reference(wavs, cfg), atol=FEATURE_ATOL,
                               rtol=0)
    if method == "mfcc":
        loud = _loud_rows(cuda_device, 16000, 1536)
        got = k2.fused_mfcc(loud, cfg)
        want = _mfcc_float64(loud, cfg)
        assert want.abs().max() > 100
        torch.testing.assert_close(got.double(), want, atol=FEATURE_ATOL, rtol=0)


@pytest.mark.parametrize("batch", [1536, 8192])
def test_wgmma_k3_equals_k2_of_k1_and_k2_equals_k8(cuda_device, batch):
    """On the 128-row product K3 equals K2(K1(x)) bit for bit, in the hops
    and phases variants, and K2 equals K8; each launch is counted once in
    `wgmma_launches`; K3 within FEATURE_ATOL of its plain version."""
    cfg = AudioConfig()
    data, idx, noise, scalars = _augment_case(cuda_device, 16000, batch=batch, seed=23)
    before = k2.wgmma_launches
    got = k3.frontend_features(data, idx, scalars, noise, cfg, 16000)
    wavs = k16.fused_gather_augment(data, idx, scalars, noise, 16000)
    two = k2.fused_mfcc(wavs, cfg)
    phases = dataclasses.replace(cfg, dft_variant="phases")
    k8 = k2.fused_mfcc(wavs, phases)
    k3_phases = k3.frontend_features(data, idx, scalars, noise, phases, 16000)
    torch.cuda.synchronize()
    assert k2.wgmma_launches == before + 4
    assert torch.equal(got, two) and torch.equal(two, k8) and torch.equal(k3_phases, got)
    plain = k3.frontend_reference(data, idx, scalars, noise, cfg, 16000)
    torch.testing.assert_close(got, plain, atol=FEATURE_ATOL, rtol=0)


def test_wgmma_one_clip_equals_its_row(cuda_device):
    """A clip alone (a 16-row tile on the mma.sync product) equals its row
    of a batch of 8191 (128-row tiles on wgmma) bit for bit, the last,
    ragged tile's rows too: wgmma's in-product sums are mma.sync's."""
    cfg = AudioConfig()
    wavs = _wavs(8191, 16000, cuda_device, seed=24)
    got = k2.fused_mfcc(wavs, cfg)
    assert 8191 * 98 % 128 != 0
    for i in (0, 1, 97, 4095, 8189, 8190):
        assert torch.equal(k2.fused_mfcc(wavs[i:i + 1], cfg), got[i:i + 1])


def test_wgmma_k4_counts_its_128_row_launches(cuda_device):
    """K4's front end takes the 128-row product at batch 1024 and not at 64
    (`wgmma_launches`), and its logits there equal each utterance's alone."""
    cfg = get_preset("TCResNet8-1.0")
    v = _variables(cfg.model, cfg.audio, cuda_device)
    plan = k4.build_fused_infer(cfg.model, cfg.audio, v["params"], v["batch_stats"],
                                device=cuda_device)
    for batch, counted in ((64, 0), (1024, 1)):
        wavs = _wavs(batch, 16000, cuda_device, seed=25)
        before = k2.wgmma_launches
        got = k4.fused_infer(wavs, plan)
        torch.cuda.synchronize()
        assert k2.wgmma_launches == before + counted
        assert torch.equal(k4.fused_infer(wavs[-1:].contiguous(), plan), got[-1:])
