"""The fused front-end kernels' plain versions (K2: MFCC / log-mel; K3:
gather + augment + MFCC) against the JAX kernels in interpret mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu_torch.config import AudioConfig, AugmentConfig
from tcresnet_tpu.ops import dsp as jdsp
from tcresnet_tpu.ops.pallas import frontend as jfrontend
from tcresnet_tpu.ops.pallas.augment import _draw_scalars
from tcresnet_tpu.ops.pallas.mfcc import fused_mfcc as jax_fused_mfcc
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.ops.kernels import frontend, mfcc
from tcresnet_tpu_torch.ops.kernels.augment import AugmentScalars
from tests.test_torch_config import to_jax_config

torch.set_num_threads(1)

N, P = 3200, 4096  # a multiple of 128 and of 160; the JAX dataset pads rows to P
CFG = AudioConfig(clip_duration_ms=200, num_mel_bins=32, num_mfccs=20)
ATOL = 1e-4  # the JAX package's kernel tolerance (tests/test_pallas_frontend.py)


@pytest.mark.parametrize("method", ["mfcc", "log_mel_spectrogram"])
def test_k2_plain_matches_jax_kernel_and_xla(method):
    cfg = dataclasses.replace(CFG, preprocess_method=method)
    wavs = np.random.default_rng(1).uniform(-1, 1, (4, N)).astype(np.float32)
    got = mfcc.fused_mfcc(torch.tensor(wavs), cfg).numpy()
    kernel = np.asarray(jax_fused_mfcc(jnp.asarray(wavs), to_jax_config(cfg), interpret=True))
    xla = np.asarray(jdsp.preprocess(jnp.asarray(wavs), to_jax_config(cfg)))[..., 0]
    assert got.shape == kernel.shape == (4, 18, dsp.feature_width(cfg))
    np.testing.assert_allclose(got, kernel, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, xla, rtol=0, atol=ATOL)
    # dsp_backend="pallas" routes a CPU batch to the same plain version
    feats = dsp.preprocess(torch.tensor(wavs), dataclasses.replace(cfg, dsp_backend="pallas"))
    np.testing.assert_array_equal(feats[..., 0].numpy(), got)


@pytest.mark.parametrize("method,quantize", [("mfcc", False), ("log_mel_spectrogram", True)])
def test_k3_plain_matches_jax_kernel(method, quantize):
    """Same scalars (JAX's draw) into JAX's single-kernel front end and the
    port's plain K3 (K1's then K2's plain versions)."""
    rng = np.random.default_rng(2)
    rows, batch = 20, 8
    data = np.zeros((rows, P), np.int16)
    data[:, :N] = rng.integers(-32768, 32768, (rows, N))
    idx = rng.integers(0, rows, batch).astype(np.int32)
    silent = rng.integers(0, 4, batch) == 0
    noise = (rng.normal(size=(3, 3 * N)) * 0.1).astype(np.float32)
    aug_cfg = AugmentConfig(background_frequency=0.8, background_max_volume=0.3)
    cfg = dataclasses.replace(CFG, preprocess_method=method)
    scalars = _draw_scalars(jax.random.key(3), jnp.asarray(silent), to_jax_config(aug_cfg),
                            jnp.asarray(noise), N, True)
    want = np.asarray(jfrontend._impl(
        jnp.asarray(data.reshape(rows, P // 128, 128)), jnp.asarray(idx), scalars,
        jnp.asarray(noise), N, to_jax_config(cfg), True, quantize, "hops", 8))
    shifts, clips, offs, vols, keeps = (np.asarray(a) for a in scalars)
    ts = AugmentScalars(*(torch.tensor(a, dtype=torch.int32) for a in (shifts, clips, offs)),
                        torch.tensor(vols, dtype=torch.float32),
                        torch.tensor(keeps, dtype=torch.float32))
    dataset = torch.tensor(data[:, :N].copy())
    got = frontend.frontend_features(dataset, torch.tensor(idx), ts, torch.tensor(noise),
                                     cfg, N, quantize).numpy()
    assert got.shape == want.shape == (batch, 18, dsp.feature_width(cfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_kernel_gates_and_variants():
    dataset = torch.zeros(4, N, dtype=torch.int16)
    noise = torch.zeros(2, 2 * N)
    aug_cfg = AugmentConfig()
    assert mfcc.fused_mfcc_available(CFG, N)
    assert frontend.frontend_fusable(dataset, aug_cfg, CFG, noise, N)
    log_mel = dataclasses.replace(CFG, preprocess_method="log_mel_spectrogram")
    assert frontend.frontend_fusable(dataset, aug_cfg, log_mel, noise, N)
    raw = dataclasses.replace(CFG, preprocess_method="no_preprocessing")
    assert not frontend.frontend_fusable(dataset, aug_cfg, raw, noise, N)
    # 25 ms window: 400 % 160 != 0, not hop-decomposable
    assert not mfcc.fused_mfcc_available(dataclasses.replace(CFG, window_size_ms=25.0), N)
    assert not frontend.frontend_fusable(dataset, aug_cfg, CFG, noise[:, :N - 1], N)
    assert not frontend.frontend_fusable(
        dataset, AugmentConfig(method="no_augmentation_audio"), CFG, noise, N)
    # the flagship geometry fits one Hopper block
    assert mfcc.fused_mfcc_available(AudioConfig(), 16000)
    a, b = mfcc.front_end_geometry(AudioConfig(), 16000).regions()
    assert 4 * (a + b) <= mfcc.SMEM_LIMIT
    wavs = torch.tensor(np.random.default_rng(4).uniform(-1, 1, (2, N)).astype(np.float32))
    # the phase-grouped (K8) and radix-4 (K9) variants run their plain
    # versions on the CPU and match the JAX kernels in interpret mode
    for variant in ("phases", "radix4"):
        vcfg = dataclasses.replace(CFG, dft_variant=variant)
        assert mfcc.resolve_dft_variant(vcfg, N) == variant
        want = jax_fused_mfcc(jnp.asarray(wavs.numpy()), to_jax_config(vcfg), interpret=True,
                              variant=variant)
        np.testing.assert_allclose(mfcc.fused_mfcc(wavs, vcfg).numpy(), np.asarray(want),
                                   rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="dft_variant"):
        mfcc.fused_mfcc(wavs, dataclasses.replace(CFG, dft_variant="fft"))
    assert mfcc.resolve_dft_variant(CFG, N) == "hops"
    with pytest.raises(ValueError, match="no front-end kernel"):
        mfcc.fused_mfcc(torch.zeros(2, N, device="meta"), CFG)

