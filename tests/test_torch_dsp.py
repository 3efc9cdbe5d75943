"""PyTorch front end (tcresnet_tpu_torch.ops.dsp) against the JAX one."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu_torch.config import AudioConfig
from tcresnet_tpu.ops import dsp as jdsp
from tcresnet_tpu_torch.ops import dsp as tdsp
from tests.test_torch_config import to_jax_config

torch.set_num_threads(1)

# the two reference feature geometries, cut to a 160 ms clip
GEOMETRIES = {
    "30/10ms": AudioConfig(clip_duration_ms=160, num_mfccs=20, num_mel_bins=32),
    "40/20ms": AudioConfig(clip_duration_ms=160, num_mfccs=20, num_mel_bins=32,
                           window_size_ms=40.0, window_stride_ms=20.0),
}

CONSTANT_CASES = [
    ("hann_window", (480,)),
    ("hann_window", (640,)),
    ("windowed_rdft_matrix", (480, 512)),
    ("windowed_rdft_matrix", (640, 1024)),
    ("dft_hop_blocks", (480, 160, 512)),
    ("dft_hop_blocks", (640, 320, 1024)),
    ("linear_to_mel_weight_matrix", (64, 257, 16000, 80.0, 7600.0)),
    ("linear_to_mel_weight_matrix", (32, 513, 16000, 20.0, 4000.0)),
    ("dct_ii_matrix", (64, 40)),
    ("dct_ii_matrix", (32, 20)),
]


@pytest.mark.parametrize("name,args", CONSTANT_CASES)
def test_constant_builders_equal_jax(name, args):
    got = getattr(tdsp, name)(*args)
    want = getattr(jdsp, name)(*args)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("cfg", [AudioConfig(), *GEOMETRIES.values(),
                                 AudioConfig(preprocess_method="log_mel_spectrogram"),
                                 AudioConfig(preprocess_method="no_preprocessing")])
def test_geometry_helpers_equal_jax(cfg):
    assert tdsp.feature_shape(cfg) == jdsp.feature_shape(to_jax_config(cfg))
    assert tdsp.fft_length_for(cfg.window_size_samples) == jdsp.fft_length_for(
        cfg.window_size_samples)
    if cfg.preprocess_method != "no_preprocessing":
        assert tdsp.feature_width(cfg) == jdsp.feature_width(to_jax_config(cfg))


@pytest.mark.parametrize("method", ["mfcc", "log_mel_spectrogram"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_preprocess_matches_jax(geometry, method):
    """f32 features within 1e-5 of dsp.preprocess (the repo's parity gate)."""
    cfg = dataclasses.replace(GEOMETRIES[geometry], preprocess_method=method)
    wavs = np.random.default_rng(7).uniform(
        -1, 1, (3, cfg.desired_samples)).astype(np.float32)
    want = np.asarray(jdsp.preprocess(jnp.asarray(wavs), to_jax_config(cfg)))
    got = tdsp.preprocess(torch.tensor(wavs), cfg).numpy()
    assert got.shape == want.shape == (3,) + tdsp.feature_shape(cfg)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_preprocess_bf16_dft_matches_jax():
    """dsp_matmul_dtype="bfloat16": both round the DFT operands to bf16
    and accumulate in f32; they differ by summation order only."""
    cfg = dataclasses.replace(GEOMETRIES["30/10ms"], dsp_matmul_dtype="bfloat16")
    wavs = np.random.default_rng(8).uniform(
        -1, 1, (2, cfg.desired_samples)).astype(np.float32)
    want = np.asarray(jdsp.preprocess(jnp.asarray(wavs), to_jax_config(cfg)))
    got = tdsp.preprocess(torch.tensor(wavs), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    f32 = tdsp.preprocess(torch.tensor(wavs), GEOMETRIES["30/10ms"]).numpy()
    assert np.abs(got - f32).max() > 1e-4  # the rounding did happen


def test_preprocess_backends():
    """"auto" is the plain path on the CPU; "pallas" names the K2 kernel,
    whose plain version a CPU batch runs; radix4 takes the factored DFT,
    the same features to reassociation level;
    no_preprocessing adds the channel axis."""
    cfg = GEOMETRIES["30/10ms"]
    wavs = torch.tensor(np.random.default_rng(9).uniform(
        -1, 1, (2, cfg.desired_samples)).astype(np.float32))
    plain = tdsp.preprocess(wavs, cfg)
    auto = tdsp.preprocess(wavs, dataclasses.replace(cfg, dsp_backend="auto"))
    assert torch.equal(plain, auto)
    pallas = tdsp.preprocess(wavs, dataclasses.replace(cfg, dsp_backend="pallas"))
    assert torch.equal(plain, pallas)
    with pytest.raises(ValueError, match="dsp_backend"):
        tdsp.preprocess(wavs, dataclasses.replace(cfg, dsp_backend="mosaic"))
    radix4 = tdsp.preprocess(wavs, dataclasses.replace(cfg, dft_variant="radix4"))
    assert radix4.shape == plain.shape and not torch.equal(radix4, plain)
    np.testing.assert_allclose(radix4.numpy(), plain.numpy(), rtol=0, atol=1e-4)
    raw = tdsp.preprocess(wavs, dataclasses.replace(cfg, preprocess_method="no_preprocessing"))
    assert raw.shape == (2, cfg.desired_samples, 1, 1)
