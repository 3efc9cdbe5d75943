"""The phase-grouped (K8) and radix-4 (K9) front ends of the port against
the JAX package: their plain versions against the Pallas kernels in
interpret mode (MFCC kernel and the single-kernel front end), the radix-4
XLA path of dsp.preprocess, the constant builders and the variant
resolution. The kernels' sizes are the JAX kernel tests' (n = 2560,
tests/test_pallas.py) at both reference geometries."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu.ops import dsp as jdsp
from tcresnet_tpu.ops.pallas import frontend as jfrontend
from tcresnet_tpu.ops.pallas import mfcc as jmfcc
from tcresnet_tpu.ops.pallas.augment import _draw_scalars
from tcresnet_tpu_torch.config import AudioConfig, AugmentConfig, get_preset
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset
from tcresnet_tpu_torch.ops import augment as aug
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.ops.kernels import frontend, mfcc
from tcresnet_tpu_torch.ops.kernels.augment import AugmentScalars, augment_reference
from tests.test_torch_config import to_jax_config

torch.set_num_threads(1)

N, P = 2560, 4096  # the JAX kernel tests' clip; dataset rows padded to P
ATOL = 1e-4  # the JAX package's kernel tolerance (tests/test_pallas.py)
GEOMETRIES = {"30/10": AudioConfig(clip_duration_ms=N // 16),
              "40/20": AudioConfig(clip_duration_ms=N // 16, window_size_ms=40.0,
                                   window_stride_ms=20.0)}
METHODS = ["mfcc", "log_mel_spectrogram"]


def _cfg(geometry, method, variant):
    return dataclasses.replace(GEOMETRIES[geometry], preprocess_method=method,
                               dft_variant=variant)


@pytest.mark.parametrize("variant", ["phases", "radix4"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_plain_variant_matches_jax_kernel(geometry, method, variant):
    """K8's and K9's plain versions (what fused_mfcc runs on a CPU tensor)
    against JAX's fused_mfcc(interpret=True, variant=...)."""
    cfg = _cfg(geometry, method, variant)
    assert mfcc.resolve_dft_variant(cfg, N) == variant
    wavs = np.random.default_rng(1).uniform(-1, 1, (4, N)).astype(np.float32)
    want = np.asarray(jmfcc.fused_mfcc(jnp.asarray(wavs), to_jax_config(cfg), interpret=True,
                                       variant=variant))
    got = mfcc.fused_mfcc(torch.tensor(wavs), cfg).numpy()
    assert got.shape == want.shape == (4, dsp.num_frames_for(
        N, cfg.window_size_samples, cfg.window_stride_samples), dsp.feature_width(cfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got, mfcc.fused_mfcc_reference(torch.tensor(wavs), cfg,
                                                                 variant).numpy())
    # dsp_backend="pallas" takes the same plain version on the CPU
    feats = dsp.preprocess(torch.tensor(wavs), dataclasses.replace(cfg, dsp_backend="pallas"))
    np.testing.assert_array_equal(feats[..., 0].numpy(), got)


@pytest.mark.parametrize("variant", ["phases", "radix4"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_k3_plain_variant_matches_jax_kernel(geometry, method, variant):
    """K3's phases and radix4 branches: the same scalars (JAX's draw) into
    JAX's single-kernel front end and the port's plain K3 (K1's plain
    version, then K8's or K9's)."""
    rng = np.random.default_rng(2)
    rows, batch = 12, 8
    data = np.zeros((rows, P), np.int16)
    data[:, :N] = rng.integers(-32768, 32768, (rows, N))
    idx = rng.integers(0, rows, batch).astype(np.int32)
    silent = rng.integers(0, 4, batch) == 0
    noise = (rng.normal(size=(3, 3 * N)) * 0.1).astype(np.float32)
    aug_cfg = AugmentConfig(background_frequency=0.8, background_max_volume=0.3)
    cfg = _cfg(geometry, method, variant)
    scalars = _draw_scalars(jax.random.key(3), jnp.asarray(silent), to_jax_config(aug_cfg),
                            jnp.asarray(noise), N, True)
    want = np.asarray(jfrontend._impl(
        jnp.asarray(data.reshape(rows, P // 128, 128)), jnp.asarray(idx), scalars,
        jnp.asarray(noise), N, to_jax_config(cfg), True, False, variant, 8))
    ts = AugmentScalars(*(torch.tensor(np.asarray(a), dtype=torch.int32) for a in scalars[:3]),
                        *(torch.tensor(np.asarray(a), dtype=torch.float32) for a in scalars[3:]))
    got = frontend.frontend_features(torch.tensor(data[:, :N].copy()), torch.tensor(idx), ts,
                                     torch.tensor(noise), cfg, N).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_radix4_preprocess_matches_jax_on_a_full_clip(geometry, method):
    """dsp.preprocess with dft_variant="radix4" (the XLA path) at n = 16000
    within 1e-5: absolute for log-mel, relative for MFCC, whose values reach
    ~70 where float32 steps are 7.6e-6 (the dense path differs from JAX by
    the same 2e-5 there: the DCT's float32 sums in another order)."""
    cfg = dataclasses.replace(GEOMETRIES[geometry], clip_duration_ms=1000,
                              preprocess_method=method, dft_variant="radix4")
    wavs = np.random.default_rng(3).uniform(-1, 1, (3, 16000)).astype(np.float32)
    want = np.asarray(jdsp.preprocess(jnp.asarray(wavs), to_jax_config(cfg)))
    got = dsp.preprocess(torch.tensor(wavs), cfg).numpy()
    assert got.shape == want.shape == (3,) + dsp.feature_shape(cfg)
    if method == "mfcc":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    dense = dsp.preprocess(torch.tensor(wavs), dataclasses.replace(cfg, dft_variant="hops"))
    assert np.abs(got - dense.numpy()).max() > 0  # another path, the same features
    np.testing.assert_allclose(got, dense.numpy(), rtol=1e-5, atol=1e-4)


def test_radix4_bf16_preprocess_matches_jax():
    """dsp_matmul_dtype="bfloat16": the windowed blocks round to bf16 and
    the butterfly adds round again, then the products sum in float32."""
    cfg = dataclasses.replace(GEOMETRIES["30/10"], dft_variant="radix4",
                              dsp_matmul_dtype="bfloat16")
    wavs = np.random.default_rng(4).uniform(-1, 1, (2, N)).astype(np.float32)
    want = np.asarray(jdsp.preprocess(jnp.asarray(wavs), to_jax_config(cfg)))
    got = dsp.preprocess(torch.tensor(wavs), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
    f32 = dsp.preprocess(torch.tensor(wavs), dataclasses.replace(cfg, dsp_matmul_dtype="float32"))
    assert np.abs(got - f32.numpy()).max() > 1e-4  # the rounding did happen


@pytest.mark.parametrize("name,args", [
    ("radix4_dft_matrices", (512,)), ("radix4_dft_matrices", (1024,)),
    ("radix4_bin_map", (512,)), ("radix4_bin_map", (1024,)),
    ("radix4_mel_matrix", (40, 512, 16000, 20.0, 4000.0)),
    ("radix4_mel_matrix", (64, 1024, 16000, 80.0, 7600.0)),
    ("radix4_window", (480, 512)), ("radix4_window", (640, 1024)),
])
def test_radix4_constants_equal_jax(name, args):
    got, want = getattr(dsp, name)(*args), getattr(jdsp, name)(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("window,hop,n", [(480, 160, 16000), (640, 320, 16000),
                                          (480, 160, N), (640, 320, N)])
def test_phase_dft_plan_equals_jax(window, hop, n):
    fft_length = dsp.fft_length_for(window)
    got = mfcc.phase_dft_plan(window, hop, n, fft_length)
    want = jmfcc.phase_dft_plan(window, hop, n, fft_length)
    assert got[:4] == want[:4]
    for (c, r, f, w), (jc, jr, jf, jw) in zip(got[4], want[4]):
        assert (c, r, f) == (jc, jr, jf)
        assert w.dtype == jw.dtype and np.array_equal(w, jw)
    with pytest.raises(ValueError, match="lane-aligned"):
        mfcc.phase_dft_plan(window, hop, 2720, fft_length)


def test_resolve_dft_variant_equals_jax():
    """Both geometries; the 60 ms window, where radix4 falls back (window >
    lcm(hop, 128) + hop); the 2720-sample clip, where phases (and radix4)
    fall back (not lane-aligned); an unknown string raises in both."""
    configs = [*GEOMETRIES.values(), AudioConfig(window_size_ms=60.0),
               AudioConfig(preprocess_method="log_mel_spectrogram")]
    seen = set()
    for base in configs:
        for variant in ("auto", "hops", "phases", "radix4"):
            cfg = dataclasses.replace(base, dft_variant=variant)
            for n in (16000, N, 2720):
                got = mfcc.resolve_dft_variant(cfg, n)
                assert got == jmfcc.resolve_dft_variant(to_jax_config(cfg), n), (cfg, n)
                seen.add((variant, got))
    assert {("auto", "hops"), ("radix4", "hops"), ("phases", "hops"), ("phases", "phases"),
            ("radix4", "radix4")} <= seen
    wide = dataclasses.replace(AudioConfig(window_size_ms=60.0), dft_variant="radix4")
    assert mfcc.resolve_dft_variant(wide, 16000) == "hops"
    bad = dataclasses.replace(AudioConfig(), dft_variant="fft")
    with pytest.raises(ValueError, match="dft_variant"):
        mfcc.resolve_dft_variant(bad, 16000)
    with pytest.raises(ValueError, match="dft_variant"):
        jmfcc.resolve_dft_variant(to_jax_config(bad), 16000)


@pytest.mark.parametrize("window_ms,hop_ms,rows", [(30.0, 10.0, 112), (40.0, 20.0, 64)])
def test_kernel_shared_memory_plans(window_ms, hop_ms, rows):
    """The plans of the three variants at 1 s: K2's and K8's (one stage)
    for a tile of the batch's frames: its sample span, the mel's runs and
    nonzero weights, the ring of three [32, 136] slices of the DFT, a
    [rows, 65] power tile and [rows, num_mel] mel sums; at 128 rows the
    wgmma product's (`tc_wg_plan`): the span, runs, weights and power tile
    (the mel sums in registers), 1 KB to align the ring, as many 8 KB
    slots of the split constant as fit (10 to 16) and two 8-byte barriers
    a slot, or ten where fewer fit, past a block; K9 keeps the samples (64,000 B), the window and the
    mel's runs and nonzero weights, and no power spectrum: the ring, two A
    slices of its product's rows, a [frames, 65] power tile and the
    [frames, num_mel] mel sums; each within a Hopper block."""
    cfg = AudioConfig(window_size_ms=window_ms, window_stride_ms=hop_ms)
    g = mfcc.front_end_geometry(cfg, 16000)
    length = g.fft_length // 4
    runs, vals = mfcc.tc_mel_constants(*dsp.mel_args(cfg))
    stride, gap = g.hop + 4, 352  # 352: the multiple of 32 that holds 2 (1) chunks of 164 (324)
    wh = g.window // g.hop
    for tile in mfcc.TC_TILE_ROWS:
        pieces = 2 + (tile - 2) // g.frames  # utterances a tile's rows can touch
        phases = mfcc.smem_plan(g, "phases", vals.size, tile)
        assert phases == mfcc.smem_plan(g, "hops", vals.size, tile)
        common = {"samples": (tile + wh - 1) * stride + (pieces - 1) * gap,
                  "runs": runs.size + (-runs.size % 4), "vals": vals.size + (-vals.size % 4)}
        if tile == 128:
            stages = phases["ring"] // (32 * 64)
            assert phases == {**common, "power": 128 * 65, "align": 256,
                              "ring": stages * 32 * 64, "barriers": 4 * stages}
            room = mfcc.SMEM_LIMIT // 4 - sum(common.values()) - 128 * 65 - 256
            assert stages == max(10, min(16, room // (32 * 64 + 4)))
            assert stages == (12 if g.hop == 160 else 10)
        else:
            assert phases == {**common, "ring": 3 * 32 * 136,
                              "power": tile * 65 + (-tile * 65 % 4), "mel": tile * g.num_mel}
        assert all(x % 4 == 0 for x in phases.values())
        # the 128-row tile does not fit at 640/320: its span is 171 KB
        fits = mfcc.smem_bytes(g, "phases", vals.size, tile) <= mfcc.SMEM_LIMIT
        assert fits == (tile < 128 or g.hop == 160)
    nnz = mfcc.radix4_kernel_constants(*dsp.radix4_mel_args(cfg))[2].size
    plan = mfcc.smem_plan(g, "radix4", nnz)
    assert mfcc.radix4_product_rows(g.frames) == rows
    assert plan == {"samples": 16000, "window": 4 * length,
                    "runs": 4 * length // 128 * g.num_mel * 3, "vals": nnz + (-nnz % 4),
                    "ring": 3 * 32 * 136, "stage": 2 * rows * 36,
                    "power": g.frames * 65 + (-g.frames * 65 % 4),
                    "mel": g.frames * g.num_mel}
    assert all(x % 4 == 0 for x in plan.values())  # the ring's 16-byte copies stay aligned
    assert mfcc.smem_bytes(g, "radix4", nnz) == 4 * sum(plan.values()) <= mfcc.SMEM_LIMIT
    for variant in ("hops", "phases", "radix4"):
        assert mfcc.fused_mfcc_available(dataclasses.replace(cfg, dft_variant=variant), 16000)
    # a clip whose frames exceed the largest product has no radix4 plan:
    # it runs K2's stage, whose plan does not grow with the clip
    long = mfcc.front_end_geometry(cfg, 40960)
    assert long.frames > 112 and mfcc.smem_plan(long, "radix4") is None
    long_cfg = dataclasses.replace(cfg, dft_variant="radix4")
    assert mfcc.resolve_dft_variant(long_cfg, long.n) == "radix4"
    assert mfcc.kernel_variant(long_cfg, long.n) == "hops"
    assert mfcc.fused_mfcc_available(long_cfg, long.n)
    # K8's constant (K2's too) is the live rows of every W_p (the rows at
    # o_p), with the interleave keeping (re_k, im_k) next to each other, its
    # first fft / 2 bins; its mel is the runs of nonzero weights over those
    # bins, 64 a unit
    fe = mfcc.FrontEnd(dataclasses.replace(cfg, dft_variant="phases"), 16000, "cpu", "phases")
    v = fe.variant_args()
    assert (v.units, v.stride, v.gap, v.mel_nnz) == (g.fft_length // 128, stride, gap, vals.size)
    w = fe.dft.numpy()
    assert w.shape == (g.window, g.fft_length)
    half = g.num_bins - 1
    for p, (c, _, _, std) in enumerate(
            mfcc.phase_dft_plan(g.window, g.hop, 16000, g.fft_length)[4]):
        o = g.hop * p - 128 * c
        np.testing.assert_array_equal(w[:, 0::2], std[o:o + g.window, 0:half])
        np.testing.assert_array_equal(w[:, 1::2], std[o:o + g.window, g.num_bins:g.num_bins + half])
    hops = mfcc.FrontEnd(cfg, 16000, "cpu", "hops")
    assert torch.equal(hops.dft, fe.dft) and torch.equal(hops.runs, fe.runs)
    assert tuple(fe.runs.shape) == (g.fft_length // 128, cfg.num_mel_bins, 3)
    plan = mfcc.tc_tile_plan(1536, g, vals.size)
    v, span, smem, part = fe.launch_args(1536)
    assert (v.rows, v.splits, span, smem, part) == (plan.rows, 1, plan.span, plan.smem_bytes, None)
    assert plan.rows == (128 if g.hop == 160 else 64)
    # batch 1: 16-row tiles, each unit a block; the units' mel contributions
    # in a workspace the tile's last block adds up
    v, _, _, part = fe.launch_args(1)
    assert (v.rows, v.splits) == (16, g.fft_length // 128)
    assert part.numel() == -(-g.frames // 16) * v.units * g.num_mel * 16
    r4 = mfcc.FrontEnd(dataclasses.replace(cfg, dft_variant="radix4"), 16000, "cpu", "radix4")
    assert (r4.args().frames, r4.args().num_mel) == (g.frames, cfg.num_mel_bins)
    assert r4.region_a == 16000 and r4.smem_bytes == mfcc.smem_bytes(g, "radix4", nnz)
    assert tuple(r4.mel.shape) == (nnz + (-nnz % 4),) and r4.variant_args().mel_nnz == nnz
    assert r4.dft.numel() == 6 * length * length
    assert tuple(r4.runs.shape) == (4 * length // 128, cfg.num_mel_bins, 3)


@pytest.mark.parametrize("fft_length,mel_args", [(512, (64, 16000, 20.0, 4000.0)),
                                                 (1024, (40, 16000, 20.0, 8000.0))])
def test_radix4_kernel_constants_are_the_live_parts(fft_length, mel_args):
    """K9's compacted constants equal the full radix4_dft_matrices and
    radix4_mel_matrix on their live parts: M0's and M2's k2 < L/2 columns
    and all of M1 as (re, im) pairs, the mel rows of those pairs; what is
    left out is zero (M0's k2 > L/2, M2's k2 >= L/2, their mel rows) or the
    Nyquist bin (M0's k2 = L/2), whose mel weight is zero up to an upper
    edge at the Nyquist frequency. Each unit's mel runs hold every nonzero
    weight of their band and only those, and point at them in `vals`."""
    num_mel, *rest = mel_args
    length = fft_length // 4
    w, runs, vals = mfcc.radix4_kernel_constants(num_mel, fft_length, *rest)
    m0, m1, m2 = dsp.radix4_dft_matrices(fft_length)
    assert w.dtype == np.float32 and w.size == 6 * length * length
    k0 = w[:length * length].reshape(length, length)
    k1 = w[length * length:5 * length * length].reshape(2 * length, 2 * length)
    k2 = w[5 * length * length:].reshape(length, length)
    for k, m, count in ((k0, m0, length // 2), (k1, m1, length), (k2, m2, length // 2)):
        np.testing.assert_array_equal(k[:, 0::2], m[:, :count])
        np.testing.assert_array_equal(k[:, 1::2], m[:, length:length + count])
    assert not m0[:, length // 2 + 1:length].any() and not m0[:, length + length // 2 + 1:].any()
    assert not m2[:, length // 2:length].any() and not m2[:, length + length // 2:].any()
    assert np.abs(m0[:, length + length // 2]).max() < 1e-12  # sin(pi n): the Nyquist bin
    mel = dsp.radix4_mel_matrix(num_mel, fft_length, *rest)
    rows = mfcc.radix4_kernel_rows(fft_length)
    kmel = mel[rows]
    assert rows.shape == (2 * length,) and len(set(rows.tolist())) == 2 * length
    # the kernel's power rows are its pairs' bins: M0's and M2's k2 < L/2, all of M1
    bins = dsp.radix4_bin_map(fft_length)
    np.testing.assert_array_equal(
        bins[rows], np.concatenate([4 * np.arange(length // 2), bins[length:2 * length],
                                    2 + 4 * np.arange(length // 2)]))
    assert bins[length // 2] == fft_length // 2
    assert not np.delete(mel, rows, axis=0).any()
    assert runs.shape == (2 * length // 64, num_mel, 3)
    for u in range(runs.shape[0]):
        for m in range(num_mel):
            col = kmel[u * 64:(u + 1) * 64, m]
            r0, r1, off = runs[u, m]
            assert np.count_nonzero(col) == r1 - r0 and np.all(col[r0:r1] != 0)
            np.testing.assert_array_equal(vals[off:off + r1 - r0], col[r0:r1])
    assert vals.dtype == np.float32 and vals.size == np.count_nonzero(kmel)
    # an upper edge past the Nyquist frequency weighs the bin K9 leaves out
    with pytest.raises(ValueError, match="mel weight"):
        mfcc.radix4_kernel_constants(num_mel, fft_length, 16000, 20.0, 9000.0)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared: what the tensor cores read."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _tf32_rn(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value, ties away from zero (the bits
    plus half a TF32 ulp, then cleared): csrc/async_mma.cuh's split_tf32_rn."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor, hi=_tf32) -> torch.Tensor:
    """A 3xTF32 product emulated: each operand split into hi = `hi(x)` (a
    TF32 value: the truncated split by default) and lo = `hi(x - hi)`, as
    the tensor cores read it; hi*hi + (lo*hi + hi*lo), every product of
    TF32 values exact in float32 and summed in float32."""
    ahi, bhi = hi(a), hi(b)
    alo, blo = hi(a - ahi), hi(b - bhi)
    return ahi @ bhi + (alo @ bhi + ahi @ blo)


def radix4_replay(wavs: torch.Tensor, cfg: AudioConfig, product=torch.matmul) -> torch.Tensor:
    """K9's order on the CPU (csrc/radix4.cuh): the butterfly of every
    frame, then unit by unit (128 columns of one branch of the compacted
    M0 | M1 | M2) the product over K steps of 8 rows (the mma's k8), each
    step's `product` added to the unit's float32 sums; the unit's power;
    its contribution through its mel runs added to the (frame, band) sums;
    then log(mel + 1e-6) and the DCT for MFCC."""
    n = wavs.shape[-1]
    g = mfcc.front_end_geometry(cfg, n)
    length = g.fft_length // 4
    dtype = dsp.dsp_matmul_dtype(cfg)
    w, runs, vals = mfcc.radix4_kernel_constants(*dsp.radix4_mel_args(cfg))
    w = dsp.round_operand(torch.tensor(w), dtype)
    ms = (w[:length * length].reshape(length, length),
          w[length * length:5 * length * length].reshape(2 * length, 2 * length),
          w[5 * length * length:].reshape(length, length))
    fr = dsp.frame_signal(wavs, g.window, g.hop) * torch.tensor(dsp.hann_window(g.window))
    fr = torch.nn.functional.pad(fr, (0, g.fft_length - g.window)).to(dtype)
    us = [u.to(torch.float32) for u in dsp.radix4_butterfly(fr, g.fft_length)]
    vals = torch.tensor(vals)
    sums = torch.zeros(wavs.shape[0], g.frames, g.num_mel)
    unit = 0
    for u, m in zip(us, ms):
        for n0 in range(0, m.shape[1], 128):
            acc = torch.zeros(wavs.shape[0], g.frames, 128)
            for k0 in range(0, m.shape[0], 8):
                acc = acc + product(u[..., k0:k0 + 8], m[k0:k0 + 8, n0:n0 + 128])
            power = acc[..., 0::2] * acc[..., 0::2] + acc[..., 1::2] * acc[..., 1::2]
            if g.magnitude:
                power = torch.sqrt(power)
            for band in range(g.num_mel):
                r0, r1, off = (int(x) for x in runs[unit, band])
                sums[..., band] += (power[..., r0:r1] * vals[off:off + r1 - r0]).sum(-1)
            unit += 1
    log_mel = torch.log(sums + 1e-6)
    if g.magnitude:
        return log_mel
    return log_mel @ torch.tensor(dsp.dct_ii_matrix(cfg.num_mel_bins, cfg.num_mfccs))


FULL_CLIPS = {"480-160": "TCResNet8-1.0", "640-320": "DSCNNL"}


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("clip", sorted(FULL_CLIPS))
def test_radix4_replay_meets_plain_version_on_full_clips(clip, method):
    """The kernel's order (column units, K steps of 8, the mel summed unit
    by unit over the live rows) at n = 16000 within ATOL of K9's plain
    version."""
    cfg = dataclasses.replace(get_preset(FULL_CLIPS[clip]).audio, preprocess_method=method,
                              dft_variant="radix4")
    wavs = torch.tensor(np.random.default_rng(5).uniform(-1, 1, (3, 16000)).astype(np.float32))
    got = radix4_replay(wavs, cfg)
    want = mfcc.fused_mfcc_reference(wavs, cfg, "radix4")
    assert got.shape == want.shape == (3,) + dsp.feature_shape(cfg)[:2]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("dsp_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_radix4_replay_meets_jax_kernel(geometry, dsp_dtype):
    """The kernel's order against JAX's _kernel_radix4 in interpret mode at
    n = 2560: ATOL in float32, the bf16 tolerance with the bf16 DFT."""
    cfg = dataclasses.replace(_cfg(geometry, "mfcc", "radix4"), dsp_matmul_dtype=dsp_dtype)
    wavs = np.random.default_rng(6).uniform(-1, 1, (3, N)).astype(np.float32)
    want = np.asarray(jmfcc.fused_mfcc(jnp.asarray(wavs), to_jax_config(cfg), interpret=True,
                                       variant="radix4"))
    got = radix4_replay(torch.tensor(wavs), cfg).numpy()
    tol = ATOL if dsp_dtype == "float32" else 5e-3
    np.testing.assert_allclose(got, want, rtol=0 if dsp_dtype == "float32" else tol, atol=tol)


def _dataset_rows(n: int, batch: int = 8):
    """Synthetic dataset rows (loud tones) augmented by K1's plain version."""
    ds = DeviceDataset(make_synthetic_dataset(num_samples=48, num_classes=12,
                                              desired_samples=n, seed=0), "cpu")
    gen = torch.Generator().manual_seed(958)
    idx, _, silent = DeviceDataset.sample_indices(ds.arrays, gen, batch)
    scalars = aug.draw_scalars(gen, silent, get_preset("TCResNet8-1.0").augment, ds.noise_bank,
                               n, True)
    return augment_reference(ds.wavs, idx, scalars, ds.noise_bank, n)


@pytest.mark.parametrize("split", ["truncated", "rounded"])
@pytest.mark.parametrize("source", ["wavs", "dataset rows"])
@pytest.mark.parametrize("clip", sorted(FULL_CLIPS))
def test_radix4_3xtf32_emulation_meets_float64(clip, source, split):
    """3xTF32 products emulated over the radix-4 stage in the kernel's
    order, within ATOL of the float64 MFCC, on seeded wavs and on dataset
    rows (MFCCs up to ~160): with the truncated split (hi = x & 0xffffe000,
    lo the rest read as TF32: K5's) and with both parts rounded to the
    nearest TF32 value (K9's)."""
    cfg = dataclasses.replace(get_preset(FULL_CLIPS[clip]).audio, dft_variant="radix4")
    n = 16000
    if source == "wavs":
        wavs = torch.tensor(np.random.default_rng(7).uniform(-1, 1, (4, n)).astype(np.float32))
    else:
        wavs = _dataset_rows(n)
    hi = _tf32 if split == "truncated" else _tf32_rn
    got = radix4_replay(wavs, cfg, lambda a, b: tf32x3_matmul(a, b, hi)).numpy()
    want = mfcc_float64(wavs.numpy(), cfg)
    if source == "dataset rows":
        assert np.abs(want).max() > 100
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the split did round: one TF32 product alone misses the gate
    coarse = radix4_replay(wavs, cfg, lambda a, b: _tf32(a) @ _tf32(b)).numpy()
    assert np.abs(coarse - want).max() > ATOL


def mfcc_float64(wavs: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """MFCC of float32 wavs evaluated in float64 (numpy), from the port's
    float32 constants: frames @ windowed DFT -> power -> mel -> log -> DCT.
    Every DFT variant computes this function; only its rounding differs."""
    win, hop = cfg.window_size_samples, cfg.window_stride_samples
    fft = dsp.fft_length_for(win)
    bins = fft // 2 + 1
    frames = dsp.num_frames_for(wavs.shape[-1], win, hop)
    idx = np.arange(frames)[:, None] * hop + np.arange(win)[None, :]
    reim = wavs.astype(np.float64)[:, idx] @ dsp.windowed_rdft_matrix(win, fft).astype(np.float64)
    power = reim[..., :bins] ** 2 + reim[..., bins:] ** 2
    mel = dsp.linear_to_mel_weight_matrix(*dsp.mel_args(cfg)).astype(np.float64)
    dct = dsp.dct_ii_matrix(cfg.num_mel_bins, cfg.num_mfccs).astype(np.float64)
    return np.log(power @ mel + 1e-6) @ dct


@pytest.mark.parametrize("variant", ["phases", "radix4"])
@pytest.mark.parametrize("preset", ["TCResNet8-1.0", "DSCNNL"], ids=["480-160", "640-320"])
def test_k3_plain_variant_on_dataset_rows_meets_float64(preset, variant):
    """K3's plain version in the variant (K1's plain version, then K8's or
    K9's) on synthetic dataset rows (loud tones: MFCCs up to ~160, where
    float32 steps are 1.5e-5) at 1 s, against the same augmented rows in
    float64: within ATOL, 1e-4 (measured <= 5.3e-5). The kernel is
    held to the same float64 values on the card
    (tests/test_torch_cuda.py::test_k3_variants_equal_their_mfcc_of_k1)."""
    n = 16000
    cfg = dataclasses.replace(get_preset(preset).audio, dft_variant=variant)
    assert mfcc.resolve_dft_variant(cfg, n) == variant
    ds = DeviceDataset(make_synthetic_dataset(num_samples=48, num_classes=12,
                                              desired_samples=n, seed=0), "cpu")
    gen = torch.Generator().manual_seed(958)
    idx, _, silent = DeviceDataset.sample_indices(ds.arrays, gen, 8)
    scalars = aug.draw_scalars(gen, silent, get_preset("TCResNet8-1.0").augment, ds.noise_bank,
                               n, True)
    got = frontend.frontend_reference(ds.wavs, idx, scalars, ds.noise_bank, cfg, n).numpy()
    want = mfcc_float64(augment_reference(ds.wavs, idx, scalars, ds.noise_bank, n).numpy(), cfg)
    assert np.abs(want).max() > 100  # the loud rows the gate question is about
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
