"""K8's tensor-core design on the CPU (tcresnet_tpu_torch/csrc/dft_tc.cuh, the
phase-grouped DFT of `k2_mfcc` and `k3_frontend` in the phases variant):
the identity it rests on (every phase's live DFT rows are the windowed DFT,
and its A rows start at the frames' own samples), its host plan `mfcc.tc_tile_plan` with a
replay of the kernel's sample staging and row addressing, and an emulation
of its 3xTF32 arithmetic in the kernel's order, held to a float64 MFCC and
to the JAX Pallas kernel `_kernel_phases` in interpret mode."""

import ctypes
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu.ops.pallas import mfcc as jmfcc
from tcresnet_tpu_torch.config import AudioConfig, get_preset
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.ops.kernels import mfcc
from tests.test_torch_config import to_jax_config
from tests.test_torch_dft_variants import _dataset_rows, _tf32, mfcc_float64
from tests.test_torch_tconv_tc import _split, _toward_zero

torch.set_num_threads(1)

ATOL = 1e-4  # the card's K8 gate (chip_smoke.py FEATURE_ATOL, the JAX kernel test's)
BF16_TOL = 5e-3  # with dsp_matmul_dtype="bfloat16" (chip_smoke.py BF16_TOL)
N = 2560  # the JAX kernel tests' clip (tests/test_pallas.py)
CLIPS = {"480-160": "TCResNet8-1.0", "640-320": "DSCNNL"}  # 30/10 ms, 40/20 ms at 16 kHz


@pytest.mark.parametrize("window,hop,n", [(480, 160, 16000), (640, 320, 16000),
                                          (480, 160, N), (640, 320, N)])
def test_live_rows_of_every_phase_are_the_windowed_dft(window, hop, n):
    """For every phase p of `phase_dft_plan`: W_p[o_p : o_p + window] is the
    windowed DFT, every other row of W_p is zero, and c_p * 128 + o_p = hop
    p, so the A row of output q (frame P q + p) starts at sample hop (P q +
    p), the frame's own first sample: the phase-grouped DFT is frame @ W."""
    fft_length = dsp.fft_length_for(window)
    num_p, s_rows, _, frames, phases = mfcc.phase_dft_plan(window, hop, n, fft_length)
    dft = dsp.windowed_rdft_matrix(window, fft_length)
    assert sum(f for _, _, f, _ in phases) == frames
    for p, (c, rows_p, _, w) in enumerate(phases):
        o = hop * p - 128 * c
        assert 0 <= o < 128 and o + window <= rows_p * 128
        np.testing.assert_array_equal(w[o:o + window], dft)
        assert not w[:o].any() and not w[o + window:].any()
        for q in range(3):  # output row q's A row: superblock q's row c_p
            assert (s_rows * q + c) * 128 + o == hop * (num_p * q + p)


def test_unaligned_clip_has_no_phase_plan():
    """The 2720-sample clip is not lane-aligned: no phase plan, and a
    "phases" config falls back to hops there, as in JAX."""
    cfg = dataclasses.replace(AudioConfig(), dft_variant="phases")
    with pytest.raises(ValueError, match="lane-aligned"):
        mfcc.phase_dft_plan(480, 160, 2720, 512)
    assert mfcc.resolve_dft_variant(cfg, 2720) == "hops"
    assert jmfcc.resolve_dft_variant(to_jax_config(cfg), 2720) == "hops"


def _geometry(clip: str):
    cfg = dataclasses.replace(get_preset(CLIPS[clip]).audio, dft_variant="phases")
    g = mfcc.front_end_geometry(cfg, 16000)
    return cfg, g, mfcc.tc_mel_constants(*dsp.mel_args(cfg))[1].size


def stage_replay(plan: mfcc.TcPlan, g, batch: int, tile: int):
    """tc_stage for block `tile`: the staged span with the id b * n + t of
    utterance b's sample t at each place written (-2 where a zero is
    written past the clip's end, -1 elsewhere), and the tile's first row,
    row count and first utterance. Chunk c of a piece holds
    `mfcc.tc_chunk(hop)` samples from hop (fa + c) on. Raises where a place
    is written twice or lies outside the span."""
    r0 = tile * plan.rows
    nrows = min(plan.rows, batch * g.frames - r0)
    b0, f0 = divmod(r0, g.frames)
    last = r0 + nrows - 1
    b1 = last // g.frames
    span = np.full(plan.span, -1, np.int64)
    for b in range(b0, b1 + 1):
        i = b - b0
        fa = f0 if i == 0 else 0
        fb = last - b * g.frames if b == b1 else g.frames - 1
        dst = (b * g.frames + fa - r0) * plan.stride + i * plan.gap
        c = np.arange(fb - fa + g.window // g.hop)[:, None]
        hs = mfcc.tc_chunk(g.hop)
        pos = dst + c * plan.stride + np.arange(hs)
        assert (span[pos] == -1).all()
        t = g.hop * (fa + c) + np.arange(hs)
        span[pos] = np.where(t < g.n, b * g.n + t, -2)
    return span, r0, nrows, b0


@pytest.mark.parametrize("batch", [1, 8, 1536])
@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_tile_plan_covers_every_row_once_and_stages_what_it_reads(clip, batch):
    """The plan's tiles cover each (utterance, frame) row of the batch
    exactly once, and its blocks each (tile, column unit) exactly once; for
    every tile alignment, the kernel's staging writes each place of the
    span at most once, and every fragment row (those past the tile clamped
    to its last) reads at sample k of its frame exactly that sample, at lr
    * stride + i * gap + k + 4 (k // hop); the eight rows of a fragment fall
    in distinct 4-bank groups; the plan fits a Hopper block. Batch 1536
    takes the large tiles, unsplit; a small batch 16-row tiles with their
    units split until the grid reaches every SM (or each unit is a block)."""
    _, g, nnz = _geometry(clip)
    plan = mfcc.tc_tile_plan(batch, g, nnz)
    assert plan == mfcc.tc_tile_plan(batch, g, nnz)
    total = batch * g.frames
    units = g.fft_length // 128
    assert plan.rows in mfcc.TC_TILE_ROWS and plan.smem_bytes <= mfcc.SMEM_LIMIT
    assert plan.rows == (16 if batch < 1536 else 128 if g.hop == 160 else 64)
    assert (plan.tiles - 1) * plan.rows < total <= plan.tiles * plan.rows
    cover = np.bincount(np.arange(total) // plan.rows, minlength=plan.tiles)
    assert cover.sum() == total and (cover[:-1] == plan.rows).all()
    assert units % plan.splits == 0 and plan.grid == plan.tiles * plan.splits
    assert plan.splits == (1 if plan.tiles >= mfcc.SMS else
                           units if plan.tiles * units <= mfcc.SMS else
                           min(d for d in (1, 2, 4, 8) if plan.tiles * d >= mfcc.SMS))
    # the kernel's blocks (tc_tile): tile = block / splits, units [u0, u1)
    block = np.arange(plan.grid)
    per = units // plan.splits
    u0 = block % plan.splits * per
    unit_of = (block // plan.splits)[:, None] * units + u0[:, None] + np.arange(per)
    assert (np.bincount(unit_of.ravel(), minlength=plan.tiles * units) == 1).all()
    assert plan.stride % 8 == 4 and plan.gap % 32 == 0
    k = np.arange(g.window)
    koff = k + 4 * (k // g.hop)
    seen = set()
    for tile in range(plan.tiles):
        key = (tile * plan.rows % g.frames, min(plan.rows, total - tile * plan.rows))
        if key in seen:
            continue
        seen.add(key)
        span, r0, nrows, b0 = stage_replay(plan, g, batch, tile)
        lr = np.minimum(np.arange(plan.rows), nrows - 1)
        b, f = np.divmod(r0 + lr, g.frames)
        base = lr * plan.stride + (b - b0) * plan.gap
        np.testing.assert_array_equal(span[base[:, None] + koff],
                                      b[:, None] * g.n + g.hop * f[:, None] + k)
        for first in range(0, nrows - 7, 8):
            assert len(set(base[first:first + 8] % 32)) == 8
    assert len(seen) >= min(plan.tiles, 2)


def tf32x3_step(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One k8 step of the kernel's products: lo*hi, + hi*lo, + hi*hi of the
    split operands (split_tf32_rn), each 8-term sum exact and each
    tensor-core add rounded toward zero, summed from zero (float32)."""
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    p = _toward_zero(alo @ bhi)
    p = _toward_zero(p.double() + ahi @ blo)
    return _toward_zero(p.double() + ahi @ bhi)


def emulate_stage(wavs: torch.Tensor, cfg: AudioConfig, step=tf32x3_step) -> torch.Tensor:
    """The frames' stage on the CPU (frames_kernel: K2 and K8, k2_mfcc):
    every frame's A row as the kernel reads it from the staged chunks (its
    window / hop chunks of `mfcc.tc_chunk(hop)` samples, each from the
    chunk's hop on, zeros past the clip) times the kernel's constant
    (`mfcc.tc_dft_matrix`: the live DFT rows, each chunk's rows past its hop
    zero, the first fft / 2 bins interleaved), in k8 steps in K order, each
    step's `step` product added to float32 sums; the power (magnitude for
    log-mel); the mel unit by unit over its runs of nonzero weights; log(mel
    + 1e-6) and the DCT for MFCC. dsp_matmul_dtype rounds both operands."""
    n = wavs.shape[-1]
    g = mfcc.front_end_geometry(cfg, n)
    kp, hs = mfcc.tc_kp(g.window, g.hop), mfcc.tc_chunk(g.hop)
    dtype = dsp.dsp_matmul_dtype(cfg)
    k = torch.arange(kp)
    t = g.hop * (torch.arange(g.frames)[:, None] + k // hs) + k % hs  # [frames, Kp]
    x = torch.nn.functional.pad(wavs, (0, int(t.max()) + 1 - n))
    a = dsp.round_operand(x[:, t], dtype).float()
    w = torch.tensor(mfcc.tc_dft_matrix(g.window, g.hop, g.fft_length))
    w = dsp.round_operand(w, dtype).float()
    acc = torch.zeros(*a.shape[:2], w.shape[1])
    for k0 in range(0, kp, 8):
        acc = acc + step(a[..., k0:k0 + 8], w[k0:k0 + 8])
    power = acc[..., 0::2] * acc[..., 0::2] + acc[..., 1::2] * acc[..., 1::2]
    if g.magnitude:
        power = torch.sqrt(power)
    runs, vals = mfcc.tc_mel_constants(*dsp.mel_args(cfg))
    vals = torch.tensor(vals)
    sums = torch.zeros(*a.shape[:2], g.num_mel)
    for u in range(runs.shape[0]):
        unit = power[..., 64 * u:64 * (u + 1)]
        for band in range(g.num_mel):
            r0, r1, off = (int(x) for x in runs[u, band])
            sums[..., band] += (unit[..., r0:r1] * vals[off:off + r1 - r0]).sum(-1)
    log_mel = torch.log(sums + 1e-6)
    if g.magnitude:
        return log_mel
    return log_mel @ torch.tensor(dsp.dct_ii_matrix(cfg.num_mel_bins, cfg.num_mfccs))


@pytest.mark.parametrize("source", ["wavs", "dataset rows"])
@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_emulated_kernel_meets_float64(clip, source):
    """The kernel's 3xTF32 order at n = 16000 within ATOL of the float64
    MFCC, on seeded wavs and on dataset rows (loud tones, MFCCs up to
    ~160); one TF32 product a step alone misses the gate, so the split is
    what holds it."""
    cfg, _, _ = _geometry(clip)
    if source == "wavs":
        wavs = torch.tensor(np.random.default_rng(11).uniform(-1, 1, (4, 16000)),
                            dtype=torch.float32)
    else:
        wavs = _dataset_rows(16000)
    want = mfcc_float64(wavs.numpy(), cfg)
    if source == "dataset rows":
        assert np.abs(want).max() > 100
    got = emulate_stage(wavs, cfg).numpy()
    assert got.shape == want.shape == (wavs.shape[0],) + dsp.feature_shape(cfg)[:2]
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    coarse = emulate_stage(wavs, cfg, lambda a, b: _tf32(a) @ _tf32(b)).numpy()
    assert np.abs(coarse - want).max() > ATOL


@pytest.mark.parametrize("method,dsp_dtype", [("mfcc", "float32"),
                                              ("log_mel_spectrogram", "float32"),
                                              ("mfcc", "bfloat16")])
@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_emulated_kernel_matches_the_jax_kernel(clip, method, dsp_dtype):
    """The kernel's order against JAX's _kernel_phases in interpret mode at
    n = 2560 (as test_plain_variant_matches_jax_kernel runs it): ATOL in
    float32, the bf16 tolerance with the bf16 DFT."""
    cfg = dataclasses.replace(_geometry(clip)[0], clip_duration_ms=N // 16,
                              preprocess_method=method, dsp_matmul_dtype=dsp_dtype)
    assert mfcc.resolve_dft_variant(cfg, N) == "phases" and mfcc.fused_mfcc_available(cfg, N)
    wavs = np.random.default_rng(12).uniform(-1, 1, (3, N)).astype(np.float32)
    want = np.asarray(jmfcc.fused_mfcc(jnp.asarray(wavs), to_jax_config(cfg), interpret=True,
                                       variant="phases"))
    got = emulate_stage(torch.tensor(wavs), cfg).numpy()
    assert got.shape == want.shape
    tol = ATOL if dsp_dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, want, rtol=0 if dsp_dtype == "float32" else tol, atol=tol)


@pytest.mark.parametrize("name", ["FeArgs", "FeVariant"])
def test_ctypes_mirror_matches_the_c_struct(name):
    """The ctypes mirror lists the C struct's fields (csrc/frontend.cuh) in
    its order, pointers as pointers: a field moved in one of them keeps the
    struct's size, so the library's size check cannot see it."""
    text = (Path(mfcc.__file__).resolve().parents[2] / "csrc" / "frontend.cuh").read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, text, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        m = re.match(r"\s*(?:const\s+)?\w+\s*(\*?)\s*(.+)", decl.strip())
        if m:
            fields += [(f.strip(), bool(m.group(1))) for f in m.group(2).split(",")]
    mirror = getattr(mfcc, name)._fields_
    assert fields == [(f, t is ctypes.c_void_p) for f, t in mirror]
