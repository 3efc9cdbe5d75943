"""K2's and K3-hops' tensor-core design on the CPU (csrc/dft_tc.cuh: the
frames' stage that k2_mfcc and k3_frontend share with K8): its tile plan
`mfcc.tc_tile_plan` at every geometry K2 serves, a replay of the kernel's
sample staging and A addressing where the hop is no multiple of 32
(400/200: each staged chunk holds the hop rounded up to 32 samples, and the
constant's rows past the hop are zero), an
emulation of its 3xTF32 order held to a float64 MFCC and to the JAX
Pallas kernel `_kernel` (hops) in interpret mode, the route `fused_mfcc`
takes for a CUDA geometry no kernel serves (the JAX package's fallback)
and for a radix4 clip past K9's frames (K2's stage), and that the stage
serves every geometry the FP32 design served."""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu.ops.pallas import mfcc as jmfcc
from tcresnet_tpu_torch.config import AudioConfig, get_preset
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.ops.kernels import mfcc
from tcresnet_tpu_torch.tools.frontend_times import GEOMETRIES, geometry_cfg
from tests.test_torch_config import to_jax_config
from tests.test_torch_dft_variants import _dataset_rows, _tf32, mfcc_float64
from tests.test_torch_k8_tc import emulate_stage, stage_replay
from tests.test_torch_tconv_tc import _split

torch.set_num_threads(1)

ATOL = 1e-4  # the card's K2 gate (tests/test_torch_cuda.py FEATURE_ATOL, the JAX kernel test's)
BF16_TOL = 5e-3  # with dsp_matmul_dtype="bfloat16" (tests/test_torch_cuda.py BF16_TOL)
N = 2560  # the JAX kernel tests' clip (tests/test_pallas.py); 2560 % 200 != 0: no 400/200
CLIPS = [(geometry, 16000) for geometry in GEOMETRIES] + [
    (geometry, N) for geometry in ("480/160", "640/320", "320/160")]


def _clip(geometry: str, n: int):
    """(cfg, geometry, nonzero mel weights) of a 480/160-style label at n samples."""
    cfg = dataclasses.replace(geometry_cfg(geometry), clip_duration_ms=n // 16)
    assert mfcc.resolve_dft_variant(cfg, n) == "hops" and mfcc.fused_mfcc_available(cfg, n)
    g = mfcc.front_end_geometry(cfg, n)
    return cfg, g, mfcc.tc_mel_constants(*dsp.mel_args(cfg))[1].size


@pytest.mark.parametrize("batch", [1, 8, 1536])
@pytest.mark.parametrize("geometry,n", CLIPS)
def test_hops_tile_plan_covers_every_row_and_unit_once(geometry, n, batch):
    """K2 takes K8's plan: tiles of 128 rows at a hop of 160 and 64 rows at
    640/320 and 400/200 (a 128-row tile's span does not fit there) for
    batch 1536, 16 rows for a small batch, its units split until the grid
    reaches every SM; the tiles cover each (utterance, frame) row once and
    the blocks each (tile, column unit) once; `FrontEnd.launch_args` hands
    the kernel this plan."""
    cfg, g, nnz = _clip(geometry, n)
    plan = mfcc.tc_tile_plan(batch, g, nnz)
    total, units = batch * g.frames, mfcc.tc_units(g.fft_length)
    assert plan.smem_bytes <= mfcc.SMEM_LIMIT and units == g.fft_length // 128
    assert plan.rows == (16 if batch < 1536 else 128 if g.hop == 160 else 64)
    assert (plan.tiles - 1) * plan.rows < total <= plan.tiles * plan.rows
    rows = np.bincount(np.arange(total) // plan.rows, minlength=plan.tiles)
    assert rows.sum() == total and (rows[:-1] == plan.rows).all()
    assert units % plan.splits == 0 and plan.grid == plan.tiles * plan.splits
    assert plan.splits == (1 if plan.tiles >= mfcc.SMS else
                           units if plan.tiles * units <= mfcc.SMS else
                           min(d for d in (1, 2, 4, 8) if plan.tiles * d >= mfcc.SMS))
    block = np.arange(plan.grid)  # the kernel's blocks (tc_tile)
    per = units // plan.splits
    unit_of = (block // plan.splits)[:, None] * units + (block % plan.splits * per)[:, None]
    unit_of = unit_of + np.arange(per)
    assert (np.bincount(unit_of.ravel(), minlength=plan.tiles * units) == 1).all()
    fe = mfcc.FrontEnd(cfg, n, "cpu", "hops")
    v, span, smem, part = fe.launch_args(batch)
    assert (v.rows, v.splits, v.stride, v.gap) == (plan.rows, plan.splits, plan.stride, plan.gap)
    assert (span, smem) == (plan.span, plan.smem_bytes)
    assert (part is None) == (plan.splits == 1)
    assert tuple(fe.dft.shape) == (mfcc.tc_kp(g.window, g.hop), 128 * units)


@pytest.mark.parametrize("batch", [1, 8, 1536])
@pytest.mark.parametrize("geometry,n", CLIPS)
def test_staging_and_a_addressing_read_each_frames_samples(geometry, n, batch):
    """For every tile alignment, a replay of tc_stage writes each place of
    the span at most once, and every fragment row (those past the tile
    clamped to its last) reads at K index k, at lr stride + i gap + k + 4 (k
    / hs) (hs = the hop rounded up to 32: no K slice straddles two chunks),
    sample hop (f + k / hs) + k % hs of its own utterance: its frame's
    window sample where the constant's row is live (k % hs < hop), and in
    the chunk's tail past the hop, where the row is zero, a sample that was
    staged (the next chunk's, or a zero past the clip), never a place left
    unwritten. The eight rows of a fragment read distinct 4-bank groups."""
    _, g, nnz = _clip(geometry, n)
    plan = mfcc.tc_tile_plan(batch, g, nnz)
    hs = mfcc.tc_chunk(g.hop)
    assert plan.stride == hs + 4 and plan.stride % 32 == 4 and plan.gap % 32 == 0
    assert (hs > g.hop) == (geometry == "400/200")
    k = np.arange(mfcc.tc_kp(g.window, g.hop))
    koff = k + 4 * (k // hs)
    assert all(k0 // hs == (k0 + 31) // hs for k0 in range(0, k.size, 32))
    live = k % hs < g.hop
    w = mfcc.tc_dft_matrix(g.window, g.hop, g.fft_length)
    assert not w[~live].any() and live.sum() == g.window
    total = batch * g.frames
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
        read = span[base[:, None] + koff]
        t = g.hop * (f[:, None] + k // hs) + k % hs
        np.testing.assert_array_equal(read[:, live], (b[:, None] * g.n + t)[:, live])
        np.testing.assert_array_equal(t[:, live] - g.hop * f[:, None], np.broadcast_to(
            np.arange(g.window), (plan.rows, g.window)))
        np.testing.assert_array_equal(read[:, ~live],
                                      np.where(t < g.n, b[:, None] * g.n + t, -2)[:, ~live])
        for first in range(0, nrows - 7, 8):
            assert len(set(base[first:first + 8] % 32)) == 8
    assert len(seen) >= min(plan.tiles, 2)


@pytest.mark.parametrize("source", ["wavs", "dataset rows"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_emulated_stage_meets_float64(geometry, source):
    """The stage's 3xTF32 order at n = 16000, zero rows and all, within ATOL
    of the float64 MFCC at every geometry K2 serves, on seeded wavs and on
    dataset rows (loud tones, MFCCs up to ~160); one TF32 product a step
    alone misses the gate, so the split is what holds it."""
    cfg, _, _ = _clip(geometry, 16000)
    if source == "wavs":
        wavs = torch.tensor(np.random.default_rng(13).uniform(-1, 1, (4, 16000)),
                            dtype=torch.float32)
    else:
        wavs = _dataset_rows(16000)
    want = mfcc_float64(wavs.numpy(), cfg)
    got = emulate_stage(wavs, cfg).numpy()
    assert got.shape == want.shape == (wavs.shape[0],) + dsp.feature_shape(cfg)[:2]
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    coarse = emulate_stage(wavs, cfg, lambda a, b: _tf32(a) @ _tf32(b)).numpy()
    assert np.abs(coarse - want).max() > ATOL


@pytest.mark.parametrize("method,dsp_dtype", [("mfcc", "float32"),
                                              ("log_mel_spectrogram", "float32"),
                                              ("mfcc", "bfloat16")])
@pytest.mark.parametrize("geometry", ["480/160", "640/320", "320/160"])
def test_emulated_stage_matches_the_jax_hops_kernel(geometry, method, dsp_dtype):
    """The stage's order against JAX's `_kernel` (hops) in interpret mode at
    n = 2560: ATOL in float32, the bf16 tolerance with the bf16 DFT."""
    cfg = dataclasses.replace(_clip(geometry, N)[0], preprocess_method=method,
                              dsp_matmul_dtype=dsp_dtype)
    wavs = np.random.default_rng(14).uniform(-1, 1, (3, N)).astype(np.float32)
    want = np.asarray(jmfcc.fused_mfcc(jnp.asarray(wavs), to_jax_config(cfg), interpret=True,
                                       variant="hops"))
    got = emulate_stage(torch.tensor(wavs), cfg).numpy()
    assert got.shape == want.shape
    tol = ATOL if dsp_dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, want, rtol=0 if dsp_dtype == "float32" else tol, atol=tol)


@pytest.mark.parametrize("method", ["mfcc", "log_mel_spectrogram"])
def test_route_of_a_geometry_no_kernel_serves(method):
    """A 25 ms window at a 10 ms hop (400 % 160 != 0: not hop-decomposable,
    so no kernel serves it) sends a CUDA batch to the plain feature of the
    same method, the JAX package's fallback, within 1e-5 of what JAX's
    `fused_mfcc` returns (and 1e-6 relative: MFCC-0 reaches ~55, where a
    float32 step is 3.8e-6 and the two sum in other orders); every geometry
    K2 serves sends it to the kernel; a CPU batch takes the plain version
    (here, that same feature), and no other device type is served."""
    base = dataclasses.replace(AudioConfig(), preprocess_method=method, clip_duration_ms=N // 16)
    cfg = dataclasses.replace(base, window_size_ms=25.0)
    assert mfcc.fused_mfcc_route(cfg, N, "cuda") == "plain"
    assert mfcc.fused_mfcc_route(cfg, N, "cpu") == "reference"
    for geometry, n in CLIPS:
        served = dataclasses.replace(_clip(geometry, n)[0], preprocess_method=method)
        assert mfcc.fused_mfcc_route(served, n, "cuda") == "kernel"
    with pytest.raises(ValueError, match="no front-end kernel"):
        mfcc.fused_mfcc_route(cfg, N, "meta")
    wavs = np.random.default_rng(15).uniform(-1, 1, (3, N)).astype(np.float32)
    got = mfcc.plain_feature(torch.tensor(wavs), cfg)
    want = np.asarray(jmfcc.fused_mfcc(jnp.asarray(wavs), to_jax_config(cfg)))
    assert got.shape == want.shape == (3,) + dsp.feature_shape(cfg)[:2]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    before = mfcc.plain_routes
    assert torch.equal(mfcc.fused_mfcc(torch.tensor(wavs), cfg), got)
    assert mfcc.plain_routes == before


@pytest.mark.parametrize("method", ["mfcc", "log_mel_spectrogram"])
def test_route_of_a_radix4_clip_past_k9_runs_k2_stage(method):
    """A 2.56 s clip at 480/160 with dft_variant="radix4": hop-decomposable,
    so the JAX package runs its radix4 kernel, but its 254 frames exceed
    K9's largest product. A CUDA batch runs K2's stage (the "hops" kernel,
    `k2_mfcc`, counted in `launches`), chosen from the geometry alone; the
    hops plain version is within the K9 gate of JAX's radix4 kernel; a CPU
    batch still takes the radix4 plain version; a geometry that is not
    hop-decomposable is the one that goes to the plain feature."""
    n = 40960
    cfg = dataclasses.replace(AudioConfig(), preprocess_method=method, dft_variant="radix4",
                              clip_duration_ms=n // 16)
    assert jmfcc.fused_mfcc_available(to_jax_config(cfg), n)
    assert jmfcc.resolve_dft_variant(to_jax_config(cfg), n) == "radix4"
    assert mfcc.resolve_dft_variant(cfg, n) == "radix4"
    assert mfcc.front_end_geometry(cfg, n).frames == 254 > mfcc.R4_PRODUCT_ROWS[-1]
    assert mfcc.radix4_product_rows(254) is None
    assert mfcc.hop_decomposable(cfg, n) and mfcc.fused_mfcc_available(cfg, n)
    assert mfcc.kernel_variant(cfg, n) == "hops"
    assert mfcc.ENTRIES["hops"] == "k2_mfcc" and mfcc._COUNTERS["hops"] == "launches"
    assert mfcc.fused_mfcc_route(cfg, n, "cuda") == "kernel"
    assert mfcc.fused_mfcc_route(cfg, n, "cpu") == "reference"
    # a 1 s clip of the same config stays on K9
    assert mfcc.kernel_variant(dataclasses.replace(cfg, clip_duration_ms=1000), 16000) == "radix4"

    wavs = np.random.default_rng(12).uniform(-1, 1, (2, n)).astype(np.float32)
    want = np.asarray(jmfcc.fused_mfcc(jnp.asarray(wavs), to_jax_config(cfg), interpret=True,
                                       variant="radix4"))
    hops = mfcc.fused_mfcc_reference(torch.tensor(wavs), cfg, "hops").numpy()
    assert hops.shape == want.shape == (2, 254, dsp.feature_width(cfg))
    np.testing.assert_allclose(hops, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(mfcc.fused_mfcc(torch.tensor(wavs), cfg).numpy(),
                                  mfcc.fused_mfcc_reference(torch.tensor(wavs), cfg,
                                                            "radix4").numpy())
    for window_ms, hop_ms, clip in ((25.0, 10.0, n), (30.0, 10.0, 400), (30.0, 10.0, n + 80)):
        other = dataclasses.replace(cfg, window_size_ms=window_ms, window_stride_ms=hop_ms)
        assert not mfcc.hop_decomposable(other, clip)
        assert not jmfcc.fused_mfcc_available(to_jax_config(other), clip)
        assert mfcc.fused_mfcc_route(other, clip, "cuda") == "plain"


def test_hops_and_phases_share_one_front_end():
    """K2 and K8 run one stage through one entry point: their configs get
    one FrontEnd (one upload of the DFT constant, the mel runs and the
    split tiles' counters), whatever cfg's dft_variant; radix4 keeps its
    own, and K4's former FP32 stage has none."""
    cfg = get_preset("TCResNet8-1.0").audio
    hops = mfcc.front_end(dataclasses.replace(cfg, dft_variant="hops"), 16000, "cpu", "hops")
    phases = mfcc.front_end(dataclasses.replace(cfg, dft_variant="phases"), 16000,
                            torch.device("cpu"), "phases")
    assert phases is hops and hops.variant == "hops"
    assert mfcc.front_end(cfg, 16000, "cpu") is hops
    assert mfcc.ENTRIES["hops"] == mfcc.ENTRIES["phases"]
    assert mfcc.front_end(cfg, 16000, "cpu", "radix4") is not hops
    with pytest.raises(ValueError, match="unknown DFT variant"):
        mfcc.front_end(cfg, 16000, "cpu", "fp32")  # K4's former FP32 stage


def _fp32_design_served(cfg: AudioConfig, n: int) -> bool:
    """The FP32 design's rule for hops: hop-decomposable, the common
    conditions, and one utterance's samples and power spectrum within a
    block (frontend.cuh's plan, `FrontEndGeometry.regions`)."""
    window, hop = cfg.window_size_samples, cfg.window_stride_samples
    return (window % hop == 0 and n % hop == 0 and mfcc.front_end_supported(cfg, n)
            and 4 * sum(mfcc.front_end_geometry(cfg, n).regions()) <= mfcc.SMEM_LIMIT)


def test_serves_every_geometry_the_fp32_design_served():
    """Over windows of 2-256 ms, hops of 2-256 ms, 0.16-2 s clips, MFCC and
    log-mel and five filterbanks: the tensor-core stage serves every
    geometry the FP32 design served, and more (its shared memory does not
    grow with the clip); where a 16-row tile's span does not fit a block
    (a 256 ms window at a 128 or 256 ms hop), a tile of fewer rows does."""
    old = new = small = 0
    for window_ms, hop_ms, n, method, (mels, coefs) in itertools.product(
            (2, 4, 10, 16, 20, 25, 30, 32, 40, 50, 64, 128, 256),
            (2, 4, 5, 8, 10, 12.5, 16, 20, 25, 32, 64, 128, 256), (2560, 16000, 16384, 32000),
            ("mfcc", "log_mel_spectrogram"), ((40, 10), (40, 40), (64, 40), (80, 13), (128, 64))):
        cfg = AudioConfig(window_size_ms=window_ms, window_stride_ms=hop_ms, num_mel_bins=mels,
                          num_mfccs=coefs, preprocess_method=method, clip_duration_ms=n // 16)
        served = mfcc.fused_mfcc_available(cfg, n)
        if _fp32_design_served(cfg, n):
            old += 1
            assert served, (window_ms, hop_ms, n, method, mels, coefs)
        if served:
            new += 1
            nnz = mfcc.tc_mel_constants(*dsp.mel_args(cfg))[1].size
            small += mfcc.tc_tile_plan(1, mfcc.front_end_geometry(cfg, n), nnz).rows < 16
    assert old > 500 and new > old and small > 0


# ---- the 128-row product (csrc/dft_wgmma.cuh) ----

WG_BATCHES = [1, 8, 171, 172, 1536, 8192]


@pytest.mark.parametrize("batch", WG_BATCHES)
@pytest.mark.parametrize("variant", ["hops", "phases"])
@pytest.mark.parametrize("geometry", ["480/160", "640/320", "400/200", "320/160"])
def test_wgmma_product_takes_the_128_row_tiles(geometry, variant, batch):
    """The plan's rule picks the wgmma product: 128-row tiles wherever its
    plan fits a block (a hop of 160: 480/160 and 320/160, 12 and 13 ring
    slots; 640/320's and 400/200's sample spans leave room for fewer than
    ten)
    and the batch's frames fill every SM at least once (480/160 from 172
    clips: 172 x 98 frames are 132 tiles); the other products keep their
    tiles and no ring. hops and phases share the plan and the FrontEnd,
    whose launch hands the kernel the split constant and the slots."""
    cfg = dataclasses.replace(geometry_cfg(geometry, "hops"), dft_variant=variant)
    if variant == "phases" and mfcc.resolve_dft_variant(cfg, 16000) != "phases":
        pytest.skip("no phase plan at this geometry")
    g = mfcc.front_end_geometry(cfg, 16000)
    nnz = mfcc.tc_mel_constants(*dsp.mel_args(cfg))[1].size
    plan = mfcc.tc_tile_plan(batch, g, nnz)
    fits = g.hop == 160
    assert (mfcc.smem_bytes(g, "hops", nnz, 128) <= mfcc.SMEM_LIMIT) == fits
    wgmma = fits and -(-batch * g.frames // 128) >= mfcc.SMS
    assert (plan.rows == 128) == wgmma and plan.smem_bytes <= mfcc.SMEM_LIMIT
    assert plan.stages == ((13 if geometry == "320/160" else 12) if wgmma else 0)
    if wgmma:
        assert plan.splits == 1 and plan.smem_bytes == 4 * sum(mfcc.tc_wg_plan(g, nnz).values())
    if geometry == "480/160":
        assert (plan.rows == 128) == (batch >= 172)
    fe = mfcc.front_end(cfg, 16000, "cpu", mfcc.kernel_variant(cfg, 16000))
    assert fe is mfcc.front_end(cfg, 16000, "cpu", "hops")
    v, span, smem, _ = fe.launch_args(batch)
    assert (v.rows, v.stages, span, smem) == (plan.rows, plan.stages, plan.span, plan.smem_bytes)
    assert v.wsplit == fe.dft_split.data_ptr() and v.w == fe.dft.data_ptr()


@pytest.mark.parametrize("batch", [172, 173, 1536, 8191])
@pytest.mark.parametrize("geometry", ["480/160", "320/160"])
def test_wgmma_ragged_last_tile(geometry, batch):
    """The last tile of a batch whose frames are no multiple of 128 holds
    the remainder: its consumer threads' fragment rows (warp 16 + g and + 8
    over warps 0-7) cover the tile's 128 rows once, rows past the tile read
    its last row's samples (the span is staged there) and store nothing;
    the mel's threads (bands warp + 8 j, rows lane + 32 i) cover each (band,
    row) of the tile once; every tile's rows end within the span and the
    grid covers the batch's rows once."""
    _, g, nnz = _clip(geometry, 16000)
    plan = mfcc.tc_tile_plan(batch, g, nnz)
    assert plan.rows == 128
    total = batch * g.frames
    last = total - (plan.tiles - 1) * 128
    assert 0 < last <= 128 and (last < 128) == (total % 128 != 0)
    warp, lane = np.divmod(np.arange(256), 32)
    frag = (warp * 16 + lane // 4)[:, None] + np.array([0, 8])
    assert np.array_equal(np.bincount(frag.ravel()), np.full(128, 4))  # 4 lanes (t) a row
    span, r0, nrows, b0 = stage_replay(plan, g, batch, plan.tiles - 1)
    assert nrows == last and r0 == total - last
    lr = np.minimum(frag, nrows - 1)
    b = (r0 + lr) // g.frames
    base = lr * plan.stride + (b - b0) * plan.gap
    k = np.arange(mfcc.tc_kp(g.window, g.hop))
    assert (span[base[..., None] + k + 4 * (k // mfcc.tc_chunk(g.hop))] >= 0).all()
    stored = frag[frag < nrows]
    assert np.array_equal(np.unique(stored), np.arange(nrows))
    band, row = np.meshgrid(np.arange(mfcc.WG_MAX_MEL), np.arange(128), indexing="ij")
    owner = (band % 8) * 32 + row % 32  # the consumer thread: warp band % 8, lane row % 32
    slot = (band // 8) * 4 + row // 32  # its register mel[band // 8][row // 32]
    assert len(set(zip(owner.ravel(), slot.ravel()))) == band.size
    assert g.num_mel <= mfcc.WG_MAX_MEL and g.num_mel * nrows <= 128 * mfcc.TC_SP


@pytest.mark.parametrize("dsp_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geometry", ["480/160", "640/320", "400/200"])
def test_wgmma_constant_is_split_once_on_the_host(geometry, dsp_dtype):
    """The split constant (`tc_dft_split`): hi and lo are TF32 values, the
    device's split_tf32_rn bit for bit (the CPU emulation's `_split`), hi +
    lo within 2^-21 of each float32 element of the constant the FrontEnd
    holds (zero lo with the bf16 DFT), each ring slot the [128 columns, 32
    K] transpose of one K slice of one unit, hi then lo, in the 128-byte
    swizzle (16-byte chunk c of column n at c ^ (n % 8))."""
    cfg = dataclasses.replace(_clip(geometry, 16000)[0], dsp_matmul_dtype=dsp_dtype)
    fe = mfcc.FrontEnd(cfg, 16000, "cpu", "hops")
    w = fe.dft.numpy()
    hi, lo = mfcc.tf32_split_rn(w)
    assert not (hi.view(np.uint32) & 0x1fff).any() and not (lo.view(np.uint32) & 0x1fff).any()
    ehi, elo = _split(torch.tensor(w))
    np.testing.assert_array_equal(hi, ehi.float().numpy())
    np.testing.assert_array_equal(lo, elo.float().numpy())
    err = np.abs(hi.astype(np.float64) + lo - w)
    assert (err <= 2.0 ** -21 * np.abs(w)).all()
    if dsp_dtype == "bfloat16":
        assert not lo.any() and np.array_equal(hi, w)
    kp, cols = w.shape
    split = fe.dft_split.numpy().reshape(cols // 128, kp // 32, 2, 128, 8, 4)
    n = np.arange(128)[:, None]
    chunk = np.arange(8)[None, :] ^ (n % 8)  # where chunk c of column n was put
    for u, s in ((0, 0), (cols // 128 - 1, kp // 32 - 1), (1, 3)):
        for part, m in enumerate((hi, lo)):
            block = m[32 * s:32 * s + 32, 128 * u:128 * u + 128].T.reshape(128, 8, 4)
            np.testing.assert_array_equal(split[u, s, part][n, chunk], block)


def test_wgmma_launches_have_a_counter_of_their_own():
    """`mfcc.wgmma_launches` is registered in COUNTERS as "dft_wgmma" and
    counts a launch of the frames' stage only where its plan took the
    128-row product."""
    from tcresnet_tpu_torch.ops import kernels

    assert kernels.COUNTERS["dft_wgmma"] == ("mfcc", "wgmma_launches")
    before = kernels.launch_counts()
    v = mfcc.FeVariant()
    for rows in (16, 64, 128, 128):
        v.rows = rows
        mfcc.count_wgmma(v)
    assert kernels.launches_since(before) == {"dft_wgmma": 2}
    kernels.reset_launch_counts()
    assert mfcc.wgmma_launches == 0
