"""Fused MFCC / log-mel front end: wav [B, n] -> features [B, frames, C].

Counterpart of tcresnet_tpu/ops/pallas/mfcc.py, whose `dft_variant` picks
the DFT decomposition of one kernel; here each variant is a kernel of
`csrc/mfcc.cu`:

  "hops"    K2  `_kernel`: the hop-decomposed DFT, [hop, k 2K] pieces of
                the windowed DFT summed over a frame's hops; on the card
                every frame's full-window product with the windowed DFT
  "phases"  K8  `_kernel_phases`: frames grouped by phase f mod P, one
                product per phase of a strided lane-row view of the
                utterance against W_p (`phase_dft_plan`); on the card every
                frame's product over the live rows of W_p, which are the
                windowed DFT: K2's product
  "radix4"  K9  `_kernel_radix4`: the radix-4 DIF factored rDFT (window,
                butterfly, three stage-2 products, branch-permuted power
                and mel; `dsp.radix4_dft_matrices`), on the tensor cores

K2 and K8 run one stage on the tensor cores, `csrc/dft_tc.cuh` (every
frame of a tile of the batch's frames one 3xTF32 product, the
tensor-core pieces K9 shares), through one entry point and one
`FrontEnd`; K9 `csrc/radix4.cuh`, each also K3's stage
of the variant; K4 (`infer.cu`, always "hops" as in JAX) runs K2's stage
too, with the hops `FrontEnd` and `tc_tile_plan`. The source notes say
what bounds each on the H100. This module:

- resolves a config's variant as the JAX package does
  (`resolve_dft_variant`, with its fallback to "hops" where a geometry
  does not allow the variant). The availability rules are the TPU
  kernel's (lane alignment, the radix-4 lookahead guard); they are kept so
  that a config selects the variant JAX selects;
- lays each variant's constants out for the kernels and keeps them on the
  device, once per (audio config, clip length, device, variant)
  (`front_end` -> `FrontEnd`, the ctypes mirrors of `FeArgs` and
  `FeVariant`; the tensor-core DFT constant `tc_dft_matrix`; the mel runs:
  `tc_mel_constants`, `radix4_kernel_constants`, with K9's live columns
  and rows), with each
  kernel's shared-memory plan (`smem_plan`) and K2's and K8's tiles of the
  batch's frames (`tc_tile_plan`, the staged samples' `tc_layout`);
- holds the plain PyTorch versions (`fused_mfcc_reference`): the port's
  dense front end for "hops", the radix-4 path of `ops/dsp.py` for
  "radix4", and `phases_reim`, the per-phase products of
  `mfcc_tail_phases`, for "phases";
- dispatches (`fused_mfcc`, by `fused_mfcc_route`): a CPU tensor goes to
  the plain version, a CUDA tensor to the kernel of `kernel_variant` (the
  resolved variant's; K2's stage for a radix4 clip past K9's frames), or
  where the geometry cannot be split into hops to the plain feature of the
  same method, as the JAX package falls back; anything else raises.

`launches`, `phases_launches` and `radix4_launches` count launches by the
stage that ran (K2, K8, K9) and nothing else; `plain_routes` counts CUDA
batches sent to the plain feature; `wgmma_launches` the launches of K2, K8,
K3 and K4 whose tile plan took the 128-row product (`count_wgmma`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch

from tcresnet_tpu_torch.config import AudioConfig
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.ops.kernels import _build

# Kernel launches since import (or since a caller reset them to 0).
launches = 0  # K2, "hops"
phases_launches = 0  # K8
radix4_launches = 0  # K9
plain_routes = 0  # CUDA batches the JAX package too sends to the plain feature
# launches of K2, K8, K3 (hops, phases) and K4 that ran the 128-row
# product (csrc/dft_wgmma.cuh), whichever kernel took it
wgmma_launches = 0

SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
SMS = 132  # the H100 SXM's streaming multiprocessors
LANES = 128  # the TPU lane width the phase plan and the radix-4 rules are stated in
# The tensor-core products of K2, K8 and K9 (csrc/dft_tc.cuh): K slices of
# TC_BK rows of the DFT constant through a ring of TC_STAGES; units of TC_BN
# columns, TC_BN / 2 (re, im) pairs; the slice's and the power tile's row
# strides
TC_BK, TC_BN, TC_STAGES = 32, 128, 3
TC_PAIRS = TC_BN // 2
TC_SB, TC_SP = TC_BN + 8, TC_PAIRS + 1
# K9 (csrc/radix4.cuh): its A slice's row stride; frames up to 64 take a
# 64-row product, up to 112 a 112-row one
R4_SA = TC_BK + 4
R4_PRODUCT_ROWS = (64, 112)
# K2 and K8: the rows a block's tile may have, largest first (128 and 64
# each a product of their own; 16 and fewer the 16-row product, the only
# one whose column units split over blocks: dft_tc.cuh::tc_product)
TC_TILE_ROWS = (128, 64, 16, 8, 4, 2, 1)
TC_SPLIT_ROWS = 16
TC_PAD = 4  # floats between K2's and K8's staged chunks
# The 128-row product (csrc/dft_wgmma.cuh): its tile's rows, a ring slot (one
# K slice's hi or lo part of the constant for half a unit, [TC_BN / 2,
# TC_BK]), the mel bands its consumers sum in registers, and the slots its
# ring may have: at least WG_MIN_STAGES (80 KB: a half slice's two parts in
# use, eight more in flight), else the tile does not fit and the plan takes
# 64 rows
WG_ROWS = 128
WG_SLOT = TC_BK * TC_BN // 2
WG_MAX_MEL = 64
WG_MIN_STAGES, WG_MAX_STAGES = 10, 16
VARIANTS = ("hops", "phases", "radix4")
ENTRIES = {"hops": "k2_mfcc", "phases": "k2_mfcc", "radix4": "k9_mfcc"}  # K8 runs K2's stage
_COUNTERS = {"hops": "launches", "phases": "phases_launches", "radix4": "radix4_launches"}

# "auto" (dsp_backend, frontend_fuse) takes the front-end kernels from this
# batch on: the JAX package's threshold, measured on a TPU. The H100
# crossover is in PERF.md; changing the threshold is a later change.
AUTO_MIN_BATCH = 2048


# ---------------------------------------------------------------------------
# variant planning (the JAX package's rules)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def phase_dft_plan(window: int, hop: int, n: int, fft_length: int) -> tuple:
    """Static plan of the phase-grouped windowed DFT over the lane-major
    [n / 128, 128] sample layout (JAX `phase_dft_plan`).

    Frames are grouped by phase p = f mod P, P = lcm(hop, 128) / hop:
    every frame of a phase starts at the same offset o_p inside a 128-sample
    row, so its window covers rows_p consecutive rows and the DFT is one
    product per phase, reim_p[q] = x[(S q + c_p) * 128 : ... + rows_p * 128]
    @ W_p with W_p[o_p : o_p + window] = the windowed DFT (other rows zero),
    S = lcm / 128 rows per superblock; output row q is frame P q + p.

    Returns (P, S, nsb, frames, phases), phases a tuple of
    (c_p, rows_p, frames_p, W_p [rows_p * 128, 2K] float32). Raises
    ValueError for a geometry the plan does not cover."""
    if n % LANES:
        raise ValueError(f"clip length {n} not lane-aligned")
    lcm = hop * LANES // math.gcd(hop, LANES)
    if n % lcm:
        raise ValueError(f"clip length {n} not divisible by lcm {lcm}")
    num_p = lcm // hop
    s_rows = lcm // LANES
    nsb = n // lcm
    frames = 1 + (n - window) // hop
    num_bins = fft_length // 2 + 1
    dft = dsp.windowed_rdft_matrix(window, fft_length)
    phases = []
    for p in range(num_p):
        c, o = divmod(hop * p, LANES)
        rows_p = -(-(o + window) // LANES)
        frames_p = max(0, -(-(frames - p) // num_p))
        w = np.zeros((rows_p * LANES, 2 * num_bins), np.float32)
        w[o:o + window] = dft
        if s_rows * (frames_p - 1) + c + rows_p > s_rows * nsb:
            raise ValueError(f"phase {p} would read past the signal "
                             f"(window {window}, hop {hop}, n {n})")
        w.setflags(write=False)
        phases.append((c, rows_p, frames_p, w))
    return num_p, s_rows, nsb, frames, tuple(phases)


def phase_dft_available(cfg: AudioConfig, n: int) -> bool:
    """Whether the phase-grouped DFT applies to a clip of n samples (JAX
    `phase_dft_available`): a spectral feature, n >= window, and a
    geometry `phase_dft_plan` covers."""
    if (cfg.preprocess_method not in ("mfcc", "log_mel_spectrogram")
            or n < cfg.window_size_samples):
        return False
    try:
        phase_dft_plan(cfg.window_size_samples, cfg.window_stride_samples, n,
                       dsp.fft_length_for(cfg.window_size_samples))
    except ValueError:
        return False
    return True


def radix4_kernel_available(cfg: AudioConfig, n: int) -> bool:
    """The JAX radix-4 kernel's rule (`radix4_kernel_available`) for a clip
    of n samples: butterfly blocks of a multiple of 128 samples (fft / 4),
    a lane-aligned clip, and window <= lcm(hop, 128) + hop (its
    one-superblock lookahead guard)."""
    window, hop = cfg.window_size_samples, cfg.window_stride_samples
    fft_length = dsp.fft_length_for(window)
    lcm = hop * LANES // math.gcd(hop, LANES)
    return (fft_length % 4 == 0 and (fft_length // 4) % LANES == 0 and n % LANES == 0
            and window <= lcm + hop)


def resolve_dft_variant(cfg: AudioConfig, n: int) -> str:
    """cfg.dft_variant for a clip of n samples, as the JAX package resolves
    it: "auto" is "hops" (the JAX package's rule, measured on a TPU; the
    H100's winner is in PERF.md), and "phases" or "radix4" fall back to
    "hops" where the geometry does not allow them. Unknown values raise."""
    variant = getattr(cfg, "dft_variant", "auto")
    if variant not in ("auto", *VARIANTS):
        raise ValueError(
            f"dft_variant must be 'auto', 'hops', 'phases', or 'radix4'; got {variant!r}")
    if variant == "auto":
        variant = "hops"
    if variant == "radix4" and not radix4_kernel_available(cfg, n):
        variant = "hops"
    if variant == "phases" and not phase_dft_available(cfg, n):
        variant = "hops"
    return variant


# ---------------------------------------------------------------------------
# constants and shared-memory plan of the kernels
# ---------------------------------------------------------------------------


def tc_dft_matrix(window: int, hop: int, fft_length: int) -> np.ndarray:
    """K2's and K8's constant (csrc/dft_tc.cuh): [Kp, 128 units] in the
    staged chunks' K order (`tc_kp`): the window's rows a chunk of hop at a
    time, each chunk's `tc_chunk(hop)` rows ending in zero rows; units
    `tc_units`: the first 64 units bins' (re_k, im_k) columns interleaved,
    a unit's 64 pairs (up to fft / 2; the Nyquist bin is left out), columns
    past the bins zero."""
    m = dsp.windowed_rdft_matrix(window, fft_length)  # [window, (re | im) of each bin]
    half, hs = fft_length // 2, tc_chunk(hop)
    out = np.zeros((window // hop, hs, TC_BN * tc_units(fft_length)), np.float32)
    out[:, :hop, 0:2 * half:2] = m[:, :half].reshape(window // hop, hop, half)
    out[:, :hop, 1:2 * half:2] = m[:, half + 1:2 * half + 1].reshape(window // hop, hop, half)
    return out.reshape(window // hop * hs, -1)


def tf32_split_rn(x: np.ndarray) -> tuple:
    """(hi, lo) float32 with x = hi + lo up to lo's rounding: csrc/
    async_mma.cuh::split_tf32_rn on the host, bit for bit. hi is x rounded
    to the nearest TF32 value (ties away from zero: the bits plus half a
    TF32 ulp, the low 13 cleared), lo = x - hi (exact) rounded the same
    way."""
    x = np.ascontiguousarray(x, np.float32)

    def rn(v):
        return ((v.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)

    hi = rn(x)
    return hi, rn(x - hi)


def tc_dft_split(dft: np.ndarray) -> np.ndarray:
    """The 128-row product's constant (csrc/dft_wgmma.cuh): `dft` [Kp, 128
    units] (`tc_dft_matrix`, rounded as the FrontEnd holds it) split into
    TF32 hi and lo parts (`tf32_split_rn`), flat, in the order the producer
    streams it: unit by unit, K slice by K slice, the hi part then the lo
    part, each [128 columns, 32 K] K-major (wgmma's tf32 operand) in the
    128-byte swizzle (16-byte chunk c of column n at chunk c ^ (n % 8))."""
    kp, cols = dft.shape
    hi, lo = tf32_split_rn(dft)
    n = np.arange(TC_BN)[:, None]
    k = np.arange(TC_BK)[None, :]
    place = n * TC_BK + ((k // 4) ^ (n % 8)) * 4 + k % 4
    out = np.empty((cols // TC_BN, kp // TC_BK, 2, TC_BN * TC_BK), np.float32)
    for u in range(cols // TC_BN):
        for s in range(kp // TC_BK):
            for part, m in enumerate((hi, lo)):
                block = m[s * TC_BK:(s + 1) * TC_BK, u * TC_BN:(u + 1) * TC_BN].T
                out[u, s, part, place] = block
    return out.ravel()


def tc_chunk(hop: int) -> int:
    """Samples a staged chunk of K2's and K8's holds, and K rows it spans:
    the hop in whole K slices."""
    return -(-hop // TC_BK) * TC_BK


def tc_kp(window: int, hop: int) -> int:
    """K rows of K2's and K8's product: the window's window / hop chunks of
    `tc_chunk(hop)` rows (the window itself where the hop is a multiple of
    32)."""
    return window // hop * tc_chunk(hop)


def tc_units(fft_length: int) -> int:
    """Column units of K2's and K8's product: the fft / 2 bins below the
    Nyquist bin, 64 a unit, at least one."""
    return max(1, fft_length // TC_BN)


class FeArgs(ctypes.Structure):
    """Mirror of struct FeArgs in csrc/frontend.cuh."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("dft", "mel", "dct")]
        + [(f, ctypes.c_int) for f in (
            "n", "window", "hop", "frames", "num_mel", "num_coef", "magnitude",
            "round_bf16")]
    )


class FeVariant(ctypes.Structure):
    """Mirror of struct FeVariant in csrc/frontend.cuh: the constants of the
    tensor-core DFT stages, K2 and K8 (hops, phases) and K9 (radix4)."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("w", "win", "runs", "part", "done", "wsplit")]
        + [(f, ctypes.c_int) for f in (
            "length", "mel_nnz", "units", "rows", "splits", "stride", "gap", "stages")]
    )


@dataclasses.dataclass(frozen=True)
class FrontEndGeometry:
    n: int
    window: int
    hop: int
    frames: int
    num_bins: int
    ncg: int  # DFT column groups of 4: (re_k, im_k, re_k+1, im_k+1)
    num_mel: int
    width: int  # feature coefficients per frame
    magnitude: bool

    @property
    def fft_length(self) -> int:
        return 2 * (self.num_bins - 1)

    def regions(self, region_a_floats: int = 0) -> tuple:
        """(region A floats, region B floats) of the shared-memory plan of
        K4's former FP32 front end (one utterance's samples, then its power
        spectrum, in one block); A at least `region_a_floats`, B 16-byte
        aligned. No kernel runs that stage now: the rule is kept as the
        record of what it served, which the tensor-core stage and K4 must
        still serve (tests/test_torch_hops_tc.py, test_torch_infer_tc.py)."""
        a = max(self.n, self.frames * self.num_mel, region_a_floats)
        return a + (-a % 4), self.frames * 2 * self.ncg


def front_end_geometry(cfg: AudioConfig, n: int) -> FrontEndGeometry:
    window, hop = cfg.window_size_samples, cfg.window_stride_samples
    num_bins = dsp.fft_length_for(window) // 2 + 1
    return FrontEndGeometry(
        n, window, hop, dsp.num_frames_for(n, window, hop), num_bins,
        -(-num_bins // 2), cfg.num_mel_bins, dsp.feature_width(cfg),
        cfg.preprocess_method == "log_mel_spectrogram",
    )


def radix4_product_rows(frames: int) -> Optional[int]:
    """Rows of K9's product for `frames` frames: the smallest of
    R4_PRODUCT_ROWS that holds them, None past the largest."""
    return next((rows for rows in R4_PRODUCT_ROWS if frames <= rows), None)


@functools.lru_cache(maxsize=None)
def radix4_kernel_constants(num_mel_bins: int, fft_length: int, sample_rate: int,
                            lower_edge_hertz: float, upper_edge_hertz: float) -> tuple:
    """K9's constants (csrc/radix4.cuh), L = fft_length / 4:

      w       [6 L^2] the live columns of M0, M1, M2 (`dsp.radix4_dft_matrices`)
              as (re, im) pairs, row-major, back to back: M0's and M2's
              k2 < L/2 ([L, L] each), all of M1 ([2L, 2L]); the kernel's
              2L power rows are the rows of `dsp.radix4_mel_matrix` for
              those pairs, in their order (`radix4_kernel_rows`), 64 a unit
      runs    [units, M, 3] int32: per unit and mel band, the [first, end)
              rows of the unit with nonzero weight ((0, 0) if none) and
              where their weights start in `vals`
      vals    [nonzero weights] float32: each run's weights, in runs' order

    The rows left out are dead (zero mel rows: M0's k2 > L/2, M2's k2 >=
    L/2) or M0's k2 = L/2, the Nyquist bin, whose mel weight is zero when
    the upper edge is at most the Nyquist frequency; a nonzero weight on a
    row left out raises ValueError."""
    length = fft_length // 4
    m0, m1, m2 = dsp.radix4_dft_matrices(fft_length)

    def pairs(m, count):  # the first `count` (re, im) columns, interleaved
        re, im = m[:, :count], m[:, length:length + count]
        return np.stack([re, im], axis=-1).reshape(m.shape[0], 2 * count)

    w = np.concatenate([pairs(m0, length // 2).ravel(), pairs(m1, length).ravel(),
                        pairs(m2, length // 2).ravel()])
    mel = dsp.radix4_mel_matrix(num_mel_bins, fft_length, sample_rate, lower_edge_hertz,
                                upper_edge_hertz)
    rows = radix4_kernel_rows(fft_length)
    if np.delete(mel, rows, axis=0).any():
        raise ValueError(f"a radix-4 power row K9 leaves out has mel weight (fft {fft_length}, "
                         f"upper edge {upper_edge_hertz} Hz)")
    w.setflags(write=False)
    return (w, *mel_runs(mel[rows]))


def mel_runs(kmel: np.ndarray) -> tuple:
    """The mel [rows, M] of a kernel's power rows, 64 rows (one unit of
    TC_BN columns) at a time, as (runs [units, M, 3] int32, vals): per unit
    and band the [first, end) rows of nonzero weight ((0, 0) if none) and
    where their weights start in `vals`, the nonzero weights in runs' order
    (csrc/dft_tc.cuh::tc_mel)."""
    units = kmel.shape[0] // TC_PAIRS
    runs = np.zeros((units, kmel.shape[1], 3), np.int32)
    vals, offset = [], 0
    for u in range(units):
        for m in range(kmel.shape[1]):
            col = kmel[u * TC_PAIRS:(u + 1) * TC_PAIRS, m]
            nz = np.flatnonzero(col)
            first, end = (nz[0], nz[-1] + 1) if nz.size else (0, 0)
            runs[u, m] = first, end, offset
            vals.append(col[first:end])
            offset += end - first
    vals = np.concatenate(vals).astype(np.float32)
    for a in (runs, vals):
        a.setflags(write=False)
    return runs, vals


@functools.lru_cache(maxsize=None)
def tc_mel_constants(num_mel_bins: int, num_bins: int, sample_rate: int,
                     lower_edge_hertz: float, upper_edge_hertz: float) -> tuple:
    """K2's and K8's mel runs and nonzero weights (`mel_runs`) over their
    power rows, the first fft / 2 bins in units of 64 (`tc_units`; rows past
    the bins carry no weight), in `dsp.mel_args` order of arguments. The
    Nyquist bin, which they leave out, must carry no mel weight (it does
    not where the upper edge is at most the Nyquist frequency); ValueError
    otherwise."""
    mel = dsp.linear_to_mel_weight_matrix(num_mel_bins, num_bins, sample_rate,
                                          lower_edge_hertz, upper_edge_hertz)
    half = num_bins - 1
    if mel[half:].any():
        raise ValueError(f"the Nyquist bin K2 and K8 leave out has mel weight (upper edge "
                         f"{upper_edge_hertz} Hz)")
    kmel = np.zeros((TC_PAIRS * tc_units(2 * half), num_mel_bins), np.float32)
    kmel[:half] = mel[:half]
    return mel_runs(kmel)


def radix4_kernel_rows(fft_length: int) -> np.ndarray:
    """The rows of `dsp.radix4_mel_matrix` (the branch-permuted power) that
    K9's 2L power rows are, in order: branch 0's k2 < L/2, all of branch
    1, branch 2's k2 < L/2."""
    length = fft_length // 4
    return np.concatenate([np.arange(length // 2), length + np.arange(length),
                           2 * length + np.arange(length // 2)])


def _up4(x: int) -> int:
    return x + (-x % 4)


def tc_layout(g: FrontEndGeometry) -> tuple:
    """(stride, gap) of K2's and K8's staged samples (csrc/dft_tc.cuh):
    chunks of `tc_chunk(hop)` samples, one every hop, `stride` = that + 4
    floats apart (stride / 4 odd: the rows of a fragment read distinct
    banks), and between the utterances of a tile a `gap` beyond their rows'
    chunks, the multiple of 32 that holds a frame's window / hop - 1 tail
    chunks."""
    stride = tc_chunk(g.hop) + TC_PAD
    return stride, -(-(g.window // g.hop - 1) * stride // 32) * 32


def tc_wg_plan(g: FrontEndGeometry, nnz: int) -> Optional[Dict[str, int]]:
    """The 128-row product's shared memory (csrc/dft_wgmma.cuh), in floats,
    in order: the tile's "samples" (`tc_layout`), the mel's "runs" and
    "vals", the "power" tile (the mel sums at the end), up to 1024 bytes to
    "align" the "ring" of `stages` slots (as many as fit, at most
    WG_MAX_STAGES; WG_MIN_STAGES where fewer fit, so that the plan exceeds
    a block), and its full and empty "barriers". None past WG_MAX_MEL mel
    bands."""
    if g.num_mel > WG_MAX_MEL:
        return None
    stride, gap = tc_layout(g)
    pieces = 2 + (WG_ROWS - 2) // g.frames
    plan = {"samples": (WG_ROWS + g.window // g.hop - 1) * stride + (pieces - 1) * gap,
            "runs": _up4(tc_units(g.fft_length) * g.num_mel * 3), "vals": _up4(nnz),
            "power": _up4(WG_ROWS * TC_SP), "align": 256}
    free = SMEM_LIMIT // 4 - sum(plan.values())
    stages = max(WG_MIN_STAGES, min(WG_MAX_STAGES, free // (WG_SLOT + 4)))
    return {**plan, "ring": stages * WG_SLOT, "barriers": 4 * stages}


def smem_plan(g: FrontEndGeometry, variant: str, nnz: int = 0,
              rows: int = 0) -> Optional[Dict[str, int]]:
    """The regions of the variant's shared-memory plan, in floats, in their
    order, each but the last a multiple of 4 floats. hops and phases at 128
    rows: `tc_wg_plan`; at fewer (one stage, dft_tc.cuh, for a tile of
    `rows` rows) and radix4 (radix4.cuh):
    the "samples" (hops and phases: the tile's sample span in `tc_layout`,
    its rows touching at most 2 + (rows - 2) // frames utterances),
    radix4's "window" (4L), the mel's "runs" and its `nnz` nonzero weights,
    "vals" (`tc_mel_constants`,
    `radix4_kernel_constants`), the "ring" (TC_STAGES slices of the
    constant, [TC_BK, TC_SB]), radix4's "stage" (two A slices, [rows,
    R4_SA]), the "power" tile of a unit ([rows, TC_SP]) and the "mel" sums
    ([num_mel, rows]); radix4's rows are its product's, and the plan None
    where the frames exceed the largest product."""
    if variant in ("hops", "phases") and rows == WG_ROWS:
        return tc_wg_plan(g, nnz)
    if variant in ("hops", "phases"):
        stride, gap = tc_layout(g)
        pieces = 2 + (rows - 2) // g.frames
        return {"samples": (rows + g.window // g.hop - 1) * stride + (pieces - 1) * gap,
                "runs": _up4(tc_units(g.fft_length) * g.num_mel * 3), "vals": _up4(nnz),
                "ring": TC_STAGES * TC_BK * TC_SB, "power": _up4(rows * TC_SP),
                "mel": rows * g.num_mel}
    units = g.fft_length // TC_BN
    rows = radix4_product_rows(g.frames)
    if rows is None:
        return None
    length = g.fft_length // 4
    return {"samples": _up4(g.n), "window": 4 * length,
            "runs": _up4(units * g.num_mel * 3), "vals": _up4(nnz),
            "ring": TC_STAGES * TC_BK * TC_SB, "stage": 2 * rows * R4_SA,
            "power": _up4(g.frames * TC_SP), "mel": g.frames * g.num_mel}


def smem_bytes(g: FrontEndGeometry, variant: str, nnz: int = 0, rows: int = 0) -> int:
    """Bytes of `smem_plan`; SMEM_LIMIT + 1 (no block holds it) where the
    variant has no plan for these rows."""
    plan = smem_plan(g, variant, nnz, rows)
    return SMEM_LIMIT + 1 if plan is None else 4 * sum(plan.values())


@dataclasses.dataclass(frozen=True)
class TcPlan:
    """K2's and K8's launch for one batch: `tiles` tiles of `rows`
    consecutive (utterance, frame) rows of the batch x frames row space,
    each tile's column units split over `splits` blocks (grid tiles x
    splits); a block stages its rows' samples in `span` floats
    (`tc_layout`: chunks `stride` apart, utterances a further `gap`). At
    128 rows the product is csrc/dft_wgmma.cuh's, with `stages` ring slots
    (0 for the others)."""

    rows: int
    tiles: int
    splits: int
    stride: int
    gap: int
    span: int
    smem_bytes: int
    stages: int = 0

    @property
    def grid(self) -> int:
        return self.tiles * self.splits


@functools.lru_cache(maxsize=64)
def tc_tile_plan(batch: int, g: FrontEndGeometry, nnz: int) -> Optional[TcPlan]:
    """K2's and K8's tiles for `batch` clips of geometry g (`nnz` nonzero
    mel weights): the largest of TC_TILE_ROWS whose plan fits a block and
    whose tiles fill every SM at least once, else the largest of at most
    TC_SPLIT_ROWS rows that fits (16 unless a long window's span does not
    fit), its column units then split over the fewest blocks (a divisor of
    the units) that bring the grid to every SM, or over all of them: a
    small batch spreads its frames and columns over many blocks. None if
    no tile fits."""
    total = batch * g.frames
    rows = next((r for r in TC_TILE_ROWS
                 if smem_bytes(g, "hops", nnz, r) <= SMEM_LIMIT
                 and (-(-total // r) >= SMS or r <= TC_SPLIT_ROWS)), None)
    if rows is None:
        return None
    tiles = -(-total // rows)
    units = tc_units(g.fft_length)
    splits = 1 if tiles >= SMS else next(
        (d for d in range(1, units + 1) if units % d == 0 and tiles * d >= SMS), units)
    plan = smem_plan(g, "hops", nnz, rows)
    return TcPlan(rows, tiles, splits, *tc_layout(g), plan["samples"], 4 * sum(plan.values()),
                  plan["ring"] // WG_SLOT if rows == WG_ROWS else 0)


def front_end_supported(cfg: AudioConfig, n: int) -> bool:
    """The front-end kernels' common conditions: MFCC or log-mel; samples
    read as 16-byte rows (hop and window multiples of 4); the features fit
    over the power spectrum in place (C <= 2 * ncg: the rule of K4's former
    FP32 stage, kept so that the kernels serve what they served)."""
    if cfg.preprocess_method not in ("mfcc", "log_mel_spectrogram"):
        return False
    window, hop = cfg.window_size_samples, cfg.window_stride_samples
    if n < window or hop % 4 or window % 4:
        return False
    g = front_end_geometry(cfg, n)
    return g.width <= 2 * g.ncg


def hop_decomposable(cfg: AudioConfig, n: int) -> bool:
    """The JAX kernel's own condition (tcresnet_tpu/ops/pallas/mfcc.py
    `fused_mfcc_available`): MFCC or log-mel, window % hop == 0, n % hop
    == 0 and n >= window. Where it fails, the JAX package returns the
    plain feature."""
    window, hop = cfg.window_size_samples, cfg.window_stride_samples
    return (cfg.preprocess_method in ("mfcc", "log_mel_spectrogram")
            and window % hop == 0 and n % hop == 0 and n >= window)


def _stage_serves(cfg: AudioConfig, n: int, variant: str) -> bool:
    """Whether the stage of `variant` serves the geometry: for hops and
    phases a tile that fits a block (`tc_tile_plan`), for radix4 the frames
    of one product, the DCT staged in its ring and its plan within a
    block; no mel weight on a row they leave out."""
    g = front_end_geometry(cfg, n)
    try:
        if variant != "radix4":
            nnz = tc_mel_constants(*dsp.mel_args(cfg))[1].size
            return tc_tile_plan(1, g, nnz) is not None
        nnz = radix4_kernel_constants(*dsp.radix4_mel_args(cfg))[2].size
    except ValueError:
        return False
    return (g.num_mel * g.width <= TC_STAGES * TC_BK * TC_SB  # K9 stages the DCT in the ring
            and smem_plan(g, variant) is not None and smem_bytes(g, variant, nnz) <= SMEM_LIMIT)


def kernel_variant(cfg: AudioConfig, n: int) -> str:
    """The stage a CUDA batch of cfg's geometry runs: the resolved variant
    (`resolve_dft_variant`), except a radix4 clip K9 does not serve (more
    frames than its largest product, R4_PRODUCT_ROWS, or a plan past a
    block's shared memory), which runs K2's stage ("hops"): the same
    function, for any frame count. A pure function of the geometry; the
    CPU's plain version stays the resolved variant's."""
    variant = resolve_dft_variant(cfg, n)
    if variant == "radix4" and not _stage_serves(cfg, n, variant):
        return "hops"
    return variant


def fused_mfcc_available(cfg: AudioConfig, n: int) -> bool:
    """The JAX kernel's condition (`hop_decomposable`) and the kernels':
    the common ones (`front_end_supported`) and those of the stage
    `kernel_variant` picks (`_stage_serves`)."""
    if not hop_decomposable(cfg, n) or not front_end_supported(cfg, n):
        return False
    return _stage_serves(cfg, n, kernel_variant(cfg, n))


def fused_mfcc_route(cfg: AudioConfig, n: int, device_type: str) -> str:
    """Where `fused_mfcc` sends a [B, n] batch on a device of `device_type`:
    "reference" for a CPU tensor (the resolved variant's plain version);
    for a CUDA tensor "plain" where the JAX package falls back too (not
    `hop_decomposable`: `plain_feature`, counted in `plain_routes`), else
    "kernel", the stage of `kernel_variant`. A CUDA geometry the JAX
    kernel takes but no stage here serves (`fused_mfcc_available`) raises
    ValueError, as any other device type does: it is never sent to the
    plain feature."""
    if device_type == "cpu":
        return "reference"
    if device_type != "cuda":
        raise ValueError(f"no front-end kernel for device type {device_type!r}")
    if not hop_decomposable(cfg, n):
        return "plain"
    if not fused_mfcc_available(cfg, n):
        raise ValueError(
            f"no front-end kernel serves this geometry ({cfg.preprocess_method}, window "
            f"{cfg.window_size_samples}, hop {cfg.window_stride_samples}, n {n}, DFT variant "
            f"{resolve_dft_variant(cfg, n)})")
    return "kernel"


def plain_feature(wavs: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """The plain feature of cfg's method, [B, frames, C]: what the JAX
    package's `fused_mfcc` returns for a geometry no kernel serves
    (tcresnet_tpu/ops/pallas/mfcc.py:692-698)."""
    if cfg.preprocess_method == "log_mel_spectrogram":
        return dsp.log_mel_spectrogram(wavs, cfg, magnitude_squared=False)
    return dsp.mfcc(wavs, cfg)


def auto_takes_kernel(cfg: AudioConfig, device: torch.device, batch: int, n: int) -> bool:
    """The "auto" rule: a CUDA device, batch >= AUTO_MIN_BATCH, and a
    geometry the kernels serve (the JAX package's rule with "cuda" for "tpu")."""
    return device.type == "cuda" and batch >= AUTO_MIN_BATCH and fused_mfcc_available(cfg, n)


class FrontEnd:
    """A front-end kernel's constants for one geometry and DFT variant, on
    one device, the DFT rounded to bf16 and back for
    dsp_matmul_dtype="bfloat16":

      hops,   the stage K2, K8 and K4 share (dft_tc.cuh): the windowed DFT
      phases  [Kp, 128 units] (`tc_dft_matrix`; for phases the live rows of
              every W_p); the mel's nonzero weights as `mel` and each
              unit's runs of them as `runs` (`tc_mel_constants`)
      radix4  the live columns of M0 | M1 | M2, the zero-padded window
              [fft], the mel's nonzero weights and runs
              (`radix4_kernel_constants`)

    and the DCT (None for log-mel). Made once per geometry, device and
    variant by `front_end`; read it, never write it. `launch_args(batch)`
    gives a launch's FeVariant and shared memory."""

    def __init__(self, cfg: AudioConfig, n: int, device: torch.device, variant: str = "hops"):
        g = front_end_geometry(cfg, n)
        self.geom, self.variant = g, variant
        self.device = torch.device(device)
        self.matmul_dtype = dsp.dsp_matmul_dtype(cfg)

        def dev(a, rounded=False):
            t = torch.tensor(np.ascontiguousarray(a, np.float32), device=self.device)
            return dsp.round_operand(t, self.matmul_dtype) if rounded else t

        self.dct = None if g.magnitude else dev(
            dsp.dct_ii_matrix(cfg.num_mel_bins, cfg.num_mfccs))
        self.nnz = 0
        self._variant = v = FeVariant()
        self.win = self.runs = None
        self.dft_split = None
        if variant in ("hops", "phases"):
            runs, vals = tc_mel_constants(*dsp.mel_args(cfg))
            self.dft = dev(tc_dft_matrix(g.window, g.hop, g.fft_length), rounded=True)
            # the 128-row product's TF32 parts of the rounded constant, split once
            self.dft_split = dev(tc_dft_split(self.dft.cpu().numpy()))
            v.wsplit = self.dft_split.data_ptr()
            v.units = tc_units(g.fft_length)
            v.stride, v.gap = tc_layout(g)
            # split tiles' counters (fewer than SMS tiles: the plan's rule),
            # 0 between calls; calls on one stream at a time
            self.done = torch.zeros(SMS, dtype=torch.int32, device=self.device)
            v.done = self.done.data_ptr()
        elif variant == "radix4":
            w, runs, vals = radix4_kernel_constants(*dsp.radix4_mel_args(cfg))
            self.dft = dev(w, rounded=True)
            self.win = dev(dsp.radix4_window(g.window, g.fft_length))
            v.length = g.fft_length // 4
            plan = smem_plan(g, variant, vals.size)
            self.region_a, self.smem_bytes = plan["samples"], 4 * sum(plan.values())
        else:
            raise ValueError(f"unknown DFT variant {variant!r}")
        self.nnz = v.mel_nnz = vals.size
        self.mel = dev(np.pad(vals, (0, -vals.size % 4)))  # copied as float4s
        self.runs = torch.tensor(runs, device=self.device)
        v.runs = self.runs.data_ptr()
        v.w = self.dft.data_ptr()
        v.win = 0 if self.win is None else self.win.data_ptr()

    def args(self) -> FeArgs:
        """The FeArgs of this front end."""
        g = self.geom
        dct = self.mel if self.dct is None else self.dct
        return FeArgs(
            self.dft.data_ptr(), self.mel.data_ptr(), dct.data_ptr(),
            g.n, g.window, g.hop, g.frames, g.num_mel,
            g.width, int(g.magnitude), int(self.matmul_dtype == torch.bfloat16),
        )

    def variant_args(self) -> FeVariant:
        return self._variant

    def launch_args(self, batch: int) -> tuple:
        """(FeVariant, samples region in floats, shared-memory bytes,
        workspace) of a launch over `batch` clips: K2's and K8's from their
        tile plan for the batch (`tc_tile_plan`), with split tiles'
        workspace for their mel contributions (keep it until the launch is
        enqueued), K9's fixed and no workspace."""
        if self.variant == "radix4":
            return self._variant, self.region_a, self.smem_bytes, None
        g = self.geom
        plan = tc_tile_plan(batch, g, self.nnz)
        v = FeVariant.from_buffer_copy(self._variant)
        v.rows, v.splits, v.stages = plan.rows, plan.splits, plan.stages
        part = None
        if plan.splits > 1:
            part = torch.empty(plan.tiles * v.units * g.num_mel * plan.rows,
                               dtype=torch.float32, device=self.device)
            v.part = part.data_ptr()
        return v, plan.span, plan.smem_bytes, part


def front_end(cfg: AudioConfig, n: int, device: torch.device, variant: str = "hops") -> FrontEnd:
    """The FrontEnd of (cfg, n, device, variant), made once. K2 and K8 share
    one: "phases" is the "hops" front end, and cfg's dft_variant, which the
    constants do not depend on, is not part of the key."""
    return _front_end(dataclasses.replace(cfg, dft_variant="auto"), n, torch.device(device),
                      "hops" if variant == "phases" else variant)


@functools.lru_cache(maxsize=None)
def _front_end(cfg: AudioConfig, n: int, device: torch.device, variant: str) -> FrontEnd:
    return FrontEnd(cfg, n, device, variant)


class _K2Args(ctypes.Structure):
    """Mirror of struct K2Args in csrc/mfcc.cu."""

    _fields_ = [("fe", FeArgs), ("v", FeVariant), ("wavs", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("batch", ctypes.c_int), ("region_a", ctypes.c_int),
                ("smem_bytes", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _build.bind("mfcc", _K2Args, sorted(set(ENTRIES.values())), "k2_args_size",
                       "k2_error_string")


def build_kernels() -> None:
    """Build (if needed) and load the kernel library now, not at first launch."""
    _library()


# ---------------------------------------------------------------------------
# plain versions and dispatch
# ---------------------------------------------------------------------------


def phases_reim(wavs: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """[B, n] -> [B, frames, 2K] (Re | Im) through the phase-grouped DFT
    (JAX `mfcc_tail_phases`): for each phase, the strided lane-row view
    [B, frames_p, rows_p * 128] @ W_p, then the interleave back to frame
    order. dsp_matmul_dtype rounds both operands; sums stay float32."""
    batch, n = wavs.shape
    window, hop = cfg.window_size_samples, cfg.window_stride_samples
    fft_length = dsp.fft_length_for(window)
    num_p, s_rows, nsb, frames, phases = phase_dft_plan(window, hop, n, fft_length)
    two_k = fft_length + 2
    dtype = dsp.dsp_matmul_dtype(cfg)
    x4 = wavs.to(torch.float32).reshape(batch, nsb, s_rows, LANES)
    outs = []
    for p, (c, rows_p, frames_p, _) in enumerate(phases):
        reim = wavs.new_zeros((batch, nsb, two_k), dtype=torch.float32)
        if frames_p:
            parts = []
            for j in range(rows_p):
                bs, ri = divmod(c + j, s_rows)
                parts.append(x4[:, bs:bs + frames_p, ri, :])
            lhs = dsp.round_operand(torch.cat(parts, dim=-1), dtype)
            w = dsp.device_constant(_phase_matrix, (window, hop, n, fft_length, p), wavs.device)
            reim[:, :frames_p] = lhs @ dsp.round_operand(w, dtype)
        outs.append(reim)
    return torch.stack(outs, dim=2).reshape(batch, nsb * num_p, two_k)[:, :frames]


def _phase_matrix(window: int, hop: int, n: int, fft_length: int, p: int) -> np.ndarray:
    return phase_dft_plan(window, hop, n, fft_length)[4][p][3]


def fused_mfcc_reference(wavs: torch.Tensor, cfg: AudioConfig,
                         variant: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version of the variant's kernel (resolved from `cfg`
    when None), [B, frames, C]: K2's is the dense front end, K9's the
    radix-4 path of ops/dsp.py, K8's the per-phase products (`phases_reim`)
    with the same power, mel, log and DCT."""
    variant = variant or resolve_dft_variant(cfg, wavs.shape[-1])
    mfcc = cfg.preprocess_method == "mfcc"
    if variant == "phases":
        reim = phases_reim(wavs, cfg)
        num_bins = reim.shape[-1] // 2
        re, im = reim[..., :num_bins], reim[..., num_bins:]
        mel_w = dsp.device_constant(dsp.linear_to_mel_weight_matrix, dsp.mel_args(cfg),
                                    wavs.device)
        feats = dsp.log_mel_from_power(re * re + im * im, mel_w, magnitude_squared=mfcc)
        if not mfcc:
            return feats
        return feats @ dsp.device_constant(dsp.dct_ii_matrix,
                                           (cfg.num_mel_bins, cfg.num_mfccs), wavs.device)
    plain = dataclasses.replace(cfg, dft_variant=variant)  # "hops": the dense path
    if mfcc:
        return dsp.mfcc(wavs, plain)
    return dsp.log_mel_spectrogram(wavs, plain, magnitude_squared=False)


def fused_mfcc(wavs: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """[B, n] f32 wavs -> [B, frames, C] MFCC or log-mel, by
    `fused_mfcc_route`: for a CUDA tensor the kernel of `kernel_variant`
    (K2, K8 or K9; K2 for a radix4 clip past K9's frames), counted by the
    stage that ran, or the plain feature where the JAX package falls back
    too; the resolved variant's plain version for a CPU tensor; an error
    otherwise."""
    global plain_routes
    if wavs.dim() != 2:
        raise ValueError(f"wavs must be [B, n], got {list(wavs.shape)}")
    n = wavs.shape[1]
    route = fused_mfcc_route(cfg, n, wavs.device.type)
    if route == "reference":
        return fused_mfcc_reference(wavs, cfg)
    if route == "plain":
        plain_routes += 1
        return plain_feature(wavs, cfg)
    variant = kernel_variant(cfg, n)
    if wavs.dtype != torch.float32:
        raise TypeError(f"wavs must be float32, got {wavs.dtype}")
    if not wavs.is_contiguous():
        raise ValueError("wavs must be contiguous")
    if wavs.data_ptr() % 16:
        raise ValueError(f"{ENTRIES[variant]} copies wavs in 16-byte chunks: wavs must be "
                         "16-byte aligned")
    fe = front_end(cfg, n, wavs.device, variant)
    g = fe.geom
    out = torch.empty((wavs.shape[0], g.frames, g.width), device=wavs.device,
                      dtype=torch.float32)
    if wavs.shape[0] == 0:
        return out
    v, region_a, smem, _part = fe.launch_args(wavs.shape[0])
    args = _K2Args(fe.args(), v, wavs.data_ptr(), out.data_ptr(), wavs.shape[0], region_a, smem)
    _build.launch(_library(), ENTRIES[variant], "k2_error_string", args, wavs.device)
    globals()[_COUNTERS[variant]] += 1
    count_wgmma(v)
    return out


def count_wgmma(v: FeVariant) -> None:
    """Count a launch of the frames' stage in `wgmma_launches` where its
    tile plan (`v`, from `FrontEnd.launch_args`) took the 128-row product."""
    global wgmma_launches
    if v.rows == WG_ROWS:
        wgmma_launches += 1
