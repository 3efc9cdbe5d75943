"""Fused MFCC / log-mel front end: wav [B, n] -> features [B, frames, C].

Counterpart of tcresnet_tpu/ops/pallas/mfcc.py, whose `dft_variant` picks
the DFT decomposition of one kernel; here each variant is an entry point
of `csrc/mfcc.cu`:

  "hops"    K2  `_kernel`: every frame's full-window dot with the windowed
                DFT (no hop decomposition on the card, see frontend.cuh)
  "phases"  K8  `_kernel_phases`: frames grouped by phase f mod P, one
                product per phase of a strided lane-row view of the
                utterance against W_p (`phase_dft_plan`)
  "radix4"  K9  `_kernel_radix4`: the radix-4 DIF factored rDFT (window,
                butterfly, three stage-2 products, branch-permuted power
                and mel; `dsp.radix4_dft_matrices`), on the tensor cores

Their spectral code is `csrc/frontend.cuh` (hops, phases), shared with K3
(`frontend.cu`) and K4 (`infer.cu`, always "hops" as in JAX), and
`csrc/radix4.cuh` (radix4, shared with K3's radix4 entry point); the
source notes say what bounds each on the H100. This module:

- resolves a config's variant as the JAX package does
  (`resolve_dft_variant`, with its fallback to "hops" where a geometry
  does not allow the variant). The availability rules are the TPU
  kernel's (lane alignment, the radix-4 lookahead guard); they are kept so
  that a config selects the variant JAX selects;
- lays each variant's constants out for the kernels and keeps them on the
  device, once per (audio config, clip length, device, variant)
  (`front_end` -> `FrontEnd`, the ctypes mirrors of `FeArgs` and
  `FeVariant`; K9's live columns, rows and mel runs:
  `radix4_kernel_constants`), with each kernel's shared-memory plan
  (`smem_plan`);
- holds the plain PyTorch versions (`fused_mfcc_reference`): the port's
  dense front end for "hops", the radix-4 path of `ops/dsp.py` for
  "radix4", and `phases_reim`, the per-phase products of
  `mfcc_tail_phases`, for "phases";
- dispatches (`fused_mfcc`): a CPU tensor goes to the plain version, a
  CUDA tensor to the variant's kernel, anything else raises.

`launches`, `phases_launches` and `radix4_launches` count launches of K2,
K8 and K9 and nothing else.
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

SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
LANES = 128  # the TPU lane width the phase plan and the radix-4 rules are stated in
MAX_PHASES = 8  # FE_MAX_PHASES in csrc/frontend.cuh
# K9's product (csrc/radix4.cuh): K slices of R4_BK rows of M through a ring
# of R4_STAGES; units of R4_BN columns, R4_BN / 2 (re, im) pairs; the A
# slice, M slice and power tile row strides; frames up to 64 take a
# 64-row product, up to 112 a 112-row one
R4_BK, R4_BN, R4_STAGES = 32, 128, 3
R4_PAIRS = R4_BN // 2
R4_SA, R4_SB, R4_SP = R4_BK + 4, R4_BN + 8, R4_PAIRS + 1
R4_PRODUCT_ROWS = (64, 112)
VARIANTS = ("hops", "phases", "radix4")
ENTRIES = {"hops": "k2_mfcc", "phases": "k8_mfcc", "radix4": "k9_mfcc"}
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


def interleave_reim(m: np.ndarray, num_bins: int, ncg: int) -> np.ndarray:
    """[rows, 2 * num_bins] (Re | Im) columns -> [rows, 4 * ncg], columns
    (re_k, im_k, re_k+1, im_k+1) per group of 4, so that a thread forms two
    power bins from its own accumulators; bins past num_bins are zero."""
    out = np.zeros((m.shape[0], 2 * ncg, 2), np.float32)
    out[:, :num_bins, 0] = m[:, :num_bins]
    out[:, :num_bins, 1] = m[:, num_bins:2 * num_bins]
    return out.reshape(m.shape[0], 4 * ncg)


def interleaved_dft_matrix(window: int, fft_length: int, ncg: int) -> np.ndarray:
    """[window, 4*ncg] windowed real-DFT matrix with columns
    (re_k, im_k, re_k+1, im_k+1) per group; bins past the last are zero."""
    return interleave_reim(dsp.windowed_rdft_matrix(window, fft_length),
                           fft_length // 2 + 1, ncg)


class FeArgs(ctypes.Structure):
    """Mirror of struct FeArgs in csrc/frontend.cuh."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("dft", "mel", "dct")]
        + [(f, ctypes.c_int) for f in (
            "n", "window", "hop", "frames", "ncg", "num_bins", "num_mel",
            "num_coef", "magnitude", "round_bf16")]
    )


class FeVariant(ctypes.Structure):
    """Mirror of struct FeVariant in csrc/frontend.cuh: the phases (K8) or
    radix-4 (K9) DFT stage."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("w", "win", "runs")]
        + [(f, ctypes.c_int) for f in ("num_p", "s_rows", "length", "mel_nnz")]
        + [(f, ctypes.c_int * MAX_PHASES) for f in ("c", "rows", "frames", "off")]
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
        """(region A floats, region B floats) of frontend.cuh's shared-memory
        plan; A at least `region_a_floats`, B 16-byte aligned."""
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
    kmel = mel[rows]
    units = kmel.shape[0] // R4_PAIRS
    runs = np.zeros((units, num_mel_bins, 3), np.int32)
    vals, offset = [], 0
    for u in range(units):
        for m in range(num_mel_bins):
            col = kmel[u * R4_PAIRS:(u + 1) * R4_PAIRS, m]
            nz = np.flatnonzero(col)
            first, end = (nz[0], nz[-1] + 1) if nz.size else (0, 0)
            runs[u, m] = first, end, offset
            vals.append(col[first:end])
            offset += end - first
    vals = np.concatenate(vals).astype(np.float32)
    for a in (w, runs, vals):
        a.setflags(write=False)
    return w, runs, vals


def radix4_kernel_rows(fft_length: int) -> np.ndarray:
    """The rows of `dsp.radix4_mel_matrix` (the branch-permuted power) that
    K9's 2L power rows are, in order: branch 0's k2 < L/2, all of branch
    1, branch 2's k2 < L/2."""
    length = fft_length // 4
    return np.concatenate([np.arange(length // 2), length + np.arange(length),
                           2 * length + np.arange(length // 2)])


def smem_plan(g: FrontEndGeometry, variant: str, nnz: int = 0) -> Optional[Dict[str, int]]:
    """The regions of the variant's shared-memory plan, in floats, in their
    order. hops and phases (frontend.cuh): "a" the samples, later the
    log-mel; "b" the power spectrum, later the features. radix4
    (radix4.cuh), each region but the last a multiple of 4 floats: the
    "samples", the "window" (4L), the mel's "runs" and its `nnz` nonzero
    weights, "vals" (`radix4_kernel_constants`), the "ring" (R4_STAGES
    slices of M, [R4_BK, R4_SB]), the "stage" (two A slices, [rows,
    R4_SA]), the "power" tile of a unit ([frames, R4_SP]) and the "mel"
    sums ([num_mel, frames]); None where the frames exceed the largest
    product."""
    a, b = g.regions()
    if variant != "radix4":
        return {"a": a, "b": b}
    rows = radix4_product_rows(g.frames)
    if rows is None:
        return None
    length = g.fft_length // 4
    up4 = lambda x: x + (-x % 4)  # noqa: E731
    return {"samples": up4(g.n), "window": 4 * length,
            "runs": up4(4 * length // R4_BN * g.num_mel * 3), "vals": up4(nnz),
            "ring": R4_STAGES * R4_BK * R4_SB, "stage": 2 * rows * R4_SA,
            "power": up4(g.frames * R4_SP), "mel": g.frames * g.num_mel}


def smem_bytes(g: FrontEndGeometry, variant: str, nnz: int = 0) -> int:
    return 4 * sum(smem_plan(g, variant, nnz).values())


def front_end_supported(cfg: AudioConfig, n: int) -> bool:
    """frontend.cuh's conditions: MFCC or log-mel; frames read as 16-byte
    rows (hop and window multiples of 4); the features fit over the power
    spectrum in place (C <= 2 * ncg)."""
    if cfg.preprocess_method not in ("mfcc", "log_mel_spectrogram"):
        return False
    window, hop = cfg.window_size_samples, cfg.window_stride_samples
    if n < window or hop % 4 or window % 4:
        return False
    g = front_end_geometry(cfg, n)
    return g.width <= 2 * g.ncg


def fused_mfcc_available(cfg: AudioConfig, n: int) -> bool:
    """The JAX kernel's condition (hop-decomposable geometry: window % hop
    == 0, n % hop == 0, n >= window; MFCC or log-mel) and the kernels': the
    shared front end's, a phase count that FeVariant holds, for radix4 the
    frames of one product and no mel weight on a row it leaves out, and a
    shared-memory plan of the resolved variant that fits one block."""
    window, hop = cfg.window_size_samples, cfg.window_stride_samples
    if window % hop or n % hop or not front_end_supported(cfg, n):
        return False
    variant = resolve_dft_variant(cfg, n)
    g = front_end_geometry(cfg, n)
    if variant == "phases" and phase_dft_plan(
            window, hop, n, g.fft_length)[0] > MAX_PHASES:
        return False
    nnz = 0
    if variant == "radix4":
        try:
            nnz = radix4_kernel_constants(*dsp.radix4_mel_args(cfg))[2].size
        except ValueError:
            return False
        # the DCT is staged in the ring after the products
        if (smem_plan(g, variant) is None
                or g.num_mel * g.width > R4_STAGES * R4_BK * R4_SB):
            return False
    return smem_bytes(g, variant, nnz) <= SMEM_LIMIT


def auto_takes_kernel(cfg: AudioConfig, device: torch.device, batch: int, n: int) -> bool:
    """The "auto" rule: a CUDA device, batch >= AUTO_MIN_BATCH, and a
    geometry the kernels serve (the JAX package's rule with "cuda" for "tpu")."""
    return device.type == "cuda" and batch >= AUTO_MIN_BATCH and fused_mfcc_available(cfg, n)


class FrontEnd:
    """frontend.cuh's constants for one geometry and DFT variant, on one
    device, rounded to bf16 and back for dsp_matmul_dtype="bfloat16":

      hops    the interleaved windowed DFT [window, 4 ncg]
      phases  the P interleaved W_p [rows_p * 128, 4 ncg], back to back
      radix4  the live columns of M0 | M1 | M2, the zero-padded window
              [fft], the mel's nonzero weights as `mel` and each unit's
              runs of them as `runs` (`radix4_kernel_constants`)

    and the mel matrix and the DCT (None for log-mel). Made once per
    (config, n, device, variant) by `front_end`; read it, never write it."""

    def __init__(self, cfg: AudioConfig, n: int, device: torch.device, variant: str = "hops"):
        g = front_end_geometry(cfg, n)
        self.geom, self.variant = g, variant
        self.device = torch.device(device)
        self.matmul_dtype = dsp.dsp_matmul_dtype(cfg)

        def dev(a, rounded=False):
            t = torch.tensor(np.ascontiguousarray(a, np.float32), device=self.device)
            return dsp.round_operand(t, self.matmul_dtype) if rounded else t

        self.mel = dev(dsp.linear_to_mel_weight_matrix(*dsp.mel_args(cfg)))
        self.dct = None if g.magnitude else dev(
            dsp.dct_ii_matrix(cfg.num_mel_bins, cfg.num_mfccs))
        nnz = 0
        if variant == "radix4":
            w, runs, vals = radix4_kernel_constants(*dsp.radix4_mel_args(cfg))
            nnz = vals.size
        self.region_a = next(iter(smem_plan(g, variant, nnz).values()))
        self.smem_bytes = smem_bytes(g, variant, nnz)
        self._variant = FeVariant()
        self.dft = self.win = self.runs = None
        if variant == "hops":
            self.dft = dev(interleaved_dft_matrix(g.window, g.fft_length, g.ncg), rounded=True)
        elif variant == "phases":
            num_p, s_rows, _, _, phases = phase_dft_plan(g.window, g.hop, n, g.fft_length)
            ws = [interleave_reim(w, g.num_bins, g.ncg) for *_, w in phases]
            self.dft = dev(np.concatenate([w.ravel() for w in ws]), rounded=True)
            v = self._variant
            v.num_p, v.s_rows = num_p, s_rows
            off = 0
            for p, ((c, rows_p, frames_p, _), w) in enumerate(zip(phases, ws)):
                v.c[p], v.rows[p], v.frames[p], v.off[p] = c, rows_p, frames_p, off
                off += w.size
        elif variant == "radix4":
            self.dft = dev(w, rounded=True)
            self.win = dev(dsp.radix4_window(g.window, g.fft_length))
            self.mel = dev(np.pad(vals, (0, -vals.size % 4)))  # copied as float4s
            self.runs = torch.tensor(runs, device=self.device)
            self._variant.length, self._variant.mel_nnz = g.fft_length // 4, nnz
            self._variant.runs = self.runs.data_ptr()
        else:
            raise ValueError(f"unknown DFT variant {variant!r}")
        self._variant.w = self.dft.data_ptr()
        self._variant.win = 0 if self.win is None else self.win.data_ptr()

    def args(self) -> FeArgs:
        """The FeArgs of this front end; for radix4 the power rows are the
        kernel's 2L (num_bins = 2L = 2 ncg)."""
        g = self.geom
        dct = self.mel if self.dct is None else self.dct
        num_bins, ncg = g.num_bins, g.ncg
        if self.variant == "radix4":
            num_bins = g.fft_length // 2
            ncg = num_bins // 2
        return FeArgs(
            self.dft.data_ptr(), self.mel.data_ptr(), dct.data_ptr(),
            g.n, g.window, g.hop, g.frames, ncg, num_bins, g.num_mel,
            g.width, int(g.magnitude), int(self.matmul_dtype == torch.bfloat16),
        )

    def variant_args(self) -> FeVariant:
        return self._variant


@functools.lru_cache(maxsize=None)
def front_end(cfg: AudioConfig, n: int, device: torch.device, variant: str = "hops") -> FrontEnd:
    return FrontEnd(cfg, n, device, variant)


class _K2Args(ctypes.Structure):
    """Mirror of struct K2Args in csrc/mfcc.cu."""

    _fields_ = [("fe", FeArgs), ("v", FeVariant), ("wavs", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("batch", ctypes.c_int), ("region_a", ctypes.c_int),
                ("smem_bytes", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _build.bind("mfcc", _K2Args, list(ENTRIES.values()), "k2_args_size",
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
    """[B, n] f32 wavs -> [B, frames, C] MFCC or log-mel: the resolved
    variant's kernel (K2, K8 or K9) for a CUDA tensor, its plain version for
    a CPU tensor, an error otherwise."""
    if wavs.dim() != 2:
        raise ValueError(f"wavs must be [B, n], got {list(wavs.shape)}")
    n = wavs.shape[1]
    variant = resolve_dft_variant(cfg, n)
    if wavs.device.type == "cpu":
        return fused_mfcc_reference(wavs, cfg, variant)
    if wavs.device.type != "cuda":
        raise ValueError(f"no front-end kernel for device type {wavs.device.type!r}")
    if wavs.dtype != torch.float32:
        raise TypeError(f"wavs must be float32, got {wavs.dtype}")
    if not wavs.is_contiguous():
        raise ValueError("wavs must be contiguous")
    if variant == "radix4" and wavs.data_ptr() % 16:
        raise ValueError("K9 copies wavs in 16-byte chunks: wavs must be 16-byte aligned")
    if not fused_mfcc_available(cfg, n):
        raise ValueError(
            f"no front-end kernel serves this geometry ({cfg.preprocess_method}, n {n}, "
            f"window {cfg.window_size_samples}, hop {cfg.window_stride_samples}, "
            f"variant {variant})")
    fe = front_end(cfg, n, wavs.device, variant)
    g = fe.geom
    out = torch.empty((wavs.shape[0], g.frames, g.width), device=wavs.device,
                      dtype=torch.float32)
    if wavs.shape[0] == 0:
        return out
    args = _K2Args(fe.args(), fe.variant_args(), wavs.data_ptr(), out.data_ptr(),
                   wavs.shape[0], fe.region_a, fe.smem_bytes)
    _build.launch(_library(), ENTRIES[variant], "k2_error_string", args, wavs.device)
    globals()[_COUNTERS[variant]] += 1
    return out
