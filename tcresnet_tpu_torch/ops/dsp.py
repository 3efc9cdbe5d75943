"""MFCC / log-mel front end in PyTorch (counterpart of tcresnet_tpu/ops/dsp.py).

Same math as the JAX module, which reproduces the TF-1.13 training
front end:

    frames[B,F,W] --(windowed real-DFT matmul, [W, 2K])--> re/im[B,F,2K]
    power/magnitude[B,F,K] --(mel matmul [K,M])--> mel[B,F,M]
    log(mel + 1e-6) --(DCT-II matmul [M,C])--> mfcc[B,F,C]

The numpy constant builders are re-implemented here (the JAX module
imports jax) and pinned to the JAX ones by tests/test_torch_dsp.py. The
torch functions take tensors on any device and keep them there.

`dft_variant="radix4"` routes the spectrum through the radix-4 DIF
factored real DFT (`radix4_dft_matrices`): the same math as the dense
matrix to reassociation level, with the branch permutation of the bins
folded into the mel matrix (`radix4_mel_matrix`), as the JAX path does;
"phases" and "hops" leave this path dense, as in JAX.

`dsp_backend="pallas"` names the fused front-end kernels
(`ops/kernels/mfcc.py`, CUDA source `csrc/mfcc.cu`: K2 for "hops", K8 for
"phases", K9 for "radix4"); on a CPU tensor they run their plain
versions.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from tcresnet_tpu_torch.config import AudioConfig


# ---------------------------------------------------------------------------
# Geometry helpers
# ---------------------------------------------------------------------------


def fft_length_for(window_size_samples: int) -> int:
    """tf.signal.stft default: smallest power of 2 >= frame_length."""
    return 2 ** int(math.ceil(math.log2(window_size_samples)))


def num_frames_for(num_samples: int, window: int, hop: int) -> int:
    """pad_end=False framing: 1 + floor((N - W) / hop)."""
    return 1 + (num_samples - window) // hop


def feature_width(cfg: AudioConfig) -> int:
    """Coefficients per frame: num_mfccs for MFCC, num_mel_bins for log-mel."""
    if cfg.preprocess_method == "mfcc":
        return cfg.num_mfccs
    if cfg.preprocess_method == "log_mel_spectrogram":
        return cfg.num_mel_bins
    raise ValueError(f"no spectral feature width for {cfg.preprocess_method!r}")


def feature_shape(cfg: AudioConfig) -> tuple:
    """(frames, coeffs, channels) of the front end's output for `cfg`."""
    frames = num_frames_for(
        cfg.desired_samples, cfg.window_size_samples, cfg.window_stride_samples
    )
    if cfg.preprocess_method == "mfcc":
        return (frames, cfg.num_mfccs, 1)
    if cfg.preprocess_method == "log_mel_spectrogram":
        return (frames, cfg.num_mel_bins, 1)
    if cfg.preprocess_method == "no_preprocessing":
        return (cfg.desired_samples, 1, 1)
    raise ValueError(f"Unknown preprocess_method {cfg.preprocess_method!r}")


# ---------------------------------------------------------------------------
# Constant matrices (numpy, cached and read-only: every caller shares them)
# ---------------------------------------------------------------------------


def _frozen(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)
    return a


@functools.lru_cache(maxsize=None)
def hann_window(window_size: int) -> np.ndarray:
    """Periodic Hann, matching tf.signal.hann_window(periodic=True)."""
    n = np.arange(window_size, dtype=np.float64)
    return _frozen(
        (0.5 - 0.5 * np.cos(2.0 * np.pi * n / window_size)).astype(np.float32)
    )


@functools.lru_cache(maxsize=None)
def windowed_rdft_matrix(window_size: int, fft_length: int) -> np.ndarray:
    """[W, 2K] matrix computing (Re, Im) of the windowed real DFT:
    frames @ M = concat([Re(rfft(w*frame)), Im(rfft(w*frame))], -1)."""
    num_bins = fft_length // 2 + 1
    n = np.arange(window_size, dtype=np.float64)[:, None]
    k = np.arange(num_bins, dtype=np.float64)[None, :]
    angle = 2.0 * np.pi * n * k / fft_length
    win = hann_window(window_size).astype(np.float64)[:, None]
    cos_m = win * np.cos(angle)
    sin_m = win * -np.sin(angle)
    return _frozen(np.concatenate([cos_m, sin_m], axis=1).astype(np.float32))


@functools.lru_cache(maxsize=None)
def dft_hop_blocks(window: int, hop: int, fft_length: int) -> np.ndarray:
    """[hop, k*2K] hop-decomposed DFT matrix: block j holds rows
    j*hop:(j+1)*hop of windowed_rdft_matrix, so that
    reim[f] = sum_j hops[f+j] @ block_j."""
    dft = windowed_rdft_matrix(window, fft_length)
    k = window // hop
    return _frozen(
        np.concatenate([dft[j * hop : (j + 1) * hop] for j in range(k)], axis=1)
    )


@functools.lru_cache(maxsize=None)
def linear_to_mel_weight_matrix(
    num_mel_bins: int,
    num_spectrogram_bins: int,
    sample_rate: int,
    lower_edge_hertz: float,
    upper_edge_hertz: float,
) -> np.ndarray:
    """[K, M] mel filterbank, exact tf.signal.linear_to_mel_weight_matrix:
    HTK mel (1127 ln(1 + f/700)), triangular bands linear in mel, lowest
    FFT bin zeroed, no area normalisation."""

    def hz_to_mel(f):
        return 1127.0 * np.log1p(np.asarray(f, dtype=np.float64) / 700.0)

    bands_to_zero = 1
    nyquist = sample_rate / 2.0
    linear_freqs = np.linspace(0.0, nyquist, num_spectrogram_bins)[bands_to_zero:]
    spectrogram_bins_mel = hz_to_mel(linear_freqs)[:, None]

    band_edges_mel = np.linspace(
        hz_to_mel(lower_edge_hertz), hz_to_mel(upper_edge_hertz), num_mel_bins + 2
    )
    lower_edge = band_edges_mel[None, 0:-2]
    center = band_edges_mel[None, 1:-1]
    upper_edge = band_edges_mel[None, 2:]

    lower_slopes = (spectrogram_bins_mel - lower_edge) / (center - lower_edge)
    upper_slopes = (upper_edge - spectrogram_bins_mel) / (upper_edge - center)
    weights = np.maximum(0.0, np.minimum(lower_slopes, upper_slopes))

    return _frozen(
        np.pad(weights, [[bands_to_zero, 0], [0, 0]]).astype(np.float32)
    )


@functools.lru_cache(maxsize=None)
def dct_ii_matrix(num_mel_bins: int, num_mfccs: int) -> np.ndarray:
    """[M, C] matrix of tf.signal.mfccs_from_log_mel_spectrograms:
    D[n, k] = sqrt(2/M) * cos(pi * k * (2n + 1) / (2M))."""
    n = np.arange(num_mel_bins, dtype=np.float64)[:, None]
    k = np.arange(num_mfccs, dtype=np.float64)[None, :]
    d = np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * num_mel_bins))
    return _frozen((d * np.sqrt(2.0 / num_mel_bins)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def radix4_dft_matrices(fft_length: int) -> tuple:
    """Stage-2 matrices (M0 [L, 2L], M1 [2L, 2L], M2 [L, 2L]) of the
    radix-4 DIF factored rDFT, L = fft_length / 4.

    With n = L*n1 + n2 (four contiguous blocks b_n1) and k = k1 + 4*k2,
    the 4-point butterfly over n1 is adds only,

        u0 = b0+b1+b2+b3,  u1 = (b0-b2) + i(b3-b1),  u2 = b0-b1+b2-b3,

    and the twiddle e^{-2 pi i n2 k1 / N} is folded into the stage-2 DFT-L
    matrices, so X[k1 + 4 k2] = sum_n2 u_k1[n2] e^{-2 pi i n2 (4 k2 + k1) / N}
    is three matmuls: u0 @ M0 (columns Re | Im of k2 <= L/2, rest 0),
    [u1re | u1im] @ M1 (the upper half carries the k1 = 3 bins through
    X[N-k] = conj(X[k])), u2 @ M2 (k2 < L/2, rest 0)."""
    length = fft_length // 4
    n2 = np.arange(length, dtype=np.float64)[:, None]
    j = np.arange(length, dtype=np.float64)[None, :]

    def cos_sin(k1: float):
        theta = 2.0 * np.pi * n2 * (4.0 * j + k1) / fft_length
        return np.cos(theta), np.sin(theta)

    c0, s0 = cos_sin(0.0)
    c1, s1 = cos_sin(1.0)
    c2, s2 = cos_sin(2.0)
    keep0 = (np.arange(length) <= length // 2)[None, :]
    keep2 = (np.arange(length) < length // 2)[None, :]
    m0 = np.concatenate([c0 * keep0, -s0 * keep0], axis=1)
    m1 = np.block([[c1, -s1], [s1, c1]])
    m2 = np.concatenate([c2 * keep2, -s2 * keep2], axis=1)
    return tuple(_frozen(m.astype(np.float32)) for m in (m0, m1, m2))


def radix4_stage2_matrix(fft_length: int, branch: int) -> np.ndarray:
    """M0, M1 or M2 of radix4_dft_matrices."""
    return radix4_dft_matrices(fft_length)[branch]


@functools.lru_cache(maxsize=None)
def radix4_bin_map(fft_length: int) -> np.ndarray:
    """[3L] FFT bin of each permuted radix-4 power row (-1 = dead): rows
    [0, L) branch k1=0 (bin 4r, r <= L/2); [L, 2L) branch k1=1 (bin 1+4j,
    or N-(1+4j) above N/2 by conjugate symmetry); [2L, 3L) branch k1=2
    (bin 2+4j, j < L/2). Every bin 0..N/2 appears exactly once."""
    length = fft_length // 4
    half = fft_length // 2
    bins = np.full(3 * length, -1, np.int64)
    for r in range(length // 2 + 1):
        bins[r] = 4 * r
    for j in range(length):
        k = 1 + 4 * j
        bins[length + j] = k if k <= half else fft_length - k
    for j in range(length // 2):
        bins[2 * length + j] = 2 + 4 * j
    used = bins[bins >= 0]
    if len(used) != half + 1 or len(set(used.tolist())) != half + 1:
        raise AssertionError(f"radix-4 bin map of fft {fft_length} does not cover the bins")
    return _frozen(bins)


@functools.lru_cache(maxsize=None)
def radix4_mel_matrix(num_mel_bins: int, fft_length: int, sample_rate: int,
                      lower_edge_hertz: float, upper_edge_hertz: float) -> np.ndarray:
    """[3L, M] mel filterbank with its rows permuted to the radix-4 power
    layout (dead rows zero): the bin permutation rides the mel matmul."""
    mel = linear_to_mel_weight_matrix(num_mel_bins, fft_length // 2 + 1, sample_rate,
                                      lower_edge_hertz, upper_edge_hertz)
    bins = radix4_bin_map(fft_length)
    out = np.zeros((bins.shape[0], num_mel_bins), np.float32)
    valid = bins >= 0
    out[valid] = mel[bins[valid]]
    return _frozen(out)


@functools.lru_cache(maxsize=None)
def radix4_window(window_size: int, fft_length: int) -> np.ndarray:
    """[fft_length] periodic Hann zero-padded to the FFT length: the
    factored path multiplies by the window explicitly (the dense path folds
    it into its DFT matrix)."""
    out = np.zeros(fft_length, np.float32)
    out[:window_size] = hann_window(window_size)
    return _frozen(out)


def mel_args(cfg: AudioConfig) -> tuple:
    """linear_to_mel_weight_matrix's arguments for `cfg`'s geometry."""
    return (
        cfg.num_mel_bins,
        fft_length_for(cfg.window_size_samples) // 2 + 1,
        cfg.sample_rate,
        cfg.lower_edge_hertz,
        cfg.upper_edge_hertz,
    )


def radix4_mel_args(cfg: AudioConfig) -> tuple:
    """radix4_mel_matrix's arguments for `cfg`'s geometry."""
    return (cfg.num_mel_bins, fft_length_for(cfg.window_size_samples), cfg.sample_rate,
            cfg.lower_edge_hertz, cfg.upper_edge_hertz)


# ---------------------------------------------------------------------------
# torch compute path
# ---------------------------------------------------------------------------


def dsp_matmul_dtype(cfg: AudioConfig) -> torch.dtype:
    """Configured operand dtype of the windowed-DFT matmul."""
    name = getattr(cfg, "dsp_matmul_dtype", "float32")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def round_operand(x: torch.Tensor, matmul_dtype: torch.dtype) -> torch.Tensor:
    """Round a float32 matmul operand to `matmul_dtype` and back, so the
    product of two rounded operands accumulates in float32 (the JAX
    path's `preferred_element_type=f32`)."""
    if matmul_dtype == torch.float32:
        return x
    return x.to(matmul_dtype).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _cached_constant(builder, args: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(builder(*args), device=device)


def _tracing() -> bool:
    """Whether PyTorch is tracing this call (torch.compile, or the fake
    tensors of torch.export), so that a tensor made now is not real."""
    from torch._guards import detect_fake_mode

    return torch.compiler.is_compiling() or detect_fake_mode() is not None


def device_constant(builder, args: tuple, device: torch.device) -> torch.Tensor:
    """`builder(*args)` as a tensor on `device`, made once per process.

    The JAX path folds its constants into the compiled program; here they
    would otherwise be copied host-to-device on every call (a pageable
    copy the host waits for). Shared by every caller: read it, never
    write it. While PyTorch traces (`torch.export.export`), the constant
    is made for that trace and not cached: a cached fake tensor would be
    handed to every later eager call."""
    if _tracing():
        return torch.tensor(builder(*args), device=device)
    return _cached_constant(builder, args, device)


def _frame_index(frames: int, window: int, hop: int) -> np.ndarray:
    return np.arange(frames)[:, None] * hop + np.arange(window)[None, :]


def frame_signal(audio: torch.Tensor, window: int, hop: int) -> torch.Tensor:
    """[..., N] -> [..., F, W] overlapping frames (pad_end=False)."""
    frames = num_frames_for(audio.shape[-1], window, hop)
    return audio[..., device_constant(_frame_index, (frames, window, hop), audio.device)]


def _reim_via_gather(
    audio: torch.Tensor, window: int, hop: int, matmul_dtype=torch.float32
) -> torch.Tensor:
    """Framing gather + one windowed-DFT matmul -> [..., F, 2K].

    With matmul_dtype=bfloat16 both operands are rounded to bf16 and the
    product accumulates in float32."""
    fft_length = fft_length_for(window)
    frames = round_operand(frame_signal(audio, window, hop), matmul_dtype)
    dft = device_constant(windowed_rdft_matrix, (window, fft_length), audio.device)
    return frames @ round_operand(dft, matmul_dtype)


def spectrogram(
    audio: torch.Tensor,
    window: int,
    hop: int,
    magnitude_squared: bool,
    matmul_dtype=torch.float32,
) -> torch.Tensor:
    """[..., N] float32 -> [..., F, K] power or magnitude spectrogram."""
    audio = audio.to(torch.float32)
    num_bins = fft_length_for(window) // 2 + 1
    reim = _reim_via_gather(audio, window, hop, matmul_dtype)
    re, im = reim[..., :num_bins], reim[..., num_bins:]
    power = re * re + im * im
    if magnitude_squared:
        return power
    return torch.sqrt(power)


def radix4_butterfly(fr: torch.Tensor, fft_length: int) -> tuple:
    """[..., fft] windowed frames -> (u0, u1 = [re | im], u2), the radix-4
    DIF butterfly, in fr's dtype (bf16 adds round at every add, as JAX's)."""
    length = fft_length // 4
    b0, b1, b2, b3 = (fr[..., i * length:(i + 1) * length] for i in range(4))
    u0 = b0 + b1 + b2 + b3
    u1 = torch.cat([b0 - b2, b3 - b1], dim=-1)
    u2 = b0 - b1 + b2 - b3
    return u0, u1, u2


def power_radix4(audio: torch.Tensor, window: int, hop: int,
                 matmul_dtype=torch.float32) -> torch.Tensor:
    """[..., N] -> [..., F, 3L] branch-permuted power spectrum through the
    radix-4 factored rDFT: window, zero-pad to the FFT length, round to
    `matmul_dtype`, butterfly in that dtype, three matmuls accumulated in
    float32 (JAX's `_power_radix4`)."""
    fft_length = fft_length_for(window)
    length = fft_length // 4
    frames = frame_signal(audio.to(torch.float32), window, hop)
    fr = frames * device_constant(hann_window, (window,), audio.device)
    fr = torch.nn.functional.pad(fr, (0, fft_length - window)).to(matmul_dtype)
    outs = [u.to(torch.float32) @ round_operand(
                device_constant(radix4_stage2_matrix, (fft_length, i), audio.device), matmul_dtype)
            for i, u in enumerate(radix4_butterfly(fr, fft_length))]
    return torch.cat([o[..., :length] ** 2 + o[..., length:] ** 2 for o in outs], dim=-1)


def log_mel_from_power(power: torch.Tensor, mel_w: torch.Tensor,
                       magnitude_squared: bool) -> torch.Tensor:
    """[..., F, K] power rows -> log(mel + 1e-6): the power spectrum, or its
    square root (the magnitude) when not `magnitude_squared`, through the
    [K, M] mel matrix."""
    spec = power if magnitude_squared else torch.sqrt(power)
    return torch.log(spec @ mel_w + 1e-6)


def log_mel_spectrogram(
    audio: torch.Tensor, cfg: AudioConfig, magnitude_squared: bool
) -> torch.Tensor:
    """[..., N] -> [..., F, M] log-mel features; dft_variant="radix4" takes
    the factored rDFT and its permuted mel matrix."""
    window = cfg.window_size_samples
    hop = cfg.window_stride_samples
    if getattr(cfg, "dft_variant", "auto") == "radix4":
        power = power_radix4(audio, window, hop, dsp_matmul_dtype(cfg))
        mel_w = device_constant(radix4_mel_matrix, radix4_mel_args(cfg), audio.device)
        return log_mel_from_power(power, mel_w, magnitude_squared)
    spec = spectrogram(audio, window, hop, magnitude_squared, dsp_matmul_dtype(cfg))
    mel_w = device_constant(linear_to_mel_weight_matrix, mel_args(cfg), audio.device)
    return torch.log(spec @ mel_w + 1e-6)


def mfcc(audio: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """[..., N] -> [..., F, num_mfccs]: power -> mel -> log -> scaled DCT-II."""
    log_mel = log_mel_spectrogram(audio, cfg, magnitude_squared=True)
    dct_w = device_constant(dct_ii_matrix, (cfg.num_mel_bins, cfg.num_mfccs), audio.device)
    return log_mel @ dct_w


def resolve_dsp_backend(cfg: AudioConfig, audio: torch.Tensor) -> str:
    """cfg.dsp_backend for this call: "auto" takes the fused kernel for
    a [B, N] batch by `ops.kernels.mfcc.auto_takes_kernel` (a CUDA device
    and at least 2048 rows), else the plain path."""
    backend = getattr(cfg, "dsp_backend", "xla")
    if backend not in ("xla", "pallas", "auto"):
        raise ValueError(f"Unknown dsp_backend {backend!r}")
    if backend == "auto":
        from tcresnet_tpu_torch.ops.kernels import mfcc as k2

        fused = audio.dim() == 2 and k2.auto_takes_kernel(
            cfg, audio.device, audio.shape[0], audio.shape[-1])
        backend = "pallas" if fused else "xla"
    return backend


def resolve_for_batch(cfg: AudioConfig, device: torch.device, batch: int) -> AudioConfig:
    """`cfg` with dsp_backend "auto" resolved for a global batch of `batch`
    rows on `device`: the rule JAX applies under jit, which sees the
    global shape, where a data-parallel rank holds only its rows."""
    if getattr(cfg, "dsp_backend", "xla") != "auto":
        return cfg
    from tcresnet_tpu_torch.ops.kernels import mfcc as k2

    fused = k2.auto_takes_kernel(cfg, device, batch, cfg.desired_samples)
    return dataclasses.replace(cfg, dsp_backend="pallas" if fused else "xla")


def preprocess(audio: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """Front-end dispatch: [..., N] wavs -> [..., H, W, 1] features, the
    JAX function's layout (trailing channel axis of 1).

    dsp_backend "pallas" runs a [B, N] batch through the fused kernel of
    the DFT variant (K2, K8 or K9; its plain version for a CPU tensor; a
    CUDA geometry that is not hop-decomposable takes the plain path, as in
    JAX, and one JAX's kernel takes but no kernel here serves raises:
    `ops.kernels.mfcc.fused_mfcc_route`); "xla" runs the plain per-op path;
    "auto" picks (`resolve_dsp_backend`)."""
    if cfg.preprocess_method in ("mfcc", "log_mel_spectrogram"):
        backend = resolve_dsp_backend(cfg, audio)
        if backend == "pallas" and audio.dim() == 2:
            from tcresnet_tpu_torch.ops.kernels import mfcc as k2

            feats = k2.fused_mfcc(audio, cfg)
        elif cfg.preprocess_method == "mfcc":
            feats = mfcc(audio, cfg)
        else:
            feats = log_mel_spectrogram(audio, cfg, magnitude_squared=False)
    elif cfg.preprocess_method == "no_preprocessing":
        feats = audio[..., :, None]
    else:
        raise ValueError(f"Unknown preprocess_method {cfg.preprocess_method!r}")
    return feats[..., None]
