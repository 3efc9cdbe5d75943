"""Inference latency harness (counterpart of tcresnet_tpu/serve/benchmark.py).

The reference's benchmark_model protocol: 10 warmup runs + 50 timed
runs, single stream, count/first/min/max/avg/std in microseconds.

  benchmark_compiled  — host clock around each call, ended by
      torch.cuda.synchronize() for a CUDA input (PyTorch returns before
      the device finishes, so without it the host clock times the enqueue).
      This is the latency a caller sees, launch overhead included.
  benchmark_on_device — CUDA events around each call on the current
      stream: the device-side span of one inference, without the host's
      wait, sampled as the mean over a block of calls and repeated by the
      JAX package's adaptive rule (`sample_until_converged`). Needs a CUDA
      input; there is no CPU substitute.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch


def _stats(times: np.ndarray, first: float) -> Dict[str, float]:
    return {
        "count": float(len(times)),
        "first": first,
        "curr": float(times[-1]),
        "min": float(times.min()),
        "max": float(times.max()),
        "avg": float(times.mean()),
        "median": float(np.median(times)),
        "std": float(times.std()),
    }


@torch.no_grad()
def benchmark_compiled(
    fn: Callable, example: torch.Tensor, warmup_runs: int = 10, num_runs: int = 50
) -> Dict[str, float]:
    """Host-timed `fn(example)`, reference protocol; times in µs."""
    sync = torch.cuda.synchronize if example.is_cuda else (lambda: None)

    def run():
        fn(example)
        sync()

    t0 = time.perf_counter()
    run()
    first = (time.perf_counter() - t0) * 1e6
    for _ in range(warmup_runs - 1):
        run()
    times = np.empty(num_runs)
    for i in range(num_runs):
        t0 = time.perf_counter()
        run()
        times[i] = (time.perf_counter() - t0) * 1e6
    return _stats(times, first)


def _trimmed(samples: np.ndarray) -> np.ndarray:
    """Sorted samples without the best and the worst once there are 8 or
    more: a single hiccup is not signal."""
    arr = np.sort(samples)
    return arr[1:-1] if len(arr) >= 8 else arr


def sample_until_converged(
    sample: Callable[[], float], repeats: int = 5, max_repeats: int = 41,
    target_spread: float = 0.5,
) -> Tuple[List[float], bool]:
    """The JAX package's adaptive repeats (tcresnet_tpu/serve/benchmark.py
    `benchmark_on_device`): take at least `repeats` samples, then stop
    once the trimmed spread (max - min of `_trimmed`) is within
    `target_spread` of the median of all samples (0.5 = +-25%), or after
    `max_repeats`. -> (samples in the order taken, converged)."""
    samples: List[float] = []
    while len(samples) < max(max_repeats, 1):
        samples.append(sample())
        if len(samples) < max(repeats, 2):
            continue
        trimmed = _trimmed(np.asarray(samples))
        med = float(np.median(samples))
        if med > 0 and float(trimmed[-1] - trimmed[0]) <= target_spread * med:
            return samples, True
    return samples, False


def adaptive_stats(samples: List[float], converged: bool) -> Dict[str, float]:
    """The JAX package's statistics of adaptive samples: `avg` the median
    of all, `min`, `max` and `std` over the trimmed set, and what they
    rest on (`repeats`, `converged`)."""
    trimmed = _trimmed(np.asarray(samples))
    return {
        "avg": float(np.median(samples)),
        "min": float(trimmed.min()),
        "max": float(trimmed.max()),
        "std": float(trimmed.std()),
        "repeats": float(len(samples)),
        "converged": float(converged),
    }


@torch.no_grad()
def benchmark_on_device(
    fn: Callable, example: torch.Tensor, warmup_runs: int = 10, num_runs: int = 50,
    repeats: int = 5, max_repeats: int = 41, target_spread: float = 0.5,
) -> Dict[str, float]:
    """Per-call device time of `fn(example)` from CUDA events; µs.

    A sample is one block of `num_runs` calls enqueued back to back, each
    between its own pair of events, read after one synchronize: the mean
    of their spans. A path made of many small kernels also counts the
    gaps between them that the host leaves. Samples repeat by the JAX
    package's rule (`sample_until_converged`, the same keyword arguments
    and defaults; JAX's `chain_factor`, its second trip count that cancels
    the host's round trip, has no counterpart: events see none). `avg` is
    the median sample, `min`, `max` and `std` are over the trimmed
    samples, `repeats` and `converged` say what they rest on, `count` is
    the calls per sample, `first` the first call's span, `curr` the last
    sample and `median` the median span of every timed call
    (`repeats=1, max_repeats=1`: one block, read as a median of calls)."""
    if not example.is_cuda:
        raise ValueError("benchmark_on_device needs a CUDA input")
    start = [torch.cuda.Event(enable_timing=True) for _ in range(num_runs + 1)]
    end = [torch.cuda.Event(enable_timing=True) for _ in range(num_runs + 1)]
    start[0].record()
    fn(example)
    end[0].record()
    for _ in range(warmup_runs - 1):
        fn(example)
    torch.cuda.synchronize()
    first = start[0].elapsed_time(end[0]) * 1e3

    spans: List[float] = []

    def block_mean() -> float:
        for i in range(1, num_runs + 1):
            start[i].record()
            fn(example)
            end[i].record()
        torch.cuda.synchronize()
        block = [s.elapsed_time(e) * 1e3 for s, e in zip(start[1:], end[1:])]
        spans.extend(block)
        return float(np.mean(block))

    samples, converged = sample_until_converged(block_mean, repeats, max_repeats,
                                                target_spread)
    return {"count": float(num_runs), "first": first, "curr": samples[-1],
            "median": float(np.median(spans)), **adaptive_stats(samples, converged)}


def format_report(stats: Dict[str, float]) -> str:
    """One line in the benchmark_model output style."""
    return (
        f"count={stats['count']:.0f} first={stats['first']:.0f} "
        f"curr={stats['curr']:.0f} min={stats['min']:.0f} "
        f"max={stats['max']:.0f} avg={stats['avg']:.2f} std={stats['std']:.0f}"
    )
