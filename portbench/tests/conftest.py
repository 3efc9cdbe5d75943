"""Shared pieces of the benchmark's tests.

Tests that need a CUDA card carry the `cuda` marker and take the
`cuda_device` fixture, which skips where there is none; whether a card is
there is decided inside the fixture, never while a module is imported.
`small_cell(name)` is a cell of BENCHMARK.json cut to a size a CPU test run
holds (64 clips; training at batch 8; serving 250 ms clips in batches of 28-40).
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TRAIN, SERVE = "tcresnet8_train_b8192", "res15_serve_streams"
SEED = 2 ** 31 + 12345  # past 32 signed bits, as the driver's seeds are


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def shrink(cell):
    """`cell` (spec.Cell) cut to a CPU test's size, in place."""
    c = cell.config
    c["dataset"] = {**c["dataset"], "clips": 64}
    if cell.traffic["kind"] == "train":
        c["train"] = {**c["train"], "batch_size": 8}
        cell.traffic.update(steps_per_call=2, warmup_calls=1, trace_calls=2, profile_calls=1,
                            probe_iters=2)
    else:  # 250 ms clips, batches on both sides of the fused route's 32
        c["audio"] = {**c["audio"], "clip_duration_ms": 250}
        c["dataset"] = {**c["dataset"], "samples": 4000, "noise_samples": 8000}
        c["weights"] = {**c["weights"], "calibration_clips": 8}
        cell.traffic.update(pool_clips=64, check_per_route=2, trace_requests=3,
                            profile_requests=2,
                            batch={"min": 28, "max": 40, "grid": 8})
    return cell


@pytest.fixture
def small_cell():
    from portbench.harness import spec

    def make(name):
        return shrink(spec.load_cell(name))

    return make


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 4))
    yield
    torch.set_num_threads(prev)
