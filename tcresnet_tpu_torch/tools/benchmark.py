"""Benchmark sweep across model presets (counterpart of tools/benchmark.py).

    python -m tcresnet_tpu_torch.tools.benchmark
    python -m tcresnet_tpu_torch.tools.benchmark --presets TCResNet8-1.0 DSCNNL \
        --batch 1024 --conv-backend pallas --out bench_report.json
    python -m tcresnet_tpu_torch.tools.benchmark --device cpu --presets DSCNNS \
        --batch 4 --steps-per-call 1 --num-samples 64

For each preset (any of the 15; six by default, as in the JAX tool):

  train   a Trainer on the synthetic dataset, one warm call of
          `train_steps(steps_per_call)`, then three calls timed on the host
          clock, each ended by reading its loss on the host:
          `train_utt_per_sec`, `train_ms_per_step`; `flops_per_step`
          (`utils.profiling.step_flops`, the plain path's count, the same
          for every backend) and the rate it gives, `train_tflops_per_sec`;
  serve   the `xla` path compiled for batch 1 (`serve.export.compile_inference`:
          a CUDA graph on the card) on a seeded wav: `host_e2e_us`, the
          reference protocol on the host clock around each synchronised
          call (`serve.benchmark.benchmark_compiled`), and on the card
          `device_us`, CUDA events by the adaptive protocol
          (`benchmark_on_device`); null on the CPU, which has no device
          clock.

Weights are random, from the config's seed. `--conv-backend` overrides
every preset's `model.conv_backend` ("pallas": every temporal conv through
K7; the 2D families' convs are cuDNN's either way); the input path follows
the preset's `auto` rules (K1 on the card). Prints one JSON row per preset,
each with the card's name and power limit, and writes them all to `--out`.
A preset that raises is recorded as {"preset", "error"} and the sweep goes
on; the command then exits 1. `--device auto` is the first CUDA card (and
fails without one); `--device cpu` runs on the host, through the kernels'
plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import tempfile
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from tcresnet_tpu_torch.config import get_preset
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.models import layers
from tcresnet_tpu_torch.serve.benchmark import benchmark_compiled, benchmark_on_device
from tcresnet_tpu_torch.serve.export import compile_inference
from tcresnet_tpu_torch.train.trainer import Trainer
from tcresnet_tpu_torch.utils.device import card_description, resolve_device
from tcresnet_tpu_torch.utils.profiling import step_flops
from tcresnet_tpu_torch.utils.timing import Timer

DEFAULT_PRESETS = [
    "TCResNet8-1.0",
    "TCResNet14-1.5",
    "DSCNNS",
    "KWSfpool3",
    "Res8",
    "Res15",
]
TIMED_CALLS = 3


def bench_preset(name: str, batch: int, steps_per_call: int, dtype: str, data: DeviceDataset,
                 conv_backend: Optional[str] = None) -> dict:
    """One preset's row: train throughput, its FLOP rate and the compiled
    batch-1 serving latency, on `data`'s device."""
    device = data.device
    cfg = get_preset(name)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=batch, max_step=10**9, compute_dtype=dtype))
    if conv_backend:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, conv_backend=conv_backend))
    result = {"preset": name, "batch": batch, "compute_dtype": dtype, "device": str(device)}
    if conv_backend:
        result["conv_backend"] = conv_backend

    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, data, workdir=tmp, steps_per_call=steps_per_call)
        float(trainer.train_steps(steps_per_call)["total_loss"])  # warm, and a sync
        with Timer() as timer:
            for _ in range(TIMED_CALLS):
                loss = float(trainer.train_steps(steps_per_call)["total_loss"])
        if not math.isfinite(loss) or loss < 0:
            raise RuntimeError(f"{name}: training loss {loss}")
        steps = steps_per_call * TIMED_CALLS
        result["train_utt_per_sec"] = batch * steps / timer.elapsed
        result["train_ms_per_step"] = timer.elapsed / steps * 1e3
        result["flops_per_step"] = step_flops(cfg, batch)
        result["train_tflops_per_sec"] = result["flops_per_step"] * steps / timer.elapsed / 1e12

        variables = {"params": trainer.state.params, "batch_stats": trainer.state.batch_stats}
        compiled, in_shape = compile_inference(cfg, variables, batch_size=1, device=device)
    x = torch.tensor(np.random.default_rng(0).uniform(-1, 1, in_shape).astype(np.float32),
                     device=device)
    result["host_e2e_us"] = _latency(benchmark_compiled(compiled, x))
    result["device_us"] = _latency(benchmark_on_device(compiled, x)) if x.is_cuda else None
    return result


def _latency(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k != "count"}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--presets", nargs="*", default=DEFAULT_PRESETS)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--steps-per-call", type=int, default=10)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--num-samples", type=int, default=8192)
    p.add_argument("--conv-backend", default=None,
                   help="override ModelConfig.conv_backend for every preset: xla or pallas")
    p.add_argument("--device", choices=["auto", "cpu"], default="auto",
                   help="auto: the first CUDA card; cpu: the host")
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.conv_backend:
        layers.check_conv_backend(args.conv_backend)
    device = resolve_device("cuda" if args.device == "auto" else "cpu")
    card = card_description() if device.type == "cuda" else None

    from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset

    host = make_synthetic_dataset(num_samples=args.num_samples, num_classes=12,
                                  desired_samples=16000)
    data = DeviceDataset(host, device)
    results = []
    for name in args.presets:
        print(f"benchmarking {name}...", file=sys.stderr, flush=True)
        try:
            r = bench_preset(name, args.batch, args.steps_per_call, args.dtype, data,
                             args.conv_backend)
            r["card"] = card
        except Exception as e:  # record it, and go on with the sweep
            traceback.print_exc()
            r = {"preset": name, "error": f"{type(e).__name__}: {e}"[:300]}
        results.append(r)
        print(json.dumps(r), flush=True)

    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=2))
        print(f"wrote {args.out}", file=sys.stderr)
    failed = [r["preset"] for r in results if "error" in r]
    if failed:
        print(f"failed presets: {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
