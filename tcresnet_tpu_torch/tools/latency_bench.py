"""Per-model inference latency of the PyTorch port on a CUDA card.

    python -m tcresnet_tpu_torch.tools.latency_bench --models TCResNet8-1.0
    python -m tcresnet_tpu_torch.tools.latency_bench --models Res15 DSCNNL KWSfpool3
    python -m tcresnet_tpu_torch.tools.latency_bench --batch-size 1024

For each preset (all 15 by default), wav -> softmax at the given batch
through the plain path (backend="xla") and through the fused kernels
(backend="fused": K4 for the temporal TC-ResNets, K2 + K5 for the 2D
families, K8 or K9 in the place of K2 under dft_variant "phases" or
"radix4"),
timed two ways (serve/benchmark.py): CUDA events around each call
(device µs) and the host clock around each synchronised call (host µs).
Weights are made from a seed: latency does not depend on their values.
Prints one JSON row per model, each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tcresnet_tpu_torch.config import PRESETS, get_preset
from tcresnet_tpu_torch.models import param_count
from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.serve.benchmark import benchmark_compiled, benchmark_on_device
from tcresnet_tpu_torch.serve.export import build_inference_fn
from tcresnet_tpu_torch.utils.device import card_description, resolve_device

SUPPORTED = tuple(PRESETS)


def bench_model(name: str, batch_size: int, device: torch.device, card: str) -> dict:
    cfg = get_preset(name)
    variables = variables_from_jax(
        cfg.model, **seeded_variables(cfg.model, dsp.feature_shape(cfg.audio), seed=0))
    x = torch.tensor(
        np.random.default_rng(0).uniform(
            -1, 1, (batch_size, cfg.audio.desired_samples)).astype(np.float32),
        device=device)
    row = {"model": name, "params": param_count(variables["params"]),
           "input": f"{batch_size}x{cfg.audio.desired_samples}", "card": card}
    for label, backend in (("plain", "xla"), ("fused", "fused")):
        fn = build_inference_fn(cfg, variables, backend=backend, device=device)
        dev = benchmark_on_device(fn, x)
        host = benchmark_compiled(fn, x)
        row[f"{label}_device_median_us"] = dev["median"]
        row[f"{label}_device_spread_us"] = [dev["min"], dev["max"]]
        row[f"{label}_host_avg_us"] = host["avg"]
    return row


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--models", nargs="+", default=list(SUPPORTED))
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="a CUDA device; the timings need one")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("latency_bench times the card: --device must be a CUDA device")
    card = card_description()
    for name in args.models:
        print(json.dumps(bench_model(name, args.batch_size, device, card)), flush=True)


if __name__ == "__main__":
    main()
