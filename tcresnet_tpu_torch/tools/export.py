"""Export CLI of the port (counterpart of tools/export.py).

    python -m tcresnet_tpu_torch.tools.export --train-dir runs/x --output model.pt2
    python -m tcresnet_tpu_torch.tools.export --train-dir runs/x --best-metric accuracy \
        --fused-kernel --benchmark
    python -m tcresnet_tpu_torch.tools.export --train-dir runs/x --device cpu \
        --no-preprocess --output features.pt2

A run's checkpoint (the latest, `--step`, or with `--best-metric` the
promoted best under `<train-dir>/best/valid/<metric>`) with the run's own
`config.json` (the preset when the run has none) -> the compiled `xla`
path at one batch (`serve.export.compile_inference`: a CUDA graph on the
card, the `torch.export` program on the CPU), gated at 1e-5 in softmax:

  1. the compiled callable against `build_inference_fn` on the same input;
  2. with `--fused-kernel` and `--parity-precision highest`, the fused
     kernels (K4, or K2/K8/K9 + K5) against the `xla` path, both with TF32
     off in cuBLAS and cuDNN (`precision="highest"`); with `default` the
     agreement is printed, not gated;
  3. with `--output`, the serialized artifact (`export_serialized`,
     `torch.export` bytes) written, read back with `load_serialized` and
     held, TF32 off, to the `xla` path at `precision="highest"` (the
     artifact runs the per-op convs and front end, whatever the run
     trained with).

A failed gate exits non-zero. `--benchmark` prints the compiled callable's
host-timed latency and the device latency of the `xla` path (and of the
fused one), by the adaptive protocol of `serve.benchmark`, each beside the
card's name and power limit; it needs the card. `--device auto` is the
first CUDA card, `--device cpu` the host.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

PARITY_ATOL = 1e-5  # softmax, the repo's parity gate


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="TCResNet8-1.0",
                   help="the config when the run has no config.json")
    p.add_argument("--train-dir", required=True)
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--output", default=None, help="write the serialized artifact here")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--no-preprocess", action="store_true",
                   help="export the features -> softmax graph only")
    p.add_argument("--use-ema", action="store_true")
    p.add_argument("--benchmark", action="store_true",
                   help="time the compiled callable and the device path (the card only)")
    p.add_argument("--best-metric", default=None,
                   help="load the promoted best checkpoint for this valid metric (e.g. "
                        "accuracy) instead of the latest")
    p.add_argument("--fused-kernel", action="store_true",
                   help="also serve through the fused kernels (K4 for the temporal "
                        "TC-ResNets, K2/K8/K9 + K5 for the 2D families; needs the front end)")
    p.add_argument("--parity-precision", default="highest", choices=["default", "highest"],
                   help="highest: gate the fused-vs-xla agreement at 1e-5 with TF32 off in "
                        "both; default: print it only")
    p.add_argument("--device", choices=["auto", "cpu"], default="auto",
                   help="auto: the first CUDA card; cpu: the host")
    return p.parse_args(argv)


def _gate(log, what: str, err: float) -> None:
    log.info(f"{what}: max abs softmax err {err:.3e} (limit {PARITY_ATOL})")
    if not err <= PARITY_ATOL:
        raise SystemExit(f"{what}: parity gate failed, {err} > {PARITY_ATOL}")


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).abs().max().item()


def main(argv=None) -> dict:
    """Runs the export and its gates; returns what it measured (the gates'
    errors, the artifact's size, the timings) for a caller in-process."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    log = logging.getLogger("tcresnet_tpu_torch.export_cli")

    from tcresnet_tpu_torch.config import get_preset
    from tcresnet_tpu_torch.evaluation.best_keeper import BestKeeper
    from tcresnet_tpu_torch.serve.benchmark import (
        benchmark_compiled, benchmark_on_device, format_report)
    from tcresnet_tpu_torch.serve.export import (
        _with_matmul_precision, build_inference_fn, compile_inference, export_serialized,
        load_serialized)
    from tcresnet_tpu_torch.tools.train import load_run_config
    from tcresnet_tpu_torch.train.checkpoint import CheckpointManager
    from tcresnet_tpu_torch.utils.device import card_description, resolve_device

    device = resolve_device("cuda" if args.device == "auto" else "cpu")
    if args.benchmark and device.type != "cuda":
        raise SystemExit("--benchmark times the card: it needs --device auto")
    # rebuild the model exactly as trained: the run's config before the preset
    cfg = load_run_config(args.train_dir)
    if cfg is not None:
        log.info(f"config base: {args.train_dir}/config.json (run config)")
    else:
        cfg = get_preset(args.preset)

    ckpt, step = CheckpointManager(Path(args.train_dir) / "ckpt"), args.step
    if args.best_metric:
        best = BestKeeper({args.best_metric: "max"}, "valid",
                          Path(args.train_dir) / "best").best_checkpoint_dir(args.best_metric)
        if best is None:
            raise SystemExit(f"No promoted best checkpoint for valid/{args.best_metric}")
        ckpt = CheckpointManager(best)
        step = ckpt.latest_step()  # the best's own step, as JAX's CLI takes it
        log.info(f"using the best-{args.best_metric} checkpoint under {best}")
    raw = ckpt.restore_raw(step)
    variables = {k: raw[k] for k in ("params", "batch_stats", "ema_params")
                 if raw.get(k) is not None}
    include_preprocess = not args.no_preprocess
    common = dict(include_preprocess=include_preprocess, use_ema=args.use_ema, device=device)

    compiled, in_shape = compile_inference(cfg, variables, args.batch_size, **common)
    log.info(f"compiled inference on {device}: input {list(in_shape)} -> softmax")
    x = torch.tensor(np.random.default_rng(0).uniform(-1, 1, in_shape).astype(np.float32),
                     device=device)
    fn = build_inference_fn(cfg, variables, **common)
    ref = fn(x)
    out = {"device": str(device), "input_shape": list(in_shape),
           "compiled_err": _err(compiled(x), ref)}
    _gate(log, "compiled vs build_inference_fn", out["compiled_err"])

    # the gates' reference with TF32 off in cuBLAS and cuDNN
    hi_ref = (build_inference_fn(cfg, variables, precision="highest", **common)(x)
              if args.output or (args.fused_kernel and args.parity_precision == "highest")
              else None)
    fused_fn = None
    if args.fused_kernel:
        fused_fn = build_inference_fn(cfg, variables, backend="fused", **common)
        out["fused_err_default"] = _err(fused_fn(x), ref)
        log.info(f"fused kernels vs xla at PyTorch's default precision: max abs softmax err "
                 f"{out['fused_err_default']:.3e}")
        if args.parity_precision == "highest":
            hi_fused = build_inference_fn(cfg, variables, backend="fused",
                                          precision="highest", **common)
            out["fused_err_highest"] = _err(hi_fused(x), hi_ref)
            _gate(log, "fused kernels vs xla, TF32 off", out["fused_err_highest"])

    if args.output:
        data = export_serialized(cfg, variables, args.batch_size, **common)
        Path(args.output).write_bytes(data)
        log.info(f"wrote {len(data)} bytes to {args.output}")
        loaded = _with_matmul_precision(
            load_serialized(Path(args.output).read_bytes(), device=device), "highest")
        out["artifact_bytes"] = len(data)
        out["artifact_err"] = _err(loaded(x), hi_ref)
        _gate(log, "reloaded artifact vs xla, TF32 off", out["artifact_err"])

    if args.benchmark:
        card = card_description()
        timed = [("compiled", "host", benchmark_compiled(compiled, x)),
                 ("xla", "device", benchmark_on_device(fn, x))]
        if fused_fn is not None:
            timed.append(("fused", "device", benchmark_on_device(fused_fn, x)))
        for name, clock, stats in timed:
            extra = (f" repeats={stats['repeats']:.0f} converged={bool(stats['converged'])}"
                     if clock == "device" else "")
            log.info(f"{name} {clock} latency (us) B={args.batch_size}: "
                     f"{format_report(stats)}{extra} | {card}")
            out[f"{name}_{clock}_us"] = stats
    return out


if __name__ == "__main__":
    main()
