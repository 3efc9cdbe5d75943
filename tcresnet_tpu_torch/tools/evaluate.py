"""Evaluate CLI of the port (counterpart of tools/evaluate.py:27-144).

    # the loop evaluator beside a trainer: score every checkpoint, promote bests
    python -m tcresnet_tpu_torch.tools.evaluate --train-dir runs/x --synthetic \
        --split valid --valid-type loop
    # once: the latest checkpoint, one step, or a promoted best
    python -m tcresnet_tpu_torch.tools.evaluate --train-dir runs/x --synthetic \
        --split valid --valid-type once --best-metric accuracy
    # the test split of the run's Speech Commands tree
    python -m tcresnet_tpu_torch.tools.evaluate --train-dir runs/x --split test

The config is the run's `config.json` (the preset when the run has none),
with the flags and `--cfg SECTION.FIELD=VALUE` overrides on top, so the
model is built as it was trained: a run trained with
model.conv_backend=pallas is scored through K7's forward. The split comes
from the run's data (its tree, or the synthetic dataset) through the
train CLI's `load_split`; `--dataset-root` and `--cache-dir` point at
another tree or cache.
`--seed`, `--compute-dtype`, `--num-silent` and `--clip-duration-ms` set
the same fields as the train CLI's flags (tools/run_experiment.py forwards
them to both). `--device auto` evaluates on the CUDA cards; `--device
cpu` on the CPU, through the plain versions. The run's `mesh` section (or
`--cfg mesh.data=N`) lays the evaluation over ranks as the train CLI lays
training: each batch split over the data axis, rank 0 keeping the bests.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from pathlib import Path

from tcresnet_tpu_torch.tools.train import build_config, load_run_config, load_split_on
from tcresnet_tpu_torch.tools.train import run_on_mesh, setup_logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="TCResNet8-1.0")
    p.add_argument("--train-dir", required=True)
    p.add_argument("--dataset-root", nargs="+", default=None,
                   help="the tree(s) to score (default: the run's)")
    p.add_argument("--cache-dir", default=None, help="where decoded splits are cached")
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic dataset (no Speech Commands needed)")
    p.add_argument("--synthetic-samples", type=int, default=None,
                   help="rows of the synthetic train split the other splits are sized "
                        "from (default: the run's config)")
    p.add_argument("--split", default="valid")
    p.add_argument("--valid-type", choices=["once", "loop"], default="once")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step for --valid-type once (default: the latest)")
    p.add_argument("--max-step", type=int, default=None)
    p.add_argument("--timeout", type=float, default=None,
                   help="loop mode: stop after this many idle seconds")
    p.add_argument("--batch-size", type=int, default=None, help="data.eval_batch_size")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default=None)
    p.add_argument("--num-silent", type=int, default=None,
                   help="silent rows added to the split (-1: samples // labels)")
    p.add_argument("--clip-duration-ms", type=int, default=None)
    p.add_argument("--best-metric", default=None,
                   help="once mode: score the promoted best checkpoint for this metric, "
                        "<train-dir>/best/<best-split>/<metric>")
    p.add_argument("--best-split", default="valid",
                   help="the split whose promoted best --best-metric loads")
    p.add_argument("--device", choices=["auto", "cpu"], default="auto",
                   help="auto: the CUDA cards (mesh.data of them); cpu: the host (plain "
                        "versions; mesh.data gloo ranks)")
    p.add_argument("--cfg", action="append", default=[], metavar="SECTION.FIELD=VALUE",
                   help="config override on top of the run's config.json")
    return p.parse_args(argv)


def main(argv=None):
    """Evaluate; the scores (of rank 0 under a mesh: every rank's are
    equal)."""
    args = parse_args(argv)
    setup_logging()
    log = logging.getLogger("tcresnet_tpu_torch.eval_cli")
    base = load_run_config(args.train_dir)
    if args.synthetic_samples is None:
        args.synthetic_samples = (base.data.synthetic_num_samples if base is not None
                                  else 4096)
    cfg = build_config(args, base=base)
    if args.batch_size:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, eval_batch_size=args.batch_size))
    if base is not None:
        log.info(f"config base: {args.train_dir}/config.json (run config)")
    scores = run_on_mesh(_evaluate, args, cfg, args.device)
    return scores[0] if isinstance(scores, list) else scores


def _evaluate(mesh, args, cfg):
    """Score as one rank of `mesh` (alone with mesh None)."""
    setup_logging(mesh)
    log = logging.getLogger("tcresnet_tpu_torch.eval_cli")
    host = load_split_on(mesh, cfg, args.split)

    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.evaluation.best_keeper import BestKeeper
    from tcresnet_tpu_torch.evaluation.watcher import WatchingEvaluator
    from tcresnet_tpu_torch.train.checkpoint import CheckpointManager

    if mesh is not None:
        device = mesh.device
    else:
        device = "cuda" if args.device == "auto" else "cpu"
    watcher = WatchingEvaluator(cfg, DeviceDataset(host, device), args.train_dir, mesh=mesh)
    if args.valid_type == "loop":
        scores = watcher.watch(max_step=args.max_step, timeout=args.timeout)
    else:
        if args.best_metric:
            best = BestKeeper({args.best_metric: "max"}, args.best_split,
                              Path(args.train_dir) / "best").best_checkpoint_dir(args.best_metric)
            if best is None:
                raise SystemExit(f"No promoted best checkpoint for "
                                 f"{args.best_split}/{args.best_metric}")
            watcher.ckpt = CheckpointManager(best)
            log.info(f"loading best-{args.best_split}/{args.best_metric} from {best}")
        step = args.step if args.step is not None else watcher.ckpt.latest_step()
        if step is None:
            raise SystemExit(f"No checkpoints under {watcher.ckpt.directory}")
        scores = watcher.evaluate_once(step)
    for k in sorted(scores or {}):
        if not isinstance(scores[k], str) and "/" not in k:
            log.info(f"{args.split}/{k}: {scores[k]:.5f}")
    return scores


if __name__ == "__main__":
    main()
