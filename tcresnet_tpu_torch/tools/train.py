"""Train CLI of the port (counterpart of tools/train.py:50-74).

    python -m tcresnet_tpu_torch.tools.train --preset TCResNet8-1.0 \
        --synthetic --synthetic-samples 24100 --max-step 20

Takes the subset of the JAX CLI's flags that this slice serves. The
Speech Commands loader is not ported yet, so --synthetic is required.
`--device auto` trains on the first CUDA card (and fails without one);
`--device cpu` runs on the CPU, where every kernel wrapper runs its plain
version.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="TCResNet8-1.0")
    p.add_argument("--train-dir", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic dataset (the only data this slice loads)")
    p.add_argument("--synthetic-samples", type=int, default=4096)
    p.add_argument("--max-step", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default=None)
    p.add_argument("--steps-per-call", type=int, default=None)
    p.add_argument("--step-save-checkpoint", type=int, default=None)
    p.add_argument("--device", choices=["auto", "cpu"], default="auto",
                   help="auto: the first CUDA card; cpu: the host")
    return p.parse_args(argv)


def build_config(args):
    from tcresnet_tpu.config import get_preset

    cfg = get_preset(args.preset)
    train_kw = {field: getattr(args, field) for field in (
        "max_step", "batch_size", "seed", "compute_dtype", "step_save_checkpoint",
        "train_dir") if getattr(args, field) is not None}
    if train_kw:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train_kw))
    if args.synthetic:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, use_synthetic=True, synthetic_num_samples=args.synthetic_samples))
    return cfg


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    cfg = build_config(args)
    if not cfg.data.use_synthetic:
        raise SystemExit("the Speech Commands loader is not ported yet: pass --synthetic")

    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset
    from tcresnet_tpu_torch.train.trainer import Trainer

    device = "cuda" if args.device == "auto" else "cpu"
    host = make_synthetic_dataset(
        num_samples=cfg.data.synthetic_num_samples, num_classes=cfg.model.num_classes,
        desired_samples=cfg.audio.desired_samples, sample_rate=cfg.audio.sample_rate,
        seed=0, split="train")
    trainer = Trainer(cfg, DeviceDataset(host, device), workdir=cfg.train.train_dir,
                      steps_per_call=args.steps_per_call)
    state = trainer.train(cfg.train.max_step)
    logging.getLogger("tcresnet_tpu_torch.train_cli").info(
        f"training done at step {int(state.step)}")
    return trainer


if __name__ == "__main__":
    main()
