"""Train CLI of the port (counterpart of tools/train.py).

    python -m tcresnet_tpu_torch.tools.train --preset TCResNet8-1.0 \
        --synthetic --synthetic-samples 24100 --max-step 20 \
        --cfg model.conv_backend=pallas
    python -m tcresnet_tpu_torch.tools.train --preset DSCNNL --synthetic \
        --max-step 20 --cfg audio.dft_variant=radix4

Every preset trains (the 2D families too). Takes the subset of the JAX
CLI's flags that the port serves, and
`--cfg SECTION.FIELD=VALUE` overrides (JSON values; unknown fields and
values of the wrong type raise). The Speech Commands loader is not
ported yet, so --synthetic is required. `--device auto` trains on the
first CUDA card (and fails without one); `--device cpu` runs on the CPU,
where every kernel wrapper runs its plain version. The resolved config
is written to `<train-dir>/config.json`, which the evaluator
(`tcresnet_tpu_torch.tools.evaluate`) builds its model from.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import types
import typing
from pathlib import Path


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
    p.add_argument("--cfg", action="append", default=[], metavar="SECTION.FIELD=VALUE",
                   help="config override, e.g. --cfg model.conv_backend=pallas "
                        "--cfg optim.lr_list='[0.1,0.01]' (JSON values)")
    return p.parse_args(argv)


def _declared_type(sub, field: str):
    """The dataclass field's declared type, Optional[...] unwrapped (None
    when it is a union of several types or not declared)."""
    declared = typing.get_type_hints(type(sub)).get(field)
    if typing.get_origin(declared) in (typing.Union, types.UnionType):
        args = [a for a in typing.get_args(declared) if a is not type(None)]
        declared = args[0] if len(args) == 1 else None
    return declared


def _coerce(old, declared, val, path: str, raw: str):
    """`val` checked against the field's current value, or against its
    declared type when the current value is None."""
    kind = type(old) if old is not None else declared
    if kind is bool:
        if not isinstance(val, bool):
            raise SystemExit(f"--cfg {path} expects a JSON bool, got {raw!r}")
    elif kind in (int, float):
        if isinstance(val, bool) or not isinstance(val, (int, float)) or (
                kind is int and old is None and not isinstance(val, int)):
            raise SystemExit(f"--cfg {path} expects a number, got {raw!r}")
        val = kind(val)
    elif kind is str:
        if not isinstance(val, str):
            raise SystemExit(f"--cfg {path} expects a string, got {raw!r}")
    elif (kind is tuple or typing.get_origin(kind) is tuple) and not isinstance(val, tuple):
        raise SystemExit(f"--cfg {path} expects a JSON list, got {raw!r}")
    return val


def apply_cfg_overrides(cfg, items):
    """Apply SECTION.FIELD=VALUE overrides (the JAX CLI's
    apply_cfg_overrides): values are JSON, bare strings stay strings,
    lists become tuples; unknown fields and mistyped values raise."""
    for item in items:
        path, sep, raw = item.partition("=")
        if not sep:
            raise SystemExit(f"--cfg expects SECTION.FIELD=VALUE, got {item!r}")
        section, sep2, field = path.partition(".")
        sub = getattr(cfg, section, None)
        if not sep2 or sub is None or not dataclasses.is_dataclass(sub) or not hasattr(sub, field):
            raise SystemExit(f"Unknown config field {path!r}")
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw  # bare strings, e.g. model.conv_backend=pallas
        if isinstance(val, list):
            val = tuple(val)
        val = _coerce(getattr(sub, field), _declared_type(sub, field), val, path, raw)
        cfg = cfg.replace(**{section: dataclasses.replace(sub, **{field: val})})
    return cfg


def load_run_config(train_dir):
    """The config a run was trained with (`<train_dir>/config.json`, written
    by the Trainer), or None."""
    from tcresnet_tpu_torch.config import ExperimentConfig

    path = Path(train_dir) / "config.json" if train_dir else None
    if path and path.is_file():
        return ExperimentConfig.from_json(path.read_text())
    return None


def build_config(args, base=None):
    from tcresnet_tpu_torch.config import get_preset

    cfg = base if base is not None else get_preset(args.preset)
    train_kw = {field: getattr(args, field) for field in (
        "max_step", "batch_size", "seed", "compute_dtype", "step_save_checkpoint",
        "train_dir") if getattr(args, field, None) is not None}
    if train_kw:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train_kw))
    if args.synthetic:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, use_synthetic=True, synthetic_num_samples=args.synthetic_samples))
    return apply_cfg_overrides(cfg, args.cfg)


def load_split(cfg, split: str):
    """The synthetic split of `cfg` as the JAX CLI builds it: train is seed
    0 with data.synthetic_num_samples rows, every other split seed 1 with
    max(n // 8, 128) rows."""
    from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset

    if not cfg.data.use_synthetic:
        raise SystemExit("the Speech Commands loader is not ported yet: pass --synthetic")
    n = cfg.data.synthetic_num_samples
    return make_synthetic_dataset(
        num_samples=n if split == "train" else max(n // 8, 128),
        num_classes=cfg.model.num_classes, desired_samples=cfg.audio.desired_samples,
        sample_rate=cfg.audio.sample_rate, seed=0 if split == "train" else 1, split=split)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    cfg = build_config(args)
    host = load_split(cfg, "train")

    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.train.trainer import Trainer

    device = "cuda" if args.device == "auto" else "cpu"
    trainer = Trainer(cfg, DeviceDataset(host, device), workdir=cfg.train.train_dir,
                      steps_per_call=args.steps_per_call)
    state = trainer.train(cfg.train.max_step)
    logging.getLogger("tcresnet_tpu_torch.train_cli").info(
        f"training done at step {int(state.step)}")
    return trainer


if __name__ == "__main__":
    main()
