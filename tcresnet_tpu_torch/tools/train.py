"""Train CLI of the port (counterpart of tools/train.py).

    python -m tcresnet_tpu_torch.tools.prepare_dataset --extracted <gsc> --out <tree>
    python -m tcresnet_tpu_torch.tools.train --preset TCResNet8-1.0 \
        --dataset-root <tree> --cache-dir <cache> --train-dir runs/%DATE%_tc8
    python -m tcresnet_tpu_torch.tools.train --preset TCResNet8-1.0 \
        --synthetic --synthetic-samples 24100 --max-step 20 \
        --cfg model.conv_backend=pallas
    python -m tcresnet_tpu_torch.tools.train --preset DSCNNL --synthetic \
        --max-step 20 --cfg audio.dft_variant=radix4
    # transfer: every tensor but fc from another run, only fc trained
    python -m tcresnet_tpu_torch.tools.train --dataset-root <tree> --train-dir runs/ft \
        --checkpoint-path runs/tc8/ckpt --checkpoint-exclude-scopes fc \
        --cfg 'optim.trainable_scopes=["fc"]'
    # data parallel: 4 cards (mesh.data=-1, the default, takes every card)
    python -m tcresnet_tpu_torch.tools.train --synthetic --cfg mesh.data=4
    # 2 gloo ranks on the CPU
    python -m tcresnet_tpu_torch.tools.train --synthetic --device cpu --cfg mesh.data=2

Every preset trains (the 2D families too), from a `<root>/<split>/<label>/*.wav`
tree (`--dataset-root`, one root or several with the same labels; the
decode is cached under `--cache-dir`; oversampling, `data.oversampling_ratio`,
applies to the train split only) or from the synthetic dataset
(`--synthetic`). After training the last checkpoint is scored on
`--eval-split` (default valid; '' skips it) through the loop evaluator's
`evaluate_once`, which promotes it under `<train-dir>/best/<split>/`.
`--checkpoint-path` warm-starts from another run's checkpoint directory
(scopes are prefix-anchored regexes over Flax paths such as `fc`,
`block3` or `conv0_conv/kernel`; `--ignore-missing-vars` keeps fresh
values for names the checkpoint lacks or holds in another shape).
`--cfg SECTION.FIELD=VALUE` overrides any config field (JSON values;
unknown fields and values of the wrong type raise). `--train-dir` expands
%DATE%, %USER% and %<CONFIG_FIELD>%. `--device auto` trains on the CUDA
cards (and fails without one); `--device cpu` runs on the CPU, where every
kernel wrapper runs its plain version. The resolved config is written to
`<train-dir>/config.json`, which the evaluator
(`tcresnet_tpu_torch.tools.evaluate`) builds its model and data from.

Data parallelism (parallel/mesh.py): `mesh.data` x `mesh.model` ranks, as
the JAX CLI's make_mesh lays them out. With `--device auto` a rank a card
(mesh.data=-1, the default, takes every visible card: one card trains in
this process, as before); with `--device cpu` mesh.data=N runs N gloo
ranks on the CPU (-1: one). The CLI spawns its ranks itself, or is one
rank of a torchrun launch. Rank 0 writes the run's files and logs; a
rank's failure fails the command. `--profile-dir` writes a torch.profiler
trace of rank 0's training there, which carries the program's spans
(`utils/profiling.py`): `train.call` > `train.step` > `train.draw`,
`train.input`, `train.forward`, `train.backward` (with `train.all_reduce`
under a mesh), `train.optimizer`.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import getpass
import json
import logging
import types
import typing
from pathlib import Path


def expand_train_dir(train_dir: str, cfg=None) -> str:
    """%DATE% / %USER% / %<CONFIG_FIELD>% placeholder expansion (the
    reference's common/utils.py:22-59: any field name, e.g. %BATCH_SIZE%,
    becomes its value; a list is joined with commas, a value with a '/'
    becomes UNKNOWN)."""
    out = train_dir.replace(
        "%DATE%", datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    ).replace("%USER%", getpass.getuser())
    if cfg is not None and "%" in out:
        for section in dataclasses.fields(cfg):
            sub = getattr(cfg, section.name)
            for f in dataclasses.fields(sub):
                ph = f"%{f.name.upper()}%"
                if ph in out:
                    v = getattr(sub, f.name)
                    if isinstance(v, (list, tuple)):
                        v = ",".join(map(str, v))
                    v = str(v)
                    out = out.replace(ph, "UNKNOWN" if "/" in v else v)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="TCResNet8-1.0")
    p.add_argument("--dataset-root", nargs="+", default=None,
                   help="one <root>/<split>/<label>/*.wav tree, or several with the same "
                        "labels")
    p.add_argument("--cache-dir", default=None, help="where decoded splits are cached")
    p.add_argument("--train-dir", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic dataset (no Speech Commands needed)")
    p.add_argument("--synthetic-samples", type=int, default=4096)
    p.add_argument("--max-step", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default=None)
    p.add_argument("--eval-split", default="valid",
                   help="split evaluated after training ('' to skip)")
    p.add_argument("--num-silent", type=int, default=None,
                   help="silent rows added to each split (-1: samples // labels)")
    p.add_argument("--steps-per-call", type=int, default=None)
    p.add_argument("--step-save-checkpoint", type=int, default=None)
    p.add_argument("--clip-duration-ms", type=int, default=None)
    p.add_argument("--checkpoint-path", default=None,
                   help="warm-start params from another run's checkpoint directory")
    p.add_argument("--checkpoint-include-scopes", nargs="*", default=None)
    p.add_argument("--checkpoint-exclude-scopes", nargs="*", default=None)
    p.add_argument("--ignore-missing-vars", action="store_true")
    p.add_argument("--device", choices=["auto", "cpu"], default="auto",
                   help="auto: the CUDA cards (mesh.data of them); cpu: the host "
                        "(mesh.data gloo ranks)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of rank 0's training here, with "
                        "the program's spans")
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
    if getattr(args, "clip_duration_ms", None):
        cfg = cfg.replace(audio=dataclasses.replace(
            cfg.audio, clip_duration_ms=args.clip_duration_ms))
    if train_kw:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train_kw))
    data_kw = {}
    roots = getattr(args, "dataset_root", None)
    if roots:
        data_kw["dataset_root"] = roots[0] if len(roots) == 1 else tuple(roots)
    if getattr(args, "cache_dir", None):
        data_kw["cache_dir"] = args.cache_dir
    if args.synthetic:
        data_kw.update(use_synthetic=True, synthetic_num_samples=args.synthetic_samples)
    if data_kw:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, **data_kw))
    if getattr(args, "num_silent", None) is not None:
        cfg = cfg.replace(augment=dataclasses.replace(cfg.augment, num_silent=args.num_silent))
    cfg = apply_cfg_overrides(cfg, args.cfg)
    if "%" in cfg.train.train_dir:
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, train_dir=expand_train_dir(cfg.train.train_dir, cfg)))
    return cfg


def load_split(cfg, split: str):
    """One split of `cfg`'s data, as the JAX CLI loads it.

    Synthetic: train is seed 0 with data.synthetic_num_samples rows, every
    other split seed 1 with max(n // 8, 128) rows. A tree
    (data.dataset_root): `load_speech_commands` with the clip length, the
    silence count, the decode cache, the header rate checked, and
    oversampling on the train split only (the reference oversampled the
    training file list)."""
    from tcresnet_tpu_torch.data.speech_commands import load_speech_commands
    from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset

    if cfg.data.use_synthetic:
        n = cfg.data.synthetic_num_samples
        return make_synthetic_dataset(
            num_samples=n if split == "train" else max(n // 8, 128),
            num_classes=cfg.model.num_classes, desired_samples=cfg.audio.desired_samples,
            sample_rate=cfg.audio.sample_rate, seed=0 if split == "train" else 1, split=split)
    if not cfg.data.dataset_root:
        raise SystemExit("--dataset-root is required (or pass --synthetic)")
    return load_speech_commands(
        cfg.data.dataset_root, split, desired_samples=cfg.audio.desired_samples,
        num_silent=cfg.augment.num_silent, cache_dir=cfg.data.cache_dir or None,
        oversampling_ratio=cfg.data.oversampling_ratio if split == "train" else None,
        sample_rate=cfg.audio.sample_rate, add_null_class=cfg.data.add_null_class)


def mesh_devices(mesh_cfg, device: str) -> list:
    """The devices the mesh of `mesh_cfg` is laid over for `--device`:
    every visible card for "auto"; for "cpu" one CPU device a rank
    (mesh.data x mesh.model of them, or one for mesh.data=-1)."""
    import torch

    from tcresnet_tpu_torch.parallel import mesh as meshlib

    if device == "cpu":
        n = mesh_cfg.data * max(mesh_cfg.model, 1) if mesh_cfg.data > 0 else 1
        return [torch.device("cpu")] * n
    return meshlib.visible_devices()


def run_on_mesh(rank_fn, args, cfg, device: str):
    """rank_fn(mesh, args, cfg) on every rank of cfg.mesh over
    `mesh_devices`; a one-rank mesh runs in this process with no process
    group (mesh None, the device "cuda" or "cpu"). The result of a
    one-rank run, else the ranks' results in rank order."""
    from tcresnet_tpu_torch.parallel import mesh as meshlib

    devices = mesh_devices(cfg.mesh, device)
    data, model = meshlib.mesh_shape(cfg.mesh, len(devices))
    if data * model == 1 and meshlib.torchrun_rank() is None:
        return rank_fn(None, args, cfg)
    logging.getLogger("tcresnet_tpu_torch.cli").info(
        f"mesh: data={data} model={model} on {', '.join(map(str, devices[:data * model]))}")
    return meshlib.launch(rank_fn, args, cfg, cfg=cfg.mesh, devices=devices)


def setup_logging(mesh=None) -> None:
    """INFO on rank 0 (or without a mesh), warnings only on other ranks."""
    rank = "" if mesh is None else f"[rank {mesh.rank}] "
    logging.basicConfig(level=logging.INFO if mesh is None or mesh.is_chief else logging.WARNING,
                        format=f"%(asctime)s {rank}%(name)s: %(message)s",
                        force=mesh is not None)


def load_split_on(mesh, cfg, split: str):
    """`load_split` on every rank, rank 0 first: it fills the decode cache,
    which the other ranks then read. A split that cannot be loaded raises
    on every rank, after the barrier."""
    from tcresnet_tpu_torch.parallel import mesh as meshlib

    first = mesh is None or mesh.is_chief
    host = failed = None
    if first:
        try:
            host = load_split(cfg, split)
        except (FileNotFoundError, SystemExit) as e:
            failed = e
    meshlib.barrier(mesh)
    if failed is not None:
        raise failed
    return host if first else load_split(cfg, split)


def _train(mesh, args, cfg):
    """Train (and score `--eval-split`) as one rank of `mesh`, or alone
    with mesh None; the trainer alone, or {"step", "scores"} from a rank."""
    setup_logging(mesh)
    log = logging.getLogger("tcresnet_tpu_torch.train_cli")

    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.evaluation.watcher import WatchingEvaluator
    from tcresnet_tpu_torch.train.trainer import Trainer
    from tcresnet_tpu_torch.utils.profiling import trace

    if mesh is not None:
        device = mesh.device
    else:
        device = "cuda" if args.device == "auto" else "cpu"
    host = load_split_on(mesh, cfg, "train")
    trainer = Trainer(cfg, DeviceDataset(host, device), workdir=cfg.train.train_dir,
                      steps_per_call=args.steps_per_call, mesh=mesh)
    if args.checkpoint_path:
        trainer.warm_start(args.checkpoint_path,
                           include_scopes=args.checkpoint_include_scopes,
                           exclude_scopes=args.checkpoint_exclude_scopes,
                           ignore_missing=args.ignore_missing_vars)
    with trace(args.profile_dir if trainer.chief else None):
        state = trainer.train(cfg.train.max_step)
    log.info(f"training done at step {int(state.step)}")

    scores = None
    if args.eval_split:
        try:
            eval_host = load_split_on(mesh, cfg, args.eval_split)
        except (FileNotFoundError, SystemExit) as e:
            log.warning(f"skipping eval: {e}")
            eval_host = None
        if eval_host is not None:
            watcher = WatchingEvaluator(cfg, DeviceDataset(eval_host, device), trainer.workdir,
                                        mesh=mesh)
            scores = watcher.evaluate_once(int(state.step))
            log.info(f"{args.eval_split}: accuracy {scores['accuracy']:.4f} "
                     f"loss {scores['loss']:.4f}")
    if mesh is None:
        return trainer
    return {"step": int(state.step), "scores": scores}


def main(argv=None):
    """Train; returns the Trainer of a one-rank run, else the ranks'
    {"step", "scores"} in rank order."""
    args = parse_args(argv)
    setup_logging()
    return run_on_mesh(_train, args, build_config(args), args.device)


if __name__ == "__main__":
    main()
