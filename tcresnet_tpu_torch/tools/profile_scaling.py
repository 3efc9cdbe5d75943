"""Stage times of the training step's input pipeline across batch sizes
(counterpart of tools/profile_scaling.py).

    python -m tcresnet_tpu_torch.tools.profile_scaling --batches 1024 2048 4096 8192
    python -m tcresnet_tpu_torch.tools.profile_scaling --dsp-backend pallas \
        --stages sample augment augment_xla mfcc mfcc_pallas gather_augment \
        gather_augment_mfcc step
    python -m tcresnet_tpu_torch.tools.profile_scaling --device cpu --batches 8 \
        --dataset-size 64 --n1 1 --n2 2 --stages sample augment_xla mfcc

Why does the train step's utt/s change with the batch? Each stage of
TCResNet8-1.0's input pipeline is timed alone on the synthetic dataset at
each batch size:

  sample               batch indices drawn on the device, rows gathered
                       and decoded (`DeviceDataset.sample_batch`)
  augment              + the augmentation of the decoded rows (K6 on the
                       card: `augment.backend` "auto")
  augment_xla          + the same through the plain version
  mfcc                 + augment, then the front end (`dsp.preprocess`;
                       K2 with `--dsp-backend pallas`)
  mfcc_pallas          + augment, then K2 (`kernels.mfcc.fused_mfcc`)
  gather_augment       indices, then gather + decode + augment in one pass
                       (`augment.augment_gathered`: K1 on the card)
  gather_augment_mfcc  + the front end
  step                 the whole step, `Trainer.train_steps` (the
                       `auto` rules: K1 and the front end, or K3 from batch
                       2048 with `--dsp-backend pallas`)

Every iteration draws from a generator seeded for (7, iteration)
(`train.trainer.step_seed`) and folds sum(x^2) of the stage's output into
a device accumulator. A stage's time per iteration is the difference of
two trip counts, (t(n2) - t(n1)) / (n2 - n1), which cancels what a run
costs once (the first enqueue, the final wait); the step stage runs one
call of `STEP_STEPS` (50) steps against five, as the JAX tool. Each
window starts after a synchronize and ends with one. On the card `us_per_iter` is read from
CUDA events over the two windows and `host_us_per_iter` from the host
clock over the same windows (the two agree but for the launch latency);
`enqueue_us_per_iter` is the host clock up to the end of the enqueue,
before the closing synchronize: near `us_per_iter` the device waited on
the host (or on a full launch queue), far below it the device was the
bottleneck. On the CPU all three are the host clock.
`launches` is what the stage launched of each kernel
(`ops.kernels.launch_counts`) over its warm-up and both windows. Prints
one JSON row per (stage, batch), each with the card's name and power
limit, then a table of `us_per_iter`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import tempfile
import time
from typing import Callable, Dict, List

import torch

from tcresnet_tpu_torch.config import get_preset
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.ops import augment as aug
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.ops.kernels import launch_counts, launches_since
from tcresnet_tpu_torch.train.trainer import Trainer, step_seed
from tcresnet_tpu_torch.utils.device import card_description, resolve_device

STAGES = ("sample", "augment", "augment_xla", "mfcc", "mfcc_pallas", "gather_augment",
          "gather_augment_mfcc", "step")
DEFAULT_STAGES = ["sample", "augment", "augment_xla", "mfcc", "step"]
PRESET = "TCResNet8-1.0"
DRAW_SEED = 7
STEP_STEPS = 50  # the step stage's steps a call
STEP_CALLS = 5  # the step stage's second trip count, in calls


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batches", type=int, nargs="+", default=[1024, 2048, 4096, 8192])
    p.add_argument("--stages", nargs="+", default=DEFAULT_STAGES, choices=STAGES)
    p.add_argument("--dataset-size", type=int, default=24_100)
    p.add_argument("--n1", type=int, default=10)
    p.add_argument("--n2", type=int, default=60)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--dsp-backend", default="xla", choices=["xla", "pallas", "auto"])
    p.add_argument("--conv-backend", default="xla", choices=["xla", "pallas"])
    p.add_argument("--device", choices=["auto", "cpu"], default="auto",
                   help="auto: the first CUDA card; cpu: the host")
    args = p.parse_args(argv)
    if not 0 < args.n1 < args.n2:
        p.error("--n1 and --n2 must satisfy 0 < n1 < n2")
    return args


def base_config(args: argparse.Namespace):
    cfg = get_preset(PRESET)
    return cfg.replace(audio=dataclasses.replace(cfg.audio, dsp_backend=args.dsp_backend),
                       model=dataclasses.replace(cfg.model, conv_backend=args.conv_backend))


def stage_body(stage: str, cfg, data: DeviceDataset, batch: int) -> Callable:
    """(iteration, accumulator) -> accumulator + sum(x^2) of the stage's
    output x for the draws of `iteration`."""
    clip = cfg.audio.desired_samples
    arrays, noise = data.arrays, data.noise_bank
    generator = torch.Generator(device=data.device)

    def body(i: int, acc: torch.Tensor) -> torch.Tensor:
        gen = generator.manual_seed(step_seed(DRAW_SEED, i))
        if stage in ("gather_augment", "gather_augment_mfcc"):
            idx, _, silent = DeviceDataset.sample_indices(arrays, gen, batch)
            x = aug.augment_gathered(arrays[0], idx, silent, gen, cfg.augment, noise,
                                     is_training=True, clip_len=clip)
            if stage == "gather_augment_mfcc":
                x = dsp.preprocess(x, cfg.audio)
            return acc + torch.sum(x.float() ** 2)
        x, _, silent = DeviceDataset.sample_batch(arrays, gen, batch, clip_len=clip)
        if stage in ("augment", "augment_xla", "mfcc", "mfcc_pallas"):
            aug_cfg = cfg.augment
            if stage == "augment_xla":
                aug_cfg = dataclasses.replace(aug_cfg, backend="xla")
            x = aug.augment(x, silent, gen, aug_cfg, noise, is_training=True)
        if stage == "mfcc":
            x = dsp.preprocess(x, cfg.audio)
        if stage == "mfcc_pallas":
            from tcresnet_tpu_torch.ops.kernels import mfcc as k2

            x = k2.fused_mfcc(x, cfg.audio)
        return acc + torch.sum(x.float() ** 2)

    return body


class _Window:
    """A host clock and, on the card, a pair of CUDA events around a block
    of work that ends in a synchronize; the host clock also at the end of
    the enqueue."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.sync = torch.cuda.synchronize if self.cuda else (lambda: None)

    def __enter__(self):
        self.sync()
        if self.cuda:
            self.events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.enqueue_s = time.perf_counter() - self.t0
        if self.cuda:
            self.events[1].record()
        self.sync()
        self.host_s = time.perf_counter() - self.t0
        self.device_s = (self.events[0].elapsed_time(self.events[1]) / 1e3 if self.cuda
                         else self.host_s)
        return False


def _difference(short: _Window, long: _Window, iters: int) -> Dict[str, float]:
    """Seconds an iteration on the device clock, the host clock and the
    host clock to the end of the enqueue, from two windows whose trip
    counts differ by `iters`."""
    return {"device": (long.device_s - short.device_s) / iters,
            "host": (long.host_s - short.host_s) / iters,
            "enqueue": (long.enqueue_s - short.enqueue_s) / iters}


def timed_loop(body: Callable, n1: int, n2: int, device: torch.device) -> Dict[str, float]:
    """Seconds an iteration of `body` from the n2 - n1 difference; two
    iterations warm it first. The accumulator is read at the end."""
    acc = torch.zeros((), device=device)
    for i in range(2):
        acc = body(i, acc)
    windows = []
    for n in (n1, n2):
        with _Window(device) as w:
            for i in range(n):
                acc = body(i, acc)
        windows.append(w)
    if not math.isfinite(float(acc)):
        raise RuntimeError(f"the stage's accumulator is {float(acc)}")
    return _difference(windows[0], windows[1], n2 - n1)


def step_seconds(cfg, data: DeviceDataset, batch: int, dtype: str,
                 steps_per_call: int = STEP_STEPS) -> Dict[str, float]:
    """Seconds a training step at `batch`: a Trainer's `train_steps` of
    `steps_per_call` steps, one call against `STEP_CALLS`, after a warm
    call."""
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=batch, max_step=10**9, compute_dtype=dtype))
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, data, workdir=tmp, steps_per_call=steps_per_call)
        float(trainer.train_steps(steps_per_call)["total_loss"])
        windows = []
        for calls in (1, STEP_CALLS):
            with _Window(data.device) as w:
                for _ in range(calls):
                    summary = trainer.train_steps(steps_per_call)
            windows.append(w)
        loss = float(summary["total_loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"the step stage's loss is {loss}")
    return _difference(windows[0], windows[1], (STEP_CALLS - 1) * steps_per_call)


def run(args: argparse.Namespace, data: DeviceDataset) -> List[dict]:
    """Every (batch, stage) row of `args` on `data`, printed as it comes,
    then the summary table."""
    cfg = base_config(args)
    card = card_description() if data.device.type == "cuda" else None
    results = []
    for batch in args.batches:
        for stage in args.stages:
            before = launch_counts()
            if stage == "step":
                sec = step_seconds(cfg, data, batch, args.dtype)
            else:
                sec = timed_loop(stage_body(stage, cfg, data, batch), args.n1, args.n2,
                                 data.device)
            row = {
                "stage": stage,
                "batch": batch,
                "us_per_iter": sec["device"] * 1e6,
                "us_per_utt": sec["device"] * 1e6 / batch,
                "utt_per_s": batch / sec["device"],
                "host_us_per_iter": sec["host"] * 1e6,
                "enqueue_us_per_iter": sec["enqueue"] * 1e6,
                "launches": launches_since(before),
                "device": str(data.device),
                "card": card,
            }
            results.append(row)
            print(json.dumps(row), flush=True)
    print(summary_table(results, args.batches, args.stages))
    return results


def summary_table(results: List[dict], batches: List[int], stages: List[str]) -> str:
    """Rows by batch, a column of us_per_iter by stage."""
    lines = ["", "batch | " + " | ".join(f"{s} µs" for s in stages)]
    for batch in batches:
        vals = [next((r["us_per_iter"] for r in results
                      if r["batch"] == batch and r["stage"] == s), float("nan"))
                for s in stages]
        lines.append(f"{batch:5d} | " + " | ".join(f"{v:10.1f}" for v in vals))
    return "\n".join(lines)


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    device = resolve_device("cuda" if args.device == "auto" else "cpu")
    from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset

    host = make_synthetic_dataset(num_samples=args.dataset_size, num_classes=12,
                                  desired_samples=16000, seed=0)
    return run(args, DeviceDataset(host, device))


if __name__ == "__main__":
    main()
