"""Data-parallel parity and step times of the port on CUDA cards.

The rank functions of chip_smoke.py's phase 28, for `parallel.mesh.launch`
(or called with mesh None for one process): every rank
trains TCResNet8-1.0 at full width on the synthetic dataset (made from a
seed in each process) through the port's kernels, and returns host
objects (losses, the state as numpy, its kernel launch counters, its
times), so that the caller compares ranks with each other and with one
process. Kernels are built by the caller before any rank starts
(`ops/kernels/_build.build_all`); a rank only loads them.

  parity    a few steps of a Trainer over the mesh (`parity_rank`), or in
            one process with mesh None, with every kernel's launch counter
            (`ops.kernels.launch_counts`) each rank counted from 0
  evaluate  the Evaluator's scores of given variables (`evaluate_rank`)
  times     ms a step and utterances a second of the DP step, and (with
            `plain`) of the same step with no mesh in the same process,
            host clock around steps that end in a device synchronisation,
            in turns plain, DP, DP, plain (`step_times_rank`)

Ranks that share a card run over gloo (its collectives staged through host
copies); ranks that each own a card over NCCL.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from tcresnet_tpu_torch.config import ExperimentConfig, MeshConfig, get_preset
from tcresnet_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from tcresnet_tpu_torch.parallel import mesh as meshlib

DATA_ROWS = 2048  # synthetic train rows each rank makes (any count gives the same step)


def train_cfg(batch: int, fuse: str, dtype: str = "float32", conv_backend: str = "pallas",
              data: int = 1) -> ExperimentConfig:
    """TCResNet8-1.0 at `batch`, its input through the kernels (K3 with
    fuse "on", K1 + K2 with "off"), every conv through K7 ("pallas"), no
    cadence firing within a run (no checkpoint, eval or summary)."""
    flagship = get_preset("TCResNet8-1.0")
    return flagship.replace(
        train=dataclasses.replace(flagship.train, batch_size=batch, compute_dtype=dtype,
                                  max_step=10**9, step_save_checkpoint=10**6,
                                  step_evaluation=10**6, summary_step_verbose=10**6),
        model=dataclasses.replace(flagship.model, conv_backend=conv_backend),
        audio=dataclasses.replace(flagship.audio, dsp_backend="pallas", frontend_fuse=fuse),
        augment=dataclasses.replace(flagship.augment, backend="pallas"),
        data=dataclasses.replace(flagship.data, use_synthetic=True,
                                 synthetic_num_samples=24_100),
        mesh=MeshConfig(data=data))


def synthetic(cfg: ExperimentConfig, split: str = "train"):
    """The split as the train CLI makes it (the valid split: 3,012 rows
    of seed 1), the train split cut to DATA_ROWS rows."""
    from tcresnet_tpu_torch.tools.train import load_split

    if split == "train":
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, synthetic_num_samples=DATA_ROWS))
    return load_split(cfg, split)


def _host(d) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in d.items()}


def _trainer(mesh, cfg, workdir, device):
    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return Trainer(cfg, DeviceDataset(synthetic(cfg), device), workdir=workdir, mesh=mesh)


def parity_rank(mesh: Optional[meshlib.Mesh], cfg: ExperimentConfig, steps: int,
                workdir: str, device: str = "cuda") -> dict:
    """`steps` train steps over `mesh` (one process with mesh None, on
    `device`): each step's logged loss, the params and BN statistics, and
    the kernel launches of the steps."""
    trainer = _trainer(mesh, cfg, workdir, mesh.device if mesh is not None else device)
    reset_launch_counts()
    losses = [float(trainer.train_steps(1)["total_loss"]) for _ in range(steps)]
    torch.cuda.synchronize()
    launches = launch_counts()
    trainer.writer.close()
    return {"losses": losses, "params": _host(trainer.state.params),
            "batch_stats": _host(trainer.state.batch_stats), "launches": launches}


def evaluate_rank(mesh: Optional[meshlib.Mesh], cfg: ExperimentConfig, variables: dict,
                  device: str = "cuda") -> dict:
    """The Evaluator's scores of `variables` ({params, batch_stats} as
    numpy) on the synthetic valid split, its batches split over `mesh`."""
    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.evaluation.evaluator import Evaluator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device if mesh is not None else torch.device(device)
    ev = Evaluator(cfg, DeviceDataset(synthetic(cfg, "valid"), dev), mesh)
    t = {k: {n: torch.tensor(a, device=dev) for n, a in v.items()} for k, v in variables.items()}
    reset_launch_counts()
    scores = ev.evaluate(t["params"], t["batch_stats"], include_report=False)
    scores["launches"] = launch_counts()
    return scores


def step_counts(trainer) -> dict:
    """What one train step dispatches, from torch.profiler: operators
    called from Python or the autograd engine (`aten::` ops whose parent is
    not one), device activities (kernels and copies; 0 where the profiler
    sees none, or on the CPU) and collectives."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = trainer.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        trainer.train_steps(1)
        if cuda:
            torch.cuda.synchronize()
    events = prof.events()
    return {
        "host_ops": sum(1 for e in events if e.name.startswith("aten::") and (
            e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))),
        "device_ops": sum(1 for e in events if e.device_type == DeviceType.CUDA),
        "collectives": sum(1 for e in events if e.name.startswith("c10d::")),
    }


def step_times_rank(mesh: meshlib.Mesh, cfg: ExperimentConfig, steps: int, workdir: str,
                    plain: bool = False) -> dict:
    """ms a step and utterances a second of `steps` DP steps over `mesh`
    (and with `plain`, of the same steps of a Trainer with no mesh in this
    process, and each step's `step_counts`), after 3 warm-up steps each,
    in turns plain, DP, DP, plain; the lesser reading of each."""
    dp = _trainer(mesh, cfg, f"{workdir}/dp", mesh.device)
    alone = _trainer(None, cfg, f"{workdir}/plain{mesh.rank}", mesh.device) if plain else None

    def run(trainer) -> float:
        torch.cuda.synchronize()
        meshlib.barrier(mesh if trainer is dp else None)
        t0 = time.perf_counter()
        summary = trainer.train_steps(steps)
        float(summary["total_loss"])  # a device read: the steps are done
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    for t in filter(None, (dp, alone)):
        t.train_steps(3)
    order = (alone, dp, dp, alone) if plain else (dp, dp)
    readings = {"dp": [], "plain": []}
    for t in order:
        readings["dp" if t is dp else "plain"].append(run(t))
    out = {}
    for kind, ms in readings.items():
        if ms:
            out[kind] = {"ms_per_step": min(ms), "readings_ms": ms,
                         "utt_per_s": cfg.train.batch_size / min(ms) * 1e3}
    if plain:
        out["dp"]["counts"], out["plain"]["counts"] = step_counts(dp), step_counts(alone)
    for t in filter(None, (dp, alone)):
        t.writer.close()
    return out

