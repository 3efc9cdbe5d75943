"""Entry points of the port (counterpart of __graft_entry__.py): the
production serving function with an example, and the multi-chip dry run.

    python -m tcresnet_tpu_torch.graft_entry            # on the card
    python -m tcresnet_tpu_torch.graft_entry --device cpu --ranks 2

`entry()` returns `serve.export.build_inference_fn(cfg, variables,
include_preprocess=True, backend="auto")` on TCResNet8-1.0 (wav -> MFCC ->
TCResNet8 -> softmax) and 8 wavs in [-1, 1) from default_rng(0). On the
card "auto" at batch 8 takes K4, the whole-model kernel; on the CPU the
plain path. The weights are the numpy-seeded `models.convert.
seeded_variables` (seed 0), not Flax's init, which needs JAX.

`dryrun_multichip(n)` runs the four legs of the JAX dry run over n ranks
(`parallel.mesh.launch`). On the cards (device "cuda", the default where
one is visible) a card a rank with NCCL where n are visible, else the n
ranks share the visible cards over gloo, collectives staged through the
host; on the CPU (device "cpu", the default without a card, as the JAX
dry run falls back to CPU devices) n gloo ranks:

  a. one data-parallel train step with EMA (TCResNet8 on 250 ms clips,
     batch 2n, momentum);
  b. the same step on the model-axis mesh {data n/2, model 2}, batch n;
  c. a DP step through K3, the fused gather + augment + MFCC front end
     (160 ms clips, frontend_fuse="on", two steps a call, batch 8n), and on
     the model-axis mesh at batch 4n;
  d. K3 on each rank's rows of a 16n-row batch, gathered in row order,
     bit-equal to one call over the whole batch.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Optional

import numpy as np
import torch

from tcresnet_tpu_torch.config import (
    AudioConfig,
    AugmentConfig,
    DataConfig,
    ExperimentConfig,
    MeshConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
    get_preset,
)
from tcresnet_tpu_torch.parallel import mesh as meshlib


def flagship_variables():
    """TCResNet8-1.0's config and the port's variables made from seed 0."""
    from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
    from tcresnet_tpu_torch.ops import dsp

    cfg = get_preset("TCResNet8-1.0")
    return cfg, variables_from_jax(
        cfg.model, **seeded_variables(cfg.model, dsp.feature_shape(cfg.audio), 0))


def entry(device="cuda"):
    """(forward, example): the production serving function of
    TCResNet8-1.0, raw wavs -> softmax, through backend "auto", and a
    batch of 8 wavs on `device`."""
    from tcresnet_tpu_torch.serve.export import build_inference_fn

    cfg, variables = flagship_variables()
    forward = build_inference_fn(cfg, variables, include_preprocess=True, backend="auto",
                                 device=device)
    wavs = np.random.default_rng(0).uniform(-1, 1, (8, 16000)).astype(np.float32)
    return forward, (torch.tensor(wavs, device=device),)


def _step_cfg(n: int, **audio) -> ExperimentConfig:
    """The dry run's train config (the JAX dry run's): TCResNet8, 12
    classes, momentum at 0.1 with EMA, one step."""
    return ExperimentConfig(
        audio=AudioConfig(clip_duration_ms=250, num_mfccs=20, num_mel_bins=32, **audio),
        augment=AugmentConfig(),
        model=ModelConfig(name="TCResNet8", num_classes=12, weight_decay=1e-3),
        optim=OptimConfig(optimizer="mom", lr_list=(0.1,), boundaries=(), use_ema=True),
        train=TrainConfig(batch_size=2 * n, max_step=1),
        data=DataConfig(),
        mesh=MeshConfig(),
    )


def _steps(mesh, cfg, host, workdir: str, steps: int) -> float:
    """`steps` train steps of a fresh Trainer on `mesh`; the logged loss."""
    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, DeviceDataset(host, mesh.device), workdir=workdir,
                      steps_per_call=steps, mesh=mesh)
    loss = float(trainer.train_steps(steps)["total_loss"])
    trainer.writer.close()
    if not np.isfinite(loss):
        raise FloatingPointError(f"non-finite loss {loss} on mesh {mesh.shape}")
    return loss


def _dryrun_rank(mesh, n: int, workdir: str) -> dict:
    """Every leg of the dry run as one rank; what rank 0 prints."""
    from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset

    out = {}
    cfg = _step_cfg(n)
    host = make_synthetic_dataset(num_samples=4 * n, num_classes=12,
                                  desired_samples=cfg.audio.desired_samples, seed=0)
    out["dp_loss"] = _steps(mesh, cfg, host, f"{workdir}/a", 1)
    tp = meshlib.make_mesh(MeshConfig(model=2), mesh.devices) if n % 2 == 0 else None
    if tp is not None:
        out["tp_mesh"] = tp.shape
        out["tp_loss"] = _steps(tp, cfg.replace(train=dataclasses.replace(
            cfg.train, batch_size=n), mesh=MeshConfig(model=2)), host, f"{workdir}/b", 1)

    # c. through K3: 160 ms clips = 2560 samples, hop-decomposable
    fused = _step_cfg(n, frontend_fuse="on")
    fused = fused.replace(
        audio=dataclasses.replace(fused.audio, clip_duration_ms=160),
        augment=AugmentConfig(background_frequency=0.8, background_max_volume=0.2),
        optim=dataclasses.replace(fused.optim, use_ema=False),
        train=dataclasses.replace(fused.train, batch_size=8 * n))
    host = make_synthetic_dataset(num_samples=4 * n, num_classes=12,
                                  desired_samples=fused.audio.desired_samples, seed=5)
    out["k3_batch"] = fused.train.batch_size
    out["k3_loss"] = _steps(mesh, fused, host, f"{workdir}/c", 2)
    if tp is not None:
        out["k3_tp_loss"] = _steps(tp, fused.replace(train=dataclasses.replace(
            fused.train, batch_size=4 * n), mesh=MeshConfig(model=2)), host, f"{workdir}/d", 2)
    out.update(_sharded_kernel(mesh, n))
    return out


def _sharded_kernel(mesh, n: int) -> dict:
    """d. K3 on this rank's rows of a global batch, the rows gathered in
    order, against one call over the whole batch: bit-equal."""
    from tcresnet_tpu_torch.ops.kernels import frontend

    rng = np.random.default_rng(13)
    clip, num_rows, batch = 2560, 4 * n, 16 * n
    data = np.zeros((num_rows, 2560), np.int16)
    data[:, :clip] = rng.integers(-32768, 32768, (num_rows, clip)).astype(np.int16)
    aug_cfg = AugmentConfig(background_frequency=0.9, background_max_volume=0.3)
    audio_cfg = AudioConfig(clip_duration_ms=160, num_mfccs=20, num_mel_bins=32)
    noise = (rng.normal(size=(3, 3 * clip)) * 0.1).astype(np.float32)
    idx = rng.integers(0, num_rows, batch).astype(np.int32)
    silent = rng.integers(0, 4, batch) == 0
    dev = mesh.device
    dataset, noise_d = torch.tensor(data, device=dev), torch.tensor(noise, device=dev)
    idx_d, silent_d = torch.tensor(idx, device=dev), torch.tensor(silent, device=dev)
    if not frontend.frontend_fusable(dataset, aug_cfg, audio_cfg, noise_d, clip):
        raise ValueError("the dry run's front-end geometry is not fusable")
    rows = meshlib.batch_rows(mesh, batch)
    gen = meshlib.ShardedGenerator(device=dev).manual_seed(9).keep(rows, batch)
    mine = frontend.fused_gather_augment_mfcc(dataset, idx_d[rows], silent_d[rows], gen,
                                              aug_cfg, audio_cfg, noise_d, True, clip)
    sharded = meshlib.all_gather_rows(mesh, mine, batch)
    whole = frontend.fused_gather_augment_mfcc(
        dataset, idx_d, silent_d, torch.Generator(device=dev).manual_seed(9), aug_cfg,
        audio_cfg, noise_d, True, clip)
    if not torch.equal(sharded, whole):
        raise AssertionError(f"K3 over {mesh.data} shards differs from one call by "
                             f"{(sharded - whole).abs().max().item()}")
    return {"kernel_batch": batch, "kernel_features": tuple(whole.shape[1:])}


def dryrun_multichip(n_devices: int, device: Optional[str] = None, timeout: float = 900.0,
                     verbose: bool = True) -> dict:
    """Run the dry run's legs over `n_devices` ranks on `device`: "cuda",
    the ranks dealt over the visible cards in turn (NCCL when each has its
    own, else gloo); "cpu", gloo ranks on the CPU; None, "cuda" where a
    card is visible, else "cpu". Returns rank 0's readings with the
    backend and the ranks' devices; raises if a leg fails."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if device == "cuda":
        cards = meshlib.visible_devices()
        devices = [cards[r % len(cards)] for r in range(n_devices)]
    else:
        devices = [torch.device("cpu")] * n_devices
    with tempfile.TemporaryDirectory(prefix="dryrun_") as workdir:
        res = meshlib.launch(_dryrun_rank, n_devices, workdir,
                             cfg=MeshConfig(data=n_devices), devices=devices,
                             timeout=timeout)[0]
    res["backend"] = meshlib.backend_for(devices)
    res["devices"] = [str(d) for d in devices]
    if verbose:
        where = f"{', '.join(res['devices'])} ({res['backend']})"
        print(f"dryrun_multichip({n_devices}): OK on {where} - one DP train step with EMA, "
              f"loss {res['dp_loss']:.4f}")
        if "tp_loss" in res:
            print(f"dryrun_multichip({n_devices}): model-axis mesh {res['tp_mesh']} - one "
                  f"train step, loss {res['tp_loss']:.4f}")
        print(f"dryrun_multichip({n_devices}): DP step through K3 (batch {res['k3_batch']}, "
              f"2 steps) loss {res['k3_loss']:.4f}"
              + (f"; on the model-axis mesh {res['k3_tp_loss']:.4f}" if "k3_tp_loss" in res
                 else ""))
        print(f"dryrun_multichip({n_devices}): K3 per rank == one call bit for bit "
              f"(batch {res['kernel_batch']}, features {res['kernel_features']})")
    return res


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--ranks", type=int, default=2)
    args = p.parse_args(argv)
    forward, (wavs,) = entry(args.device)
    probs = forward(wavs)
    print(f"entry(): ran on {args.device}, output {tuple(probs.shape)}")
    dryrun_multichip(args.ranks, device=args.device)


if __name__ == "__main__":
    main()
