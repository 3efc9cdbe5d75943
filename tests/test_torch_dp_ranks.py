"""Rank functions of the data-parallel tests (tests/test_torch_parallel.py);
this module holds no test of its own.

`parallel.mesh.launch` pickles a rank function by its import path and
runs it in a spawned process, so these live in a module that imports
torch and the port only (no JAX), which keeps each rank's start short.
Every function takes the rank's mesh first and returns host objects.
"""

from __future__ import annotations

import torch

from tcresnet_tpu_torch.config import AudioConfig, AugmentConfig, DataConfig, ExperimentConfig
from tcresnet_tpu_torch.config import ModelConfig, OptimConfig, TrainConfig
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.models import layers
from tcresnet_tpu_torch.ops import augment as aug
from tcresnet_tpu_torch.ops.kernels.augment import AugmentScalars
from tcresnet_tpu_torch.parallel import mesh as meshlib
from tcresnet_tpu_torch.train.trainer import Trainer


def host_state(state) -> dict:
    """params, batch_stats and opt_state of a TrainState as numpy."""
    return {field: {k: v.detach().cpu().numpy() for k, v in getattr(state, field).items()}
            for field in ("params", "batch_stats", "opt_state")}


def small_cfg(train_dir, optimizer="adam", batch_size=32, **train) -> ExperimentConfig:
    """The JAX package's tiny_config (tests/test_train.py: TCResNet8 on 250
    ms clips, 23 x 20 MFCCs, 4 classes, dropout 0.5, Adam at 3e-3) with
    EMA and an eval batch of 15."""
    return ExperimentConfig(
        audio=AudioConfig(clip_duration_ms=250, num_mfccs=20, num_mel_bins=32),
        augment=AugmentConfig(background_frequency=0.2, background_max_volume=0.05),
        model=ModelConfig(name="TCResNet8", num_classes=4, bn_momentum=0.9,
                          weight_decay=1e-4),
        optim=OptimConfig(optimizer=optimizer, lr_list=(3e-3,), boundaries=(), use_ema=True),
        train=TrainConfig(**{**dict(batch_size=batch_size, max_step=8, step_save_checkpoint=2,
                                    step_evaluation=4, summary_step_verbose=10**6,
                                    summary_step_default=2, class_sampling_factor=3,
                                    max_to_keep=10, train_dir=str(train_dir)), **train}),
        data=DataConfig(eval_batch_size=15),
    )


def one_thread() -> None:
    """Ranks of runs compared bit for bit compute on one thread each, as
    the test process does (the thread count can change a reduction's
    order)."""
    torch.set_num_threads(1)


def batch_norm_rank(mesh, x, weights, scale, shift):
    """SlimBatchNorm on this rank's rows of x [B, C, T] under the mesh:
    (its output rows, the running statistics, the gradients of
    sum(y * weights) with respect to its input rows and, summed over the
    ranks, to the scale and shift)."""
    one_thread()
    rows = meshlib.batch_rows(mesh, x.shape[0])
    bn = layers.SlimBatchNorm(x.shape[1], momentum=0.9)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(scale))
        bn.bias.copy_(torch.tensor(shift))
    layers.sync_batch_norm(bn.train(), mesh)
    xt = torch.tensor(x[rows], requires_grad=True)
    y = bn(xt)
    (y * torch.tensor(weights[rows])).sum().backward()
    dscale, dshift = meshlib.all_reduce_grads(mesh, [bn.weight.grad, bn.bias.grad])
    return dict(y=y.detach().numpy(), dx=xt.grad.numpy(), dscale=dscale.numpy(),
                dshift=dshift.numpy(), mean=bn.running_mean.numpy(),
                var=bn.running_var.numpy())


def injected_steps_rank(mesh, cfg, host, draws, workdir):
    """The Trainer over `mesh` with each step's draws injected (the rank's
    rows of the global batch's indices and augmentation scalars); (the
    logged total loss of each step, the final state)."""
    one_thread()
    batch = cfg.train.batch_size
    rows = meshlib.batch_rows(mesh, batch)
    calls = {"n": 0}

    def fake_indices(arrays, generator, batch_size, sample_row=None):
        assert batch_size == rows.stop - rows.start
        idx = torch.tensor(draws[calls["n"]]["idx"][rows])
        return idx, arrays[1][idx.long()], arrays[2][idx.long()]

    def fake_scalars(generator, is_silent, aug_cfg, noise_bank, n, is_training):
        d = draws[calls["n"]]
        calls["n"] += 1
        keeps = torch.where(is_silent, 0.0, 1.0).to(torch.float32)
        return AugmentScalars(*(torch.tensor(a[rows]) for a in d["scalars"]), keeps)

    DeviceDataset.sample_indices = staticmethod(fake_indices)
    aug.draw_scalars = fake_scalars
    trainer = Trainer(cfg, DeviceDataset(host, "cpu"), workdir=workdir, mesh=mesh)
    losses = [float(trainer.train_steps(1)["total_loss"]) for _ in draws]
    assert calls["n"] == len(draws)
    return losses, host_state(trainer.state)


def fit_rank(mesh, cfg, host, workdir, max_step=None):
    """Trainer.train over `mesh` (the generator's own draws); the state
    and the trainer's eval of the training stream at the last step."""
    one_thread()
    trainer = Trainer(cfg, DeviceDataset(host, "cpu"), workdir=workdir, mesh=mesh)
    trainer.train(max_step)
    stream = trainer._train_stream_eval(int(trainer.state.step))
    trainer.writer.close()
    return host_state(trainer.state), stream


def resume_rank(mesh, cfg, host, straight_dir, resumed_dir):
    """4 steps straight, and 2 steps, a checkpoint, then a new Trainer that
    restores it and takes steps 3-4: both states."""
    straight = fit_rank(mesh, cfg, host, straight_dir, 4)[0]
    fit_rank(mesh, cfg, host, resumed_dir, 2)
    resumed = fit_rank(mesh, cfg, host, resumed_dir, 4)[0]
    return straight, resumed


def evaluate_rank(mesh, cfg, host, variables):
    """The Evaluator's scores of `variables` (params, batch_stats) over the
    split `host`, each batch split over the mesh."""
    from tcresnet_tpu_torch.evaluation.evaluator import Evaluator

    one_thread()
    ev = Evaluator(cfg, DeviceDataset(host, "cpu"), mesh)
    tensors = {k: {n: torch.tensor(a) for n, a in v.items()} for k, v in variables.items()}
    return ev.evaluate(tensors["params"], tensors["batch_stats"], include_report=False)


def slow_checkpoint_rank(mesh, cfg, host, workdir, delay):
    """The loop evaluator over a run whose one checkpoint (step 1, with
    TRAIN_DONE) rank 1 writes `delay` seconds after the watch starts, from
    a thread: the scores of step 1."""
    import threading
    import time

    from tcresnet_tpu_torch.evaluation.watcher import WatchingEvaluator

    one_thread()
    watcher = WatchingEvaluator(cfg, DeviceDataset(host, "cpu"), workdir, mesh=mesh)

    def write():
        time.sleep(delay)
        watcher.ckpt.save(1, watcher.template_state)
        (watcher.ckpt.directory / "TRAIN_DONE").touch()

    writer = threading.Thread(target=write) if mesh.rank == 1 else None
    if writer is not None:
        writer.start()
    scores = watcher.watch(max_step=1, poll_interval=0.5)
    if writer is not None:
        writer.join()
    return scores


def failing_rank(mesh):
    """Rank 1 raises; the others wait for it in a barrier."""
    if mesh.rank == 1:
        raise ValueError("rank 1 gives up")
    meshlib.barrier(mesh)
    return mesh.rank


def rank_rows(mesh, batch):
    return mesh.rank, mesh.data_index, meshlib.batch_rows(mesh, batch)
