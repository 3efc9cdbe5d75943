"""The checkpoint-watching loop evaluator (counterpart of
tcresnet_tpu/evaluation/watcher.py:32-221).

The reference trains with two cooperating processes: the trainer writes
checkpoints, and a loop evaluator polls them, scores each new one on a
split and promotes the best (`BestKeeper`). `WatchingEvaluator` is that
second process over the port's checkpoint directory (`<run>/ckpt`,
`ckpt_<step>.pt`). It stops at `max_step`, on the trainer's `TRAIN_DONE`
sentinel, or after `timeout` idle seconds.

The template state that checkpoints restore into is built from the run's
config on the evaluation device (a model of its own, so loading EMA
parameters into the evaluator's model never touches the state that is
promoted). A checkpoint that the trainer's `max_to_keep` deleted between
listing and restore is skipped with a warning; promotion writes the state
in memory, not a copy of the trainer's file.

Under data parallelism (`mesh`) every rank restores each checkpoint and
scores its rows of every batch (`Evaluator`); rank 0 picks the steps (its
listing is broadcast once a poll, so all ranks score the same ones and
none waits in a collective longer than a poll), and alone keeps
the best, writes the scores and the metrics. A checkpoint that vanished
before any rank's restore is skipped by all.
"""

from __future__ import annotations

import functools
import logging
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

from tcresnet_tpu_torch.config import ExperimentConfig
from tcresnet_tpu_torch.metrics.writers import metric_writer
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.evaluation.best_keeper import DEFAULT_BEST_METRICS, BestKeeper
from tcresnet_tpu_torch.evaluation.evaluator import Evaluator
from tcresnet_tpu_torch.models import build_model, param_count
from tcresnet_tpu_torch.models.convert import jax_path
from tcresnet_tpu_torch.parallel import mesh as meshlib
from tcresnet_tpu_torch.train import optim as optimlib
from tcresnet_tpu_torch.train.checkpoint import CheckpointManager
from tcresnet_tpu_torch.train.state import TrainState, create_train_state


def checkpoint_iterator(ckpt: CheckpointManager, poll_interval: float = 2.0,
                        timeout: Optional[float] = None, should_stop=None,
                        idle: bool = False) -> Iterator[Optional[int]]:
    """Yield checkpoint steps in order as they appear. Once the backlog is
    drained, stop when `should_stop()` says so or after `timeout` seconds
    without a new checkpoint. With `idle`, also yield None after every
    poll that found nothing new."""
    last = -1
    waited = 0.0
    while True:
        steps = [s for s in ckpt.all_steps() if s > last]
        if steps:
            waited = 0.0
            for s in steps:
                last = s
                yield s
        else:
            if timeout is not None and waited >= timeout:
                return
            if should_stop is not None and should_stop():
                return
            time.sleep(poll_interval)
            waited += poll_interval
            if idle:
                yield None


class WatchingEvaluator:
    """Evaluate every checkpoint of a run on one split; keep the best."""

    def __init__(self, cfg: ExperimentConfig, data: DeviceDataset, workdir,
                 mesh: Optional[meshlib.Mesh] = None):
        self.cfg = cfg
        self.data = data
        self.workdir = Path(workdir)
        self.mesh = mesh
        self.chief = mesh is None or mesh.is_chief
        self.split = data.split or "valid"
        self.log = logging.getLogger(f"tcresnet_tpu_torch.watcher/{self.split}")
        self.evaluator = Evaluator(cfg, data, mesh)
        self.ckpt = CheckpointManager(self.workdir / "ckpt", max_to_keep=cfg.train.max_to_keep)
        self.best_keeper = BestKeeper(DEFAULT_BEST_METRICS, self.split, self.workdir / "best")
        self.writer = metric_writer(self.workdir, self.split, self.chief)
        self.template_state = self._make_template()
        self._n_params = param_count(self.template_state.params)

    def _make_template(self) -> TrainState:
        """A train state of the run's structure on the evaluation device.
        The optimizer is built with num_samples = batch_size = 1: only its
        state's structure matters here (which params have state under
        optim.trainable_scopes), and the watcher has no train split to
        resolve epoch boundaries with."""
        cfg = self.cfg
        model = build_model(cfg.model, self.evaluator.feature_shape, cfg.train.compute_dtype,
                            device=self.data.device)
        optimizer, _ = optimlib.build_optimizer(
            cfg.optim, num_samples=1, batch_size=1, params=dict(model.named_parameters()),
            path_of=functools.partial(jax_path, cfg.model.name))
        return create_train_state(model, optimizer, use_ema=cfg.optim.use_ema)

    def evaluate_once(self, step: int) -> Optional[Dict[str, float]]:
        """Restore checkpoint `step`, score the split, promote the bests.
        None when the checkpoint vanished before its restore (the trainer
        writes faster than a full-split eval runs, and its max_to_keep
        deletes steps the iterator already listed)."""
        try:
            state = self.ckpt.restore(self.template_state, step)
        except FileNotFoundError:
            if step in self.ckpt.all_steps():
                raise
            state = None
        if not meshlib.all_true(self.mesh, state is not None):
            self.log.warning(f"checkpoint step {step} was deleted before evaluation "
                             "(the trainer outpaced the watcher); skipping")
            return None
        scores = self.evaluator.evaluate(state)
        keep = {}
        if self.chief:
            tracked = {k: scores[k] for k in self.best_keeper.modes if k in scores}
            _, keep = self.best_keeper.monitor(tracked)
            self.best_keeper.save_scores(
                keep, scores, meta_info={"step": step, "model_size": self._n_params})
            self.best_keeper.save_best_state(keep, state, step)
        self.writer.write(step, scores)
        shown = "  ".join(f"{k} {scores[k]:.4f}" for k in ("accuracy", "loss") if k in scores)
        self.log.info(f"step {step}: {shown or f'{len(scores)} metrics'}"
                      + ("  [best kept]" if any(keep.values()) else ""))
        report = scores.get("classification_report")
        if report:
            self.log.info(f"classification report (step {step}):\n{report}")
        return scores

    def watch(self, max_step: Optional[int] = None, poll_interval: float = 2.0,
              timeout: Optional[float] = None) -> Optional[Dict[str, float]]:
        """Evaluate checkpoints until `max_step` is evaluated, the trainer's
        TRAIN_DONE sentinel appears, or `timeout`; the last scores."""
        max_step = max_step or self.cfg.train.max_step
        done_file = self.ckpt.directory / "TRAIN_DONE"
        last_scores = None
        steps = (checkpoint_iterator(self.ckpt, poll_interval, timeout,
                                     should_stop=done_file.exists, idle=True)
                 if self.chief else None)
        while True:
            # rank 0's listing decides, so that every rank scores the same
            # steps; it speaks once a poll (None: nothing new yet), so that
            # no rank waits in a collective longer than a poll, however far
            # apart the checkpoints come
            step = meshlib.broadcast_object(self.mesh, next(steps, "end") if self.chief else None)
            if step == "end":
                break
            if step is None:
                continue
            scores = self.evaluate_once(step)
            if scores is not None:
                last_scores = scores
            if step >= max_step:
                break
        self.writer.flush()
        return last_scores
