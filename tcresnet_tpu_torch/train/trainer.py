"""The training runtime (counterpart of tcresnet_tpu/train/trainer.py).

Each step draws its batch indices from the device-resident dataset,
gathers, decodes and augments them, computes features, runs the forward
and backward passes, the smoothed cross-entropy plus L2, the unit-LR
optimizer scaled by the piecewise learning rate, and the EMA. On a CUDA
device the input path runs through the port's kernels: K1 (gather +
augment) and K2 (MFCC), or K3 (both in one kernel, `frontend_fuse`);
with `model.conv_backend="pallas"` every conv, forward and backward, runs
through K7 (`csrc/tconv.cu`), and cuDNN with "xla".

Differences from the JAX trainer, and why:

- `lax.scan` over `steps_per_call` becomes a plain Python loop that never
  reads the device: the metrics stay tensors until a summary converts
  them, one call late, so the host keeps queueing work. `steps_per_call`
  stays the summary granularity. CUDA graphs are later work.
- Per-step randomness is a function of (seed, step): one generator on the
  device, re-seeded at every step, draws the indices, the augmentation
  scalars and the dropout mask in a fixed order. A resumed run draws what
  an uninterrupted one would.
- "auto" follows the JAX rule with "cuda" in the place of "tpu":
  `augment.backend` auto takes K1/K6 on the card; `dsp_backend` auto and
  `frontend_fuse` auto take K2/K3 at batch >= 2048. That threshold is TPU
  data; its H100 crossover is measured in PERF.md.

Not ported yet (ROADMAP.md Queue 1 item 7): warm start and partial
restore, the relative LR shift on restore, data parallelism.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from tcresnet_tpu.config import ExperimentConfig
from tcresnet_tpu.metrics.writers import MetricWriter, crossed_boundary, should_write_summary
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.models import build_model, param_count
from tcresnet_tpu_torch.ops import augment as aug
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.ops.kernels import frontend
from tcresnet_tpu_torch.ops.kernels import mfcc as k2
from tcresnet_tpu_torch.train import loss as losslib
from tcresnet_tpu_torch.train import optim as optimlib
from tcresnet_tpu_torch.train.checkpoint import CheckpointManager
from tcresnet_tpu_torch.train.state import TrainState, create_train_state

# generator streams of one (seed, step)
_TRAIN, _EVAL, _AUDIO = 0, 1, 2


def step_seed(seed: int, step: int, stream: int = _TRAIN) -> int:
    """The 64-bit generator seed of (seed, step, stream)."""
    mixed = ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)
    return (mixed ^ (stream * 0x9E3779B97F4A7C15)) & 0xFFFFFFFFFFFFFFFF


class Trainer:
    def __init__(
        self,
        cfg: ExperimentConfig,
        train_data: DeviceDataset,
        workdir: Optional[str] = None,
        steps_per_call: Optional[int] = None,
    ):
        cfg_as_given = cfg
        self.data = train_data
        self.device = train_data.device
        if cfg.audio.dsp_backend == "auto":
            # resolved here, where the device and batch are known; not
            # written into config.json (other processes resolve their own)
            fused = k2.auto_takes_kernel(cfg.audio, self.device, cfg.train.batch_size,
                                         cfg.audio.desired_samples)
            cfg = cfg.replace(audio=dataclasses.replace(
                cfg.audio, dsp_backend="pallas" if fused else "xla"))
        self.cfg = cfg
        self.log = logging.getLogger("tcresnet_tpu_torch.trainer")
        self.workdir = Path(workdir or cfg.train.train_dir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        (self.workdir / "config.json").write_text(cfg_as_given.to_json())

        if train_data.num_classes != cfg.model.num_classes:
            raise ValueError(
                f"dataset has {train_data.num_classes} classes, config says "
                f"{cfg.model.num_classes}")
        self.feature_shape = dsp.feature_shape(cfg.audio)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.train.seed)
            model = build_model(cfg.model, self.feature_shape, cfg.train.compute_dtype,
                                device="cpu")
        self.model = model.to(self.device).train()
        # epoch size counts LOGICAL samples (oversampling duplicates count)
        self._num_samples = train_data.num_logical_samples
        self._steps_per_epoch = max(self._num_samples // cfg.train.batch_size, 1)
        self.steps_per_call = steps_per_call or max(
            1, min(cfg.train.summary_step_default, cfg.train.step_save_checkpoint))

        if cfg.optim.relative_schedule:
            raise NotImplementedError(
                "optim.relative_schedule is not ported yet (ROADMAP.md Queue 1 item 7)")
        self.optimizer, self.lr_schedule = optimlib.build_optimizer(
            cfg.optim, num_samples=self._num_samples, batch_size=cfg.train.batch_size)
        self.state: TrainState = create_train_state(
            self.model, self.optimizer, use_ema=cfg.optim.use_ema)
        self._generator = torch.Generator(device=self.device)

        self.ckpt = CheckpointManager(self.workdir / "ckpt", cfg.train.max_to_keep)
        self.writer = MetricWriter(self.workdir, "train")
        self.writer.write_text(0, "experiment_config", cfg.to_json())
        self.log.info(
            f"model={cfg.model.name} params={param_count(self.model):,} "
            f"features={self.feature_shape} batch={cfg.train.batch_size} "
            f"steps_per_call={self.steps_per_call} device={self.device}")

    # ------------------------------------------------------------------
    # restore
    # ------------------------------------------------------------------

    def maybe_restore(self) -> int:
        """Resume from the latest checkpoint if one exists; returns the step."""
        step = self.ckpt.latest_step()
        if step is not None:
            self.ckpt.restore(self.state, step)
        return int(self.state.step)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def generator(self, step: int, stream: int = _TRAIN) -> torch.Generator:
        """The device generator, seeded for (cfg.train.seed, step, stream)."""
        return self._generator.manual_seed(step_seed(self.cfg.train.seed, step, stream))

    def _input_features(self, idx: torch.Tensor, silent: torch.Tensor,
                        generator: torch.Generator) -> torch.Tensor:
        """Batch indices -> [B, H, W, 1] training features: K3 (one kernel)
        when `frontend_fuse` selects it and the geometry allows, else
        gather + augment (K1 / K6 / plain) then `dsp.preprocess` (K2 or
        plain)."""
        cfg = self.cfg
        n = cfg.audio.desired_samples
        dataset, noise = self.data.wavs, self.data.noise_bank
        mode = getattr(cfg.audio, "frontend_fuse", "auto")
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"frontend_fuse must be 'auto', 'on' or 'off', got {mode!r}")
        want_fuse = mode == "on" or (
            mode == "auto"
            and self.device.type == "cuda"
            and idx.shape[0] >= k2.AUTO_MIN_BATCH
            and getattr(cfg.augment, "backend", "auto") in ("auto", "pallas")
        )
        fusable = frontend.frontend_fusable(dataset, cfg.augment, cfg.audio, noise, n)
        if mode == "on" and not fusable:
            raise ValueError(
                "frontend_fuse='on' but the geometry/config is not fusable (needs "
                "MFCC or log-mel with a hop-decomposable window, an anchored "
                "augmentation method and a noise bank); use 'auto' to allow fallback")
        if want_fuse and fusable:
            feats = frontend.fused_gather_augment_mfcc(
                dataset, idx, silent, generator, cfg.augment, cfg.audio, noise,
                is_training=True, n=n)
            return feats[..., None]
        wavs = aug.augment_gathered(dataset, idx, silent, generator, cfg.augment, noise,
                                    is_training=True, clip_len=n)
        return dsp.preprocess(wavs, cfg.audio)

    def _loss(self, logits: torch.Tensor, labels: torch.Tensor):
        cfg = self.cfg
        onehot = F.one_hot(labels, cfg.model.num_classes).to(torch.float32)
        model_loss = losslib.smoothed_softmax_cross_entropy(
            logits, onehot, cfg.model.label_smoothing)
        l2 = losslib.l2_regularization(self.state.params, cfg.model.weight_decay)
        return model_loss + l2, model_loss, l2

    def _one_step(self, step: int) -> Dict[str, torch.Tensor]:
        """One training step at host step `step`; reads nothing back."""
        cfg, state = self.cfg, self.state
        gen = self.generator(step)
        idx, labels, silent = DeviceDataset.sample_indices(
            self.data.arrays, gen, cfg.train.batch_size, self.data.sample_row)
        feats = self._input_features(idx, silent, gen)
        logits = self.model(feats, generator=gen)
        total, model_loss, l2 = self._loss(logits, labels)
        names = list(state.params)
        grads = torch.autograd.grad(total, [state.params[k] for k in names])
        updates, state.opt_state = self.optimizer.update(dict(zip(names, grads)),
                                                         state.opt_state)
        updates = optimlib.scale_updates(updates, self.lr_schedule(step))
        with torch.no_grad():
            for k in names:
                state.params[k].add_(updates[k])
            if state.ema_params is not None:
                state.ema_params = optimlib.ema_update(
                    state.ema_params, state.params, cfg.optim.ema_decay)
            state.step += 1
            acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
        return {"total_loss": total.detach(), "model_loss": model_loss.detach(),
                "l2_loss": l2.detach(), "accuracy": acc}

    def train_steps(self, n_steps: int, start: Optional[int] = None) -> Dict[str, object]:
        """`n_steps` steps from host step `start` (the state's step when
        None: one device read) -> summary: device means of the metrics and
        the last step's learning rate."""
        if start is None:
            start = int(self.state.step)
        sums: Dict[str, torch.Tensor] = {}
        for i in range(n_steps):
            for k, v in self._one_step(start + i).items():
                sums[k] = v if k not in sums else sums[k] + v
        summary: Dict[str, object] = {k: v / n_steps for k, v in sums.items()}
        summary["learning_rate"] = self.lr_schedule(start + n_steps - 1)
        return summary

    # ------------------------------------------------------------------
    # the host loop
    # ------------------------------------------------------------------

    def train(self, max_step: Optional[int] = None) -> TrainState:
        cfg = self.cfg.train
        max_step = max_step or cfg.max_step
        if max_step <= 0:
            # max_step=0 disables the absolute cap; another budget must bound the run
            max_step = 1 << 62
        if cfg.max_epoch > 0:
            max_step = min(max_step, cfg.max_epoch * self._steps_per_epoch)
        start = self.maybe_restore()
        # FROM-RESTORE budgets count from this process's restore point
        if cfg.max_step_from_restore > 0:
            max_step = min(max_step, start + cfg.max_step_from_restore)
        if cfg.max_epoch_from_restore > 0:
            max_step = min(max_step, start + cfg.max_epoch_from_restore * self._steps_per_epoch)
        if max_step >= (1 << 62):
            raise ValueError(
                "training budget is unbounded: with train.max_step=0, set "
                "max_epoch, max_step_from_restore, or max_epoch_from_restore")
        done_file = self.ckpt.directory / "TRAIN_DONE"
        if start >= max_step:
            self.log.info(f"Already at step {start} >= {max_step}")
            done_file.write_text(str(start))
            return self.state
        # a sentinel from a completed run must not stop a watcher of this one
        done_file.unlink(missing_ok=True)
        self.log.info(f"Training from step {start} to {max_step}")

        step = start
        # summaries are converted one call LATE, while the next call's work
        # is queued, so the host never waits on the device mid-window
        pending = None  # (step, device summary, window n, window elapsed)
        t_last = time.perf_counter()
        win_n, win_elapsed = 0, 0.0
        while step < max_step:
            n = min(self.steps_per_call, max_step - step)
            summary = self.train_steps(n, start=step)
            prev_step, step = step, step + n
            now = time.perf_counter()
            win_n += n
            win_elapsed += now - t_last
            t_last = now

            # boundary-crossing cadences over (prev_step, step]
            if pending is not None:
                self._write_summary(*pending)
            wants_summary = should_write_summary(
                step, cfg.summary_step_default, cfg.summary_step_verbose,
                cfg.summary_first_n, prev_step=prev_step, min_step=cfg.summary_step_min,
            ) or step >= max_step
            if wants_summary:
                pending = (step, summary, win_n, win_elapsed)
                win_n, win_elapsed = 0, 0.0
            else:
                pending = None

            if crossed_boundary(prev_step, step, cfg.step_evaluation):
                self._train_stream_eval(step)
            if crossed_boundary(prev_step, step, cfg.summary_step_verbose):
                self._write_audio_summary(step)
            if crossed_boundary(prev_step, step, cfg.step_save_checkpoint) or step >= max_step:
                if step >= cfg.step_minimum_save:
                    self.ckpt.save(step, self.state)

        if pending is not None:
            self._write_summary(*pending)
        self.writer.flush()
        # completion sentinel: a loop watcher exits even when the effective
        # final step (epoch / from-restore caps) is below cfg.train.max_step
        done_file.write_text(str(step))
        return self.state

    def _write_summary(self, step: int, summary, n: int, elapsed: float) -> None:
        """`summary` holds the last call's device metrics; `n` / `elapsed`
        span the whole window since the previous summary."""
        summary = {k: float(v) for k, v in summary.items()}
        ms_per_step = elapsed / n * 1000
        summary["ms_per_step"] = ms_per_step
        summary["ms_per_instance"] = ms_per_step / self.cfg.train.batch_size
        summary["utterances_per_sec"] = self.cfg.train.batch_size * n / elapsed
        self.writer.write(step, summary)
        self.log.info(
            f"step {step}: loss {summary['total_loss']:.4f} "
            f"acc {summary['accuracy']:.4f} lr {summary['learning_rate']:.4g} "
            f"{ms_per_step:.2f} ms/step ({summary['utterances_per_sec']:,.0f} utt/s)")

    def _write_audio_summary(self, step: int) -> None:
        """Audio summaries of augmented input wavs at the verbose tier
        (reference WavSummaryOp); the augment goes through `aug.augment`
        (K6 on the card)."""
        gen = self.generator(step, _AUDIO)
        wavs, _, silent = DeviceDataset.sample_batch(
            self.data.arrays, gen, 4, clip_len=self.cfg.audio.desired_samples)
        wavs = aug.augment(wavs, silent, gen, self.cfg.augment, self.data.noise_bank, True)
        self.writer.write_audio(step, "input_audio", wavs.cpu().numpy(),
                                self.cfg.audio.sample_rate)

    @torch.no_grad()
    def _train_stream_eval(self, step: int) -> Dict[str, float]:
        """In-training sanity eval on the TRAINING stream (reference
        helper/trainer.py:416-417,436-460): eval-mode forward (no dropout,
        running BN statistics, no augmentation) on a sampled batch of
        class_sampling_factor * num_classes rows."""
        cfg = self.cfg
        n_eval = max(cfg.train.class_sampling_factor * cfg.model.num_classes, 1)
        gen = self.generator(step, _EVAL)
        wavs, labels, silent = DeviceDataset.sample_batch(
            self.data.arrays, gen, n_eval, clip_len=cfg.audio.desired_samples)
        wavs = aug.zero_silence(wavs, silent)
        # re-resolve "auto" for this (small) batch
        feats = dsp.preprocess(wavs, dataclasses.replace(cfg.audio, dsp_backend="auto"))
        self.model.eval()
        try:
            logits = self.model(feats)
        finally:
            self.model.train()
        onehot = F.one_hot(labels, cfg.model.num_classes).to(torch.float32)
        metrics = {
            "train_stream/accuracy": float((logits.argmax(-1) == labels).float().mean()),
            "train_stream/loss": float(losslib.smoothed_softmax_cross_entropy(
                logits, onehot, cfg.model.label_smoothing)),
        }
        self.writer.write(step, metrics)
        self.log.info(
            f"step {step}: train-stream-eval acc {metrics['train_stream/accuracy']:.4f} "
            f"loss {metrics['train_stream/loss']:.4f}")
        return metrics

