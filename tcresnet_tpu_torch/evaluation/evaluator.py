"""Full-split evaluation (counterpart of tcresnet_tpu/evaluation/evaluator.py:39-173).

- The split lives on the device (`DeviceDataset`); `eval_index_batches`
  pads the last batch and masks it, so every sample is scored once.
- Eval-mode augmentation: with the naive mix (or no noise bank) silence
  rows are zeroed; with the v2 mix silence rows are mixed with noise at
  volume U[0, 1) through `aug.augment_batch`, the plain dispatch the JAX
  evaluator calls too, with the reference's eval flags (no shift, no
  background for other rows). Each batch draws from a generator seeded by
  (train.seed, batch ordinal), so a repeated eval scores identically.
- The front end is `dsp.preprocess`; the model runs in eval mode (running
  BN statistics, no dropout) with the EMA parameters when optim.use_ema. The
  model is built from the run's config, so a run trained with
  conv_backend="pallas" is scored through K7's forward.
- The loss is the mean of per-example losses over the valid rows only.
- `batch_infer_time` / `unit_infer_time` are host clock times around a
  batch that ends in a device-to-host copy (a synchronisation), the first
  batch left out; they are not device times.
- Scores come from the numpy metric battery (`metrics/host_metrics.py`),
  with `data.exclude_metric_names` removed.
- Under data parallelism (`mesh`) each padded batch is split over the data
  axis (`parallel.mesh.batch_rows`), each rank scores its rows (its
  draws those rows of the batch's global draws), and the rows are
  all-gathered in order, so every rank's metric battery sees the arrays
  of one process. "auto" routes on the whole batch, as JAX's jit does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tcresnet_tpu_torch.config import ExperimentConfig
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.metrics.host_metrics import compute_classification_metrics
from tcresnet_tpu_torch.models import build_model
from tcresnet_tpu_torch.ops import augment as aug
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.parallel import mesh as meshlib
from tcresnet_tpu_torch.train import loss as losslib
from tcresnet_tpu_torch.train.state import TrainState
from tcresnet_tpu_torch.train.trainer import step_seed

_EVAL_STREAM = 3  # generator stream of eval batches (the trainer's are 0-2)


class Evaluator:
    def __init__(self, cfg: ExperimentConfig, data: DeviceDataset,
                 mesh: Optional[meshlib.Mesh] = None):
        self.cfg = cfg
        self.data = data
        self.device = data.device
        self.mesh = mesh
        self.feature_shape = dsp.feature_shape(cfg.audio)
        self.audio = dsp.resolve_for_batch(cfg.audio, self.device, cfg.data.eval_batch_size)
        self.model = build_model(cfg.model, self.feature_shape, cfg.train.compute_dtype,
                                 device=self.device)
        self._generator = meshlib.ShardedGenerator(device=self.device)

    @torch.no_grad()
    def _eval_batch(self, idx: torch.Tensor, ordinal: int):
        """One padded batch -> (softmax, labels, per-example losses) of all
        its rows; under a mesh this rank scores its rows and the rows of
        the data axis are gathered."""
        cfg = self.cfg
        batch = idx.shape[0]
        rows = meshlib.batch_rows(self.mesh, batch)
        wavs, labels, silent = DeviceDataset.gather_batch(
            self.data.arrays, idx[rows], clip_len=cfg.audio.desired_samples)
        noise = self.data.noise_bank
        if getattr(cfg.augment, "naive_background_mix", True) or noise is None:
            wavs = aug.zero_silence(wavs, silent)
        else:
            eval_aug = dataclasses.replace(cfg.augment, method="anchored_slice_or_pad",
                                           background_frequency=0.0,
                                           background_max_volume=0.0)
            gen = self._generator.manual_seed(step_seed(cfg.train.seed, ordinal, _EVAL_STREAM))
            gen.keep(rows, batch)
            wavs = aug.augment_batch(wavs, silent, gen, eval_aug, noise, is_training=False)
        logits = self.model(dsp.preprocess(wavs, self.audio))
        onehot = F.one_hot(labels, cfg.model.num_classes).to(torch.float32)
        losses = losslib.per_example_softmax_cross_entropy(logits, onehot,
                                                           cfg.model.label_smoothing)
        scores = torch.softmax(logits, dim=-1)
        if not meshlib.in_group(self.mesh):
            return scores, labels, losses
        # one gather of [softmax | label | loss] rows (labels < 2^24 are exact)
        rows_all = meshlib.all_gather_rows(self.mesh, torch.cat(
            [scores, labels[:, None].to(torch.float32), losses[:, None]], dim=1), batch)
        c = scores.shape[1]
        return rows_all[:, :c], rows_all[:, c].to(labels.dtype), rows_all[:, c + 1]

    def evaluate(self, state_or_params, batch_stats: Optional[Mapping[str, torch.Tensor]] = None,
                 include_report: bool = True) -> Dict[str, float]:
        """Score the whole split with a TrainState (its EMA parameters when
        optim.use_ema and it has them), or with params and batch_stats
        mappings; the metric dict, with the text report under
        "classification_report" when `include_report`."""
        if batch_stats is None:
            state: TrainState = state_or_params
            use_ema = self.cfg.optim.use_ema and state.ema_params is not None
            params = state.ema_params if use_ema else state.params
            batch_stats = state.batch_stats
        else:
            params = state_or_params
        self.model.load_state_dict({**params, **batch_stats})

        batch = self.cfg.data.eval_batch_size
        all_scores, all_labels, all_losses, infer_times = [], [], [], []
        for ordinal, (idx, mask) in enumerate(self.data.eval_index_batches(batch)):
            t0 = time.perf_counter()
            scores, labels, losses = self._eval_batch(
                torch.as_tensor(idx, device=self.device), ordinal)
            scores, labels, losses = scores.cpu().numpy(), labels.cpu().numpy(), losses.cpu().numpy()
            infer_times.append(time.perf_counter() - t0)
            all_scores.append(scores[mask])
            all_labels.append(labels[mask])
            all_losses.append(losses[mask])

        scores, labels = np.concatenate(all_scores), np.concatenate(all_labels)
        max_labels = getattr(self.cfg.data, "max_labels_for_class_metrics", 10)
        metrics = compute_classification_metrics(
            scores, labels, self.data.label_names,
            use_class_metrics=len(self.data.label_names) < max_labels,
            include_report=include_report)
        metrics["loss"] = float(np.mean(np.concatenate(all_losses)))
        metrics["num_samples"] = float(len(labels))
        steady = infer_times[1:] or infer_times
        metrics["batch_infer_time"] = float(np.mean(steady))
        metrics["unit_infer_time"] = float(np.mean(steady)) / batch
        for name in getattr(self.cfg.data, "exclude_metric_names", ()):
            metrics.pop(name, None)
        return metrics
