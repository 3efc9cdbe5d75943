"""Best-checkpoint keeping with scores.tsv (counterpart of
tcresnet_tpu/evaluation/best_keeper.py:18-197).

Per (split, metric) best tracking with min/max modes and epsilon 5e-5;
the scores of each improved metric are written to
`<dir>/<split>/<metric>/scores.tsv` (sorted keys on one line, values as
"%.5f" on the next, as the JAX package writes them) and re-read on
restart, so a restarted evaluator resumes its bests. A promotion writes
the evaluated state as a fresh port checkpoint (`train/checkpoint.py`,
`ckpt_<step>.pt`, max_to_keep=1) into the same directory.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional, Tuple

from tcresnet_tpu_torch.train.checkpoint import CheckpointManager
from tcresnet_tpu_torch.train.state import TrainState

# The metrics tracked for audio classification, and their modes.
DEFAULT_BEST_METRICS = {
    "accuracy": "max",
    "loss": "min",
}


class BestKeeper:
    EPSILON = 5e-5  # a score must beat the best by more than this
    SCORE_FILE = "scores.tsv"

    def __init__(self, metric_with_modes: Dict[str, str], dataset_name: str, directory):
        self.log = logging.getLogger("tcresnet_tpu_torch.best_keeper")
        self.dataset_name = dataset_name
        self.directory = Path(directory)
        self.modes = dict(metric_with_modes)
        self.metric_best: Dict[str, float] = {}
        for metric, mode in self.modes.items():
            if mode not in ("min", "max"):
                raise ValueError(f"Unsupported mode {mode!r} for {metric}")
            default = float("inf") if mode == "min" else float("-inf")
            self.metric_best[metric] = self._load_score(metric, default)
        resumed = {k: v for k, v in self.metric_best.items() if abs(v) != float("inf")}
        self.log.info(f"BestKeeper[{dataset_name}]: {self.modes} (resumed bests {resumed})")

    def _metric_dir(self, metric: str) -> Path:
        return self.directory / self.dataset_name / metric

    def _load_score(self, metric: str, default: float) -> float:
        path = self._metric_dir(metric) / self.SCORE_FILE
        if not path.exists():
            return default
        with open(path) as f:
            header = f.readline().strip().split("\t")
            values = f.readline().strip().split("\t")
        try:
            return float(values[header.index(metric)])
        except (ValueError, IndexError):
            return default

    def _better(self, metric: str, x: float, y: float) -> bool:
        if self.modes[metric] == "min":
            return x < y - self.EPSILON
        return x > y + self.EPSILON

    def monitor(self, eval_scores: Dict[str, float]) -> Tuple[bool, Dict[str, bool]]:
        """Which tracked metrics improved; updates the bests. A tracked
        metric missing from the scores (e.g. excluded by
        DataConfig.exclude_metric_names) is reported and not promoted."""
        keep = {}
        for metric in self.modes:
            if metric not in eval_scores:
                self.log.warning(
                    f"[KeepBest/{self.dataset_name}] tracked metric {metric!r} missing from "
                    f"eval results (available: {sorted(eval_scores)[:8]}...): not promoting")
                keep[metric] = False
                continue
            score = eval_scores[metric]
            keep[metric] = self._better(metric, score, self.metric_best[metric])
            if keep[metric]:
                self.log.info(f"[KeepBest/{self.dataset_name}] {metric} "
                              f"{self.metric_best[metric]:.6f} -> {score:.6f}")
                self.metric_best[metric] = score
        return any(keep.values()), keep

    def save_best_state(self, metrics_keep: Dict[str, bool], state: TrainState,
                        step: int) -> None:
        """Write the evaluated in-memory state into each improved metric's
        directory as checkpoint `step`, replacing the one promoted before
        (or one of the same step). Promoting from memory is immune to the
        trainer's max_to_keep deleting the step while it was evaluated."""
        for metric, is_keep in metrics_keep.items():
            if is_keep:
                CheckpointManager(self._metric_dir(metric), max_to_keep=1).save(step, state)

    def save_scores(self, metrics_keep: Dict[str, bool], eval_scores: Dict[str, float],
                    meta_info: Optional[Dict] = None) -> None:
        scores = {k: v for k, v in eval_scores.items() if not isinstance(v, str)}
        if meta_info:
            scores.update(meta_info)
        keys = sorted(scores)
        for metric, is_keep in metrics_keep.items():
            if not is_keep:
                continue
            path = self._metric_dir(metric)
            path.mkdir(parents=True, exist_ok=True)
            with open(path / self.SCORE_FILE, "w") as f:
                f.write("\t".join(keys) + "\n")
                f.write("\t".join(f"{scores[k]:.5f}" for k in keys) + "\n")

    def best_checkpoint_dir(self, metric: str) -> Optional[Path]:
        """The checkpoint directory of the promoted best for `metric` (it
        holds one `ckpt_<step>.pt`), or None before any promotion."""
        d = self._metric_dir(metric)
        if not d.is_dir() or CheckpointManager(d).latest_step() is None:
            return None
        return d
