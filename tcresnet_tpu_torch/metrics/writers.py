"""Metric/summary writers with tiered cadence (the port's own copy of
tcresnet_tpu/metrics/writers.py).

Reference parity: metrics/summaries.py's three collection tiers
(DEFAULT every 10 steps / VERBOSE every 2000 / FIRST_N first 30,
helper/trainer.py:377-391) and train-vs-eval writer separation
(summaries.py:121-142). Backends: JSONL always (machine-readable record,
replaces scores-in-TB), TensorBoard via tensorboardX when available.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict


class MetricWriter:
    def __init__(self, directory, name: str = "train", use_tensorboard: bool = True):
        self._dir = Path(directory)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self._dir / f"{name}_metrics.jsonl", "a", buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(logdir=str(self._dir / name))
            except Exception:
                self._tb = None

    def write(self, step: int, metrics: Dict[str, float], prefix: str = "") -> None:
        import math

        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            if isinstance(v, str):
                continue
            v = float(v)
            # bare NaN/Infinity tokens are not valid JSON (strict
            # consumers like jq/JSON.parse reject the whole line) —
            # undefined metrics (e.g. mAP on a single-class batch)
            # become null
            record[key] = v if math.isfinite(v) else None
            if self._tb is not None and math.isfinite(v):
                self._tb.add_scalar(key, v, int(step))
        self._jsonl.write(json.dumps(record) + "\n")

    def write_text(self, step: int, tag: str, text: str) -> None:
        if self._tb is not None:
            self._tb.add_text(tag, text, int(step))

    def write_audio(
        self, step: int, tag: str, wavs, sample_rate: int = 16000,
        max_clips: int = 5,
    ) -> None:
        """Audio summaries of input wavs (reference WavSummaryOp,
        metrics/ops/tensor_ops.py:40-54); TensorBoard-only, capped at
        max_clips (reference --max_outputs default 5, trainer.py:498)."""
        if self._tb is None or not getattr(self, "_audio_ok", True):
            return
        import numpy as np

        wavs = np.asarray(wavs)
        try:
            for i, wav in enumerate(wavs[:max_clips]):
                self._tb.add_audio(
                    f"{tag}/{i}", wav.reshape(-1, 1), int(step),
                    sample_rate=sample_rate,
                )
        except Exception:  # tensorboardX audio needs soundfile; optional
            # scalars keep working; skip the (re-)conversion cost on
            # every later verbose step
            self._audio_ok = False

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullWriter:
    """MetricWriter's interface, writing nothing: the writer of every rank
    but rank 0 under data parallelism, whose metrics are rank 0's."""

    def write(self, *args, **kwargs) -> None:
        pass

    write_text = write_audio = flush = close = write


def metric_writer(directory, name: str = "train", chief: bool = True):
    """A MetricWriter for the one process that writes (`chief`), else a
    NullWriter."""
    return MetricWriter(directory, name) if chief else NullWriter()


def crossed_boundary(prev_step: int, step: int, every: int) -> bool:
    """True if advancing prev_step -> step crossed a multiple of `every`.

    The train loop advances `steps_per_call` steps per host dispatch;
    interval checks must fire whenever a boundary falls anywhere inside
    the advanced window (a plain `step % every == 0` silently skips
    boundaries whenever steps_per_call does not divide `every`).
    """
    return every > 0 and (step // every) > (prev_step // every)


def should_write_summary(
    step: int, default_every: int, verbose_every: int, first_n: int,
    prev_step: int = None, min_step: int = 0,
) -> bool:
    """Tiered cadence check (helper/trainer.py:377-391).

    With `prev_step` given, uses boundary-crossing semantics over the
    (prev_step, step] window; otherwise exact-step checks. `min_step`
    gates the DEFAULT tier only (reference --step_min_summaries,
    helper/trainer.py:377,503; first-N and verbose tiers are ungated,
    as in the reference). Deviation: gated on the absolute step, not
    step_from_restore — all cadences here are absolute (SURVEY.md 7.5).
    """
    if prev_step is None:
        prev_step = step - 1
    return (
        prev_step < first_n
        or (step >= min_step and crossed_boundary(prev_step, step, default_every))
        or crossed_boundary(prev_step, step, verbose_every)
    )
