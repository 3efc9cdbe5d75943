"""Checkpoints as torch state dicts (counterpart of
tcresnet_tpu/train/checkpoint.py:27-100).

One file per saved step, `<dir>/ckpt_<step>.pt`, written under a
temporary name and renamed into place (a save cut off half-way is never
read); the oldest are deleted beyond `max_to_keep`. `restore` loads into
an existing state's tensors. Scope-filtered partial restore and warm start
are still to port (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

import logging
import os
import re
from pathlib import Path
from typing import List, Optional

import torch

from tcresnet_tpu_torch.train.state import TrainState

log = logging.getLogger("tcresnet_tpu_torch.ckpt")

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 5):
        self._dir = Path(directory).resolve()
        self._dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    @property
    def directory(self) -> Path:
        return self._dir

    def path(self, step: int) -> Path:
        return self._dir / f"ckpt_{int(step)}.pt"

    def save(self, step: int, state: TrainState) -> None:
        final = self.path(step)
        tmp = final.with_name(f"{final.name}.{os.getpid()}.tmp")
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, final)
        if self.max_to_keep > 0:
            for old in self.all_steps()[:-self.max_to_keep]:
                self.path(old).unlink(missing_ok=True)

    def all_steps(self) -> List[int]:
        """Saved steps, ascending (re-read from the directory every call)."""
        return sorted(int(m.group(1)) for p in self._dir.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load checkpoint `step` (the latest by default) into `state`."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoints under {self._dir}")
        saved = torch.load(self.path(step), map_location="cpu", weights_only=True)
        state.load_state_dict(saved)
        log.info(f"Restored checkpoint step {step} from {self._dir}")
        return state
