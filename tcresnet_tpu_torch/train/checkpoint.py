"""Checkpoints as torch state dicts (counterpart of
tcresnet_tpu/train/checkpoint.py:27-100).

One file per saved step, `<dir>/ckpt_<step>.pt`, written under a
temporary name and renamed into place (a save cut off half-way is never
read); the oldest are deleted beyond `max_to_keep`. `restore` loads into
an existing state's tensors; `restore_raw` reads a checkpoint with no
state to fit, so that one of another architecture can be read, and
`restore_params_partial` merges it into a state's tensors by name under
include / exclude scope regexes (the trainer's warm start).

Under data parallelism (`mesh`) the state is replicated, so rank 0 alone
writes and every rank waits for it (a barrier after each save); every
rank restores from the same file.
"""

from __future__ import annotations

import logging
import os
import re
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

from tcresnet_tpu_torch.parallel import mesh as meshlib
from tcresnet_tpu_torch.train.state import TrainState

log = logging.getLogger("tcresnet_tpu_torch.ckpt")

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 5, mesh: Optional[meshlib.Mesh] = None):
        self._dir = Path(directory).resolve()
        self._dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.mesh = mesh

    @property
    def directory(self) -> Path:
        return self._dir

    def path(self, step: int) -> Path:
        return self._dir / f"ckpt_{int(step)}.pt"

    def save(self, step: int, state: TrainState) -> None:
        if self.mesh is None or self.mesh.is_chief:
            final = self.path(step)
            tmp = final.with_name(f"{final.name}.{os.getpid()}.tmp")
            torch.save(state.state_dict(), tmp)
            os.replace(tmp, final)
            if self.max_to_keep > 0:
                for old in self.all_steps()[:-self.max_to_keep]:
                    self.path(old).unlink(missing_ok=True)
        meshlib.barrier(self.mesh)

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

    def restore_raw(self, step: Optional[int] = None) -> Dict[str, object]:
        """Checkpoint `step` (the latest by default) as saved, CPU tensors in
        plain dicts, read with no state to fit: the checkpoint may come from
        another architecture (the reference's transfer learning,
        common/model_loader.py:42-83)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoints under {self._dir}")
        raw = torch.load(self.path(step), map_location="cpu", weights_only=True)
        log.info(f"Raw-restored checkpoint step {step} from {self._dir}")
        return raw


def _path_matches(path_str: str, scopes: Sequence[str]) -> bool:
    # PREFIX-ANCHORED (re.match), the reference's startswith scope filters
    # (common/model_loader.py:55-56): "fc" must not match "block3/fc_proj"
    return any(re.match(s, path_str) for s in scopes)


def restore_params_partial(
    params: Mapping[str, torch.Tensor],
    restored_params: Mapping[str, torch.Tensor],
    include_scopes: Optional[Sequence[str]] = None,
    exclude_scopes: Optional[Sequence[str]] = None,
    ignore_missing: bool = False,
    path_of: Callable[[str], str] = str,
) -> Dict[str, torch.Tensor]:
    """{name: tensor}: `restored_params[name]` where `name` is wanted, else
    `params[name]` (both by state-dict name).

    A name is wanted when its path, `path_of(name)`, matches an include
    scope (all when none are given) and no exclude scope; scopes are
    prefix-anchored regexes. The trainer's `path_of` is the Flax path the
    JAX package matches its scopes against (`models/convert.py::jax_path`),
    so one scope selects the same tensors in both packages. A wanted name
    missing from `restored_params` raises KeyError and one of another
    shape ValueError, unless `ignore_missing`: then it keeps `params`'s.
    """
    merged = {}
    for name, new in params.items():
        p = path_of(name)
        wanted = _path_matches(p, include_scopes) if include_scopes else True
        if wanted and exclude_scopes and _path_matches(p, exclude_scopes):
            wanted = False
        old = restored_params.get(name) if wanted else None
        if old is not None and tuple(old.shape) != tuple(new.shape):
            if not ignore_missing:
                raise ValueError(f"Shape mismatch for {p}: {tuple(old.shape)} vs "
                                 f"{tuple(new.shape)}")
            old = None
        elif wanted and old is None and not ignore_missing:
            raise KeyError(f"Missing {p} in restored params")
        merged[name] = new if old is None else old
    return merged
