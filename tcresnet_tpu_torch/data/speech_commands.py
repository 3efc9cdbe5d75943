"""Speech Commands discovery and the host decode cache (counterpart of
tcresnet_tpu/data/speech_commands.py).

A split is a `<root>/<split>/<label>/*.wav` tree (`tools/prepare_dataset.py`
builds one), from one root or several with the same labels:

  - labels: the sorted label dirs, `_`-prefixed ones skipped, `__null__`
    prepended at index 0;
  - files: label-major, sorted within a label;
  - silence: `num_silent` all-zero rows labelled `__null__` (-1: the
    logical sample count // the label count);
  - noise: every root's `_background_noise_` clips at least one clip
    long, zero-padded to the longest, as one [K, L] float32 bank;
  - oversampling (train only, off by default): the reference's label
    balancing, kept in `sample_row`, a logical -> physical row map the
    train sampler draws through, so no wav is decoded or stored twice.

Every unique file is decoded once (the C++ decoder, else numpy) into an
int16 [N, desired_samples] matrix, cached as `<cache_dir>/<split>-<key>.npy`
(the key hashes the names, sizes and mtimes); a cache hit is a read-only
memory map, which `DeviceDataset` copies. The arrays equal the JAX
loader's bit for bit (`tests/test_torch_speech_commands.py`).
"""

from __future__ import annotations

import hashlib
import logging
import os
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tcresnet_tpu_torch import const
from tcresnet_tpu_torch.data import native_loader
from tcresnet_tpu_torch.data import wav as wavlib

log = logging.getLogger("tcresnet_tpu_torch.data")


@dataclass
class HostDataset:
    """Decoded, host-resident split: everything device_data needs."""

    wavs: np.ndarray  # [N, S] int16 (silence rows all-zero)
    labels: np.ndarray  # [N] int32
    is_silent: np.ndarray  # [N] bool
    label_names: Tuple[str, ...]
    noise_bank: Optional[np.ndarray]  # [K, L] float32 in [-1, 1), or None
    split: str = ""
    # Logical->physical row map from oversampling: [M] int32 with M >= N,
    # or None (identity). Train sampling draws uniformly over the LOGICAL
    # axis; eval visits each physical row exactly once.
    sample_row: Optional[np.ndarray] = None

    @property
    def num_samples(self) -> int:
        """Physical (unique) row count: the eval universe."""
        return int(self.wavs.shape[0])

    @property
    def num_logical_samples(self) -> int:
        """Sampling-universe size: inflated by oversampling duplicates."""
        if self.sample_row is not None:
            return int(self.sample_row.shape[0])
        return self.num_samples

    @property
    def num_classes(self) -> int:
        return len(self.label_names)


def discover_labels(split_dir: Path, add_null_class: bool = True) -> Tuple[str, ...]:
    """Sorted label dirs, `_`-prefixed skipped, null class at index 0."""
    names: List[str] = []
    if add_null_class:
        names.append(const.NULL_CLASS_LABEL)
    for p in sorted(Path(split_dir).glob("*")):
        if p.is_dir() and not p.name.startswith("_"):
            names.append(p.name)
    if not names:
        raise FileNotFoundError(f"No label directories under {split_dir}")
    return tuple(names)


def list_files(split_dir: Path, label_names: Sequence[str]) -> Tuple[List[str], List[int]]:
    """Label-major (filename, label-idx) listing; the null class has no files."""
    filenames, labels = [], []
    for idx, name in enumerate(label_names):
        label_dir = Path(split_dir) / name
        if not label_dir.is_dir():
            continue
        for f in sorted(label_dir.glob("*.wav")):
            filenames.append(str(f))
            labels.append(idx)
    if not filenames:
        raise FileNotFoundError(f"No wav files under {split_dir}")
    return filenames, labels


def oversample(filenames: List, labels: List[int],
               oversampling_ratio: float) -> Tuple[List, List[int]]:
    """Label-balancing oversampling, the reference's literal semantics
    (data_wrapper_base.py:219-248): ratio = int(max(min_needed / count,
    1.0) * 5 + 0.5) with min_needed = int(max_count * oversampling_ratio),
    and each label's entries are appended (ratio - 1) more times. The
    reference's scale of 5 applies to the repetition count itself, so even
    a balanced label grows 5x; kept as it is."""
    by_label = defaultdict(list)
    for fn, lb in zip(filenames, labels):
        by_label[lb].append(fn)
    counts = {lb: len(v) for lb, v in by_label.items()}
    min_needed = int(max(counts.values()) * oversampling_ratio)
    out_f, out_l = list(filenames), list(labels)
    n = 5
    for lb, cnt in sorted(counts.items()):
        ratio = int(max(min_needed / cnt, 1.0) * n + 0.5)
        log.info(f"oversampling label {lb}: {cnt} x {ratio} => {cnt * ratio}")
        for _ in range(ratio - 1):
            out_f.extend(by_label[lb])
            out_l.extend(lb for _ in range(cnt))
    return out_f, out_l


def _decode_all(filenames: Sequence[str], desired_samples: int,
                expected_rate: Optional[int] = None) -> np.ndarray:
    """Decode wavs to an int16 matrix: the C++ batch decoder, or numpy when
    its library is unavailable. A file that fails to decode raises (the
    native decoder names it) rather than being decoded again by numpy.
    `expected_rate` rejects a file whose header rate differs."""
    arr = native_loader.decode_batch(filenames, desired_samples,
                                     expected_rate=expected_rate or 0)
    if arr is not None:
        return arr
    out = np.zeros((len(filenames), desired_samples), np.int16)
    for i, fn in enumerate(filenames):
        out[i], _ = wavlib.decode_wav_int16(fn, desired_samples, expected_rate=expected_rate)
    return out


def _cache_key(filenames: Sequence[str], desired_samples: int) -> str:
    """A key over the names AND each file's size and mtime, so a re-recorded
    wav invalidates the decode cache."""
    h = hashlib.sha256()
    h.update(str(desired_samples).encode())
    stats = {}
    for fn in filenames:
        if fn not in stats:
            try:
                st = os.stat(fn)
                stats[fn] = f"{st.st_size}:{st.st_mtime_ns}"
            except OSError:
                stats[fn] = "?"
        h.update(fn.encode())
        h.update(stats[fn].encode())
    return h.hexdigest()[:16]


def load_noise_bank(split_dirs, min_len: int,
                    expected_rate: Optional[int] = None) -> Optional[np.ndarray]:
    """`_background_noise_` wavs of one split dir or several, as a [K, L]
    float32 bank: clips shorter than `min_len` dropped (a crop of one clip
    must fit), the rest right-padded with zeros to the longest (so crops
    near the end of a shorter clip lean towards silence; the reference kept
    ragged clips apart). None when there are none."""
    if isinstance(split_dirs, (str, Path)):
        split_dirs = [split_dirs]
    clips = []
    for split_dir in split_dirs:
        noise_dir = Path(split_dir) / const.BACKGROUND_NOISE_DIR_NAME
        if not noise_dir.is_dir():
            continue
        for f in sorted(noise_dir.glob("*.wav")):
            samples, _ = wavlib.decode_wav_float32(f, expected_rate=expected_rate)
            if samples.shape[0] >= min_len:
                clips.append(samples)
    if not clips:
        return None
    bank = np.zeros((len(clips), max(c.shape[0] for c in clips)), np.float32)
    for i, c in enumerate(clips):
        bank[i, : c.shape[0]] = c
    log.info(f"{len(clips)} background noise clips loaded (bank {bank.shape})")
    return bank


def load_speech_commands(
    dataset_root,
    split: str,
    desired_samples: int = 16000,
    num_silent: int = -1,
    cache_dir: Optional[str] = None,
    add_null_class: bool = True,
    oversampling_ratio: Optional[float] = None,
    sample_rate: Optional[int] = None,
) -> HostDataset:
    """Load one split of a `<root>/<split>/<label>/*.wav` tree.

    `dataset_root` is a root or a list of roots, whose label sets must
    agree. With `cache_dir` the decode is cached as
    `<cache_dir>/<split>-<key>.npy`, written under a temporary name and
    renamed into place. `sample_rate` (when given) checks every wav header.
    `oversampling_ratio` None or 0 is off.
    """
    roots = [dataset_root] if isinstance(dataset_root, (str, Path)) else list(dataset_root)
    split_dirs = [Path(r) / split for r in roots]
    label_sets = [discover_labels(d, add_null_class) for d in split_dirs]
    if len(set(label_sets)) != 1:
        raise ValueError(f"Different labels across sub-datasets: {label_sets}")
    label_names = label_sets[0]
    filenames, labels = [], []
    for d in split_dirs:
        f, lb = list_files(d, label_names)
        filenames.extend(f)
        labels.extend(lb)
    sample_row = None
    if oversampling_ratio:
        sample_idx, _ = oversample(list(range(len(filenames))), labels, oversampling_ratio)
        sample_row = np.asarray(sample_idx, np.int32)
    n_logical = len(sample_row) if sample_row is not None else len(filenames)

    wavs = None
    if cache_dir:
        cache_path = Path(cache_dir) / f"{split}-{_cache_key(filenames, desired_samples)}.npy"
        if cache_path.exists():
            wavs = np.load(cache_path, mmap_mode="r")
            log.info(f"Loaded decode cache {cache_path}")
    if wavs is None:
        wavs = _decode_all(filenames, desired_samples, sample_rate)
        if cache_dir:
            Path(cache_dir).mkdir(parents=True, exist_ok=True)
            # a process killed mid-save must not leave a truncated file at
            # the keyed path, which the next run would trust
            tmp_path = cache_path.parent / (cache_path.name + ".tmp.npy")
            np.save(tmp_path, wavs)
            tmp_path.replace(cache_path)
            log.info(f"Wrote decode cache {cache_path}")

    wavs = np.asarray(wavs)
    labels = np.asarray(labels, np.int32)
    is_silent = np.zeros(len(labels), bool)

    # silence injection; the auto count uses the LOGICAL sample count
    if add_null_class:
        if num_silent < 0:
            num_silent = n_logical // len(label_names)
        if num_silent > 0:
            null_idx = label_names.index(const.NULL_CLASS_LABEL)
            n_physical = wavs.shape[0]
            wavs = np.concatenate([wavs, np.zeros((num_silent, desired_samples), np.int16)])
            labels = np.concatenate([labels, np.full(num_silent, null_idx, np.int32)])
            is_silent = np.concatenate([is_silent, np.ones(num_silent, bool)])
            if sample_row is not None:
                sample_row = np.concatenate([
                    sample_row, np.arange(n_physical, n_physical + num_silent, dtype=np.int32)])
            log.info(f"{num_silent} silent samples added")

    noise_bank = load_noise_bank(split_dirs, desired_samples, sample_rate)
    log.info(f"split={split}: {len(labels)} samples, {len(label_names)} classes")
    return HostDataset(wavs=wavs, labels=labels, is_silent=is_silent, label_names=label_names,
                       noise_bank=noise_bank, split=split, sample_row=sample_row)
