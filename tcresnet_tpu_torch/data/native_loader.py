"""ctypes bindings of the C++ batch WAV decoder (counterpart of
tcresnet_tpu/data/native_loader.py:27-120).

`csrc/wav_decoder.cc` is built with g++ at first use into
`tcresnet_tpu_torch/csrc/build/` (`ops/kernels/_build.py::build_host`).
This is host code, not a device kernel: where no library can be built or
loaded, `decode_batch` and `wav_num_samples` return None, the fallback is
logged, and the loader decodes with numpy (`data/wav.py`), as the JAX
package does. `available()` says which one runs.

`files_decoded` counts the files the library decoded (since import, or
since a caller reset it to 0).
"""

from __future__ import annotations

import ctypes
import functools
import logging
import subprocess
from typing import Optional, Sequence

import numpy as np

from tcresnet_tpu_torch.ops.kernels import _build

log = logging.getLogger("tcresnet_tpu_torch.native")

files_decoded = 0


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    """The typed library, or None (logged) when it cannot be built or loaded."""
    try:
        path = _build.build_host("wav_decoder")
        lib = ctypes.CDLL(str(path))
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        log.warning(f"native wav decoder unavailable ({e}); decoding with numpy")
        return None
    lib.tcresnet_decode_batch.restype = ctypes.c_int
    lib.tcresnet_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.tcresnet_wav_num_samples.restype = ctypes.c_int
    lib.tcresnet_wav_num_samples.argtypes = [ctypes.c_char_p]
    log.info(f"native wav decoder loaded: {path}")
    return lib


def available() -> bool:
    return _load() is not None


def decode_batch(filenames: Sequence[str], desired_samples: int, n_threads: int = 0,
                 expected_rate: int = 0) -> Optional[np.ndarray]:
    """Decode wavs into [N, desired_samples] int16, or None when the library
    is unavailable. Raises ValueError naming the files that failed to
    decode; expected_rate > 0 rejects a file whose header sample rate
    differs (status -4)."""
    global files_decoded
    lib = _load()
    if lib is None:
        return None
    n = len(filenames)
    out = np.zeros((n, desired_samples), np.int16)
    status = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[str(f).encode() for f in filenames])
    failures = lib.tcresnet_decode_batch(
        arr, n, desired_samples, expected_rate,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
    if failures:
        bad = [f"{filenames[i]} (rc={status[i]})" for i in np.nonzero(status)[0][:5]]
        raise ValueError(f"{failures} wav files failed to decode, e.g. {bad}")
    files_decoded += n
    return out


def wav_num_samples(path) -> Optional[int]:
    """The file's sample count before any crop, or None (no library, or a
    file it cannot read)."""
    lib = _load()
    if lib is None:
        return None
    rc = lib.tcresnet_wav_num_samples(str(path).encode())
    return rc if rc >= 0 else None
