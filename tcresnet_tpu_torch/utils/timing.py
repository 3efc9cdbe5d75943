"""Wall-clock timers for step logging and benchmarks (counterpart of
tcresnet_tpu/utils/timing.py).

`Timer` is a context manager whose `.elapsed` holds the seconds of its
block, and `timeit` the same as a `with` helper that logs. They read the host
clock (`time.perf_counter`) and nothing else: PyTorch returns before the
card finishes, so a block that times work on the card ends with
`torch.cuda.synchronize()` or a read of a result on the host.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class Timer:
    """Context-manager stopwatch; `.elapsed` in seconds after exit. Given a
    logger, logs "<message> took X ms" at exit."""

    def __init__(self, logger=None, message: str = ""):
        self._logger = logger
        self._message = message
        self.elapsed = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._start
        if self._logger is not None:
            self._logger.info(f"{self._message} took {self.elapsed * 1000:.2f} ms")
        return False


@contextmanager
def timeit(logger, message: str):
    t = Timer(logger, message)
    with t:
        yield t

