"""The port's timers (`tcresnet_tpu_torch/utils/timing.py`) against the JAX
package's (`tcresnet_tpu/utils/timing.py`) on one fake clock."""

import logging

import pytest

from tcresnet_tpu.utils import timing as jax_timing
from tcresnet_tpu_torch.utils import timing


class FakeClock:
    """perf_counter that advances by the next of `steps` at every read."""

    def __init__(self, steps):
        self.now, self.steps = 100.0, list(steps)

    def __call__(self):
        self.now += self.steps.pop(0) if self.steps else 0.0
        return self.now


def _patch(monkeypatch, module, steps):
    monkeypatch.setattr(module.time, "perf_counter", FakeClock(steps))


@pytest.mark.parametrize("module", [jax_timing, timing], ids=["jax", "port"])
def test_timer_elapsed_and_log(monkeypatch, caplog, module):
    _patch(monkeypatch, module, [0.0, 0.25])
    log = logging.getLogger("timing-test")
    with caplog.at_level(logging.INFO, logger="timing-test"):
        with module.Timer(log, "step") as t:
            pass
        with module.timeit(log, "eval") as t2:
            pass
    assert t.elapsed == pytest.approx(0.25)
    assert t2.elapsed == 0.0
    assert [r.getMessage() for r in caplog.records] == ["step took 250.00 ms",
                                                         "eval took 0.00 ms"]


def test_timer_leaves_exceptions_alone(monkeypatch):
    _patch(monkeypatch, timing, [0.0, 1.0])
    with pytest.raises(KeyError):
        with timing.Timer() as t:
            raise KeyError("x")
    assert t.elapsed == pytest.approx(1.0)
