"""Bounded profiled windows, read in memory (no trace file is written).

`Profiled(device, host)` wraps `torch.profiler` around a block that ends
with a synchronise. Recording the host's operators costs the host about as
much as the operators themselves, which stretches a host-paced window, so
the device's busy share is read from a window that records the device's
activities alone (`host=False`), and what the host was doing in each idle
gap from a second window that records both (`host=True`).

`summary()` gives:

- `window_s`: the block's host time;
- `busy_s`: the union of the device's kernel, copy and set activities in it;
- `device_ops`: the device activities that took most time, summed by name;
- with `host=True`, `idle_gaps`: the device's idle time inside the block,
  summed by what the host was doing when each gap began (the innermost
  host operator under way, or "python" where none was).

The harness's own spans (`record_function`), which the profiler also
mirrors on the device's timeline, are not device activity and are left out.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "portbench.window"
TOP = 10


class Profiled:
    def __init__(self, device: torch.device, host: bool):
        from torch.profiler import ProfilerActivity, profile

        activities = []
        if host or device.type != "cuda":
            activities.append(ProfilerActivity.CPU)
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.device, self.host = device, host
        self.prof = profile(activities=activities)
        self.window_s = 0.0

    @contextlib.contextmanager
    def window(self):
        self.prof.start()
        try:
            t0 = time.perf_counter()
            with torch.profiler.record_function(WINDOW):
                yield
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            self.window_s = time.perf_counter() - t0
        finally:
            self.prof.stop()

    def summary(self) -> Dict[str, object]:
        events = list(self.prof.events())
        spans = [e for e in events if e.name == WINDOW]
        w0, w1 = ((spans[0].time_range.start, spans[0].time_range.end) if spans
                  else (-float("inf"), float("inf")))
        dev, host = [], []
        for e in events:
            start, end = e.time_range.start, e.time_range.end
            if e.name == WINDOW or getattr(e, "is_user_annotation", False) or end <= start:
                continue  # a span of the harness, on the host or mirrored on the device
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if end > w0 and start < w1:
                    dev.append((max(start, w0), min(end, w1), e.name))
            else:
                host.append((start, end, e.name))
        busy = _union([(a, b) for a, b, _ in dev])
        ops: Dict[str, float] = defaultdict(float)
        for a, b, name in dev:
            ops[name] += (b - a) * 1e-6
        out = {"window_s": self.window_s, "busy_s": sum(b - a for a, b in busy) * 1e-6,
               "device_ops": _top(ops)}
        if self.host and spans:
            gaps: Dict[str, float] = defaultdict(float)
            at = _HostIndex(host)
            for a, b in _gaps(busy, w0, w1):
                gaps[at(a)] += (b - a) * 1e-6
            out["idle_gaps"] = _top(gaps)
        return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _gaps(busy, w0, w1):
    t = w0
    for a, b in busy:
        if a > t:
            yield t, a
        t = max(t, b)
    if w1 > t:
        yield t, w1


class _HostIndex:
    """The innermost host operator under way at a time: among the last
    `SCAN` operators to start before it, else among the long ones (spans
    of a millisecond or more, which enclose the rest)."""

    SCAN = 64

    def __init__(self, host: List[Tuple[float, float, str]]):
        self.host = sorted(host)
        self.starts = [a for a, _, _ in self.host]
        self.long = [h for h in self.host if h[1] - h[0] >= 1000.0]

    def __call__(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t)
        best: Optional[Tuple[float, str]] = None
        for a, b, name in self.host[max(0, i - self.SCAN):i]:
            if b > t and (best is None or b - a < best[0]):
                best = (b - a, name)
        if best is None:
            for a, b, name in self.long:
                if a <= t < b and (best is None or b - a < best[0]):
                    best = (b - a, name)
        return best[1] if best else "python"


def _top(sums: Dict[str, float]) -> List[List[object]]:
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]]


def profile_twice(device: torch.device, block, obs: Dict[str, float]) -> dict:
    """Run `block()` under a device-only profile, then again under a full
    one; fill `obs` with the first's busy and window seconds and return the
    breakdown (the first's device operations, the second's idle gaps)."""
    quiet, full = Profiled(device, host=False), Profiled(device, host=True)
    with quiet.window():
        block()
    with full.window():
        block()
    first, second = quiet.summary(), full.summary()
    obs["trace.busy_s"], obs["trace.window_s"] = first["busy_s"], first["window_s"]
    obs["trace.host_recorded_window_s"] = second["window_s"]
    return {"device_ops": first["device_ops"], "idle_gaps": second.get("idle_gaps", [])}
