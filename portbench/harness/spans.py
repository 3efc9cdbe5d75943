"""One traced pass of the cell's own traffic through the program's tracer
(`tcresnet_tpu_torch.utils.profiling`: `span`, `tracing`, `drain`), read
by the span metrics.

`observe(run)` runs the pass the first time a reader calls it in a run,
after the kind's `traced()` and before `release()`, and caches what it read
in `run.obs["spans.*"]` and `run.notes["spans.*"]`:

- training: `TRAIN_CALLS` calls of `steps_per_call` steps, each ended by
  reading its loss, under `tracing(device_events=True)`; the records of the
  `train.call`, `train.step` and phase spans, each with the device
  milliseconds between its CUDA events;
- serving: half of `trace_requests` requests, each read back with `.cpu()`
  and kept in the driver's `done` (so `check()` covers answers given with
  the tracer on), under `tracing(device_events=False)`: the metrics read
  the spans' host times, and a pair of CUDA events costs the host ~26 us
  of the request it times; with the change of the program's `k5_tables`
  counter; on a card, then `profile_requests` more under a device-only
  `torch.profiler`, the tracer on and device events off, whose idle time
  is put down to the innermost span open on the host at each moment (the
  spans' clock is the profiler's).

A program without the tracer gives no pass: `observe` returns False and
every reader None. The pass adds its steps or requests to
`run.obs["attempted"]` and prints one `portbench: spans {...}` line to
standard error: per span name its count, host ms, self host ms (less its
children's) and device ms where recorded, summed over the pass; with the
training phases' sum against the step and the step against the untraced
host-timed step, or the serving idle time by innermost span ("outside"
where none was open).
"""

from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from portbench.harness.trace import _union

TRAIN_CALLS = 3
PHASES = ("train.draw", "train.input", "train.forward", "train.backward", "train.optimizer")
REQUEST = "serve.request"
OUTSIDE = "outside"
_NEEDS = ("span", "tracing", "drain", "clock_ns", "trace_start_ns")


def _tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from tcresnet_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if all(hasattr(profiling, n) for n in _NEEDS) else None


def observe(run) -> bool:
    """Run the pass once per run; whether it ran (and left records)."""
    if "spans.ran" not in run.obs:
        run.obs["spans.ran"] = 0.0
        tracer = _tracer()
        kind = run.cell.traffic.get("kind")
        if tracer is not None and kind in ("train", "serve"):
            (_train_pass if kind == "train" else _serve_pass)(run, tracer)
            run.obs["spans.ran"] = 1.0
            print(f"portbench: spans {json.dumps(summary(run))}", file=sys.stderr)
    return bool(run.obs["spans.ran"])


def _train_pass(run, tracer) -> None:
    d, n = run.driver, run.cell.traffic["steps_per_call"]
    with tracer.tracing(device_events=True):
        for _ in range(TRAIN_CALLS):
            float(d._call(n)["total_loss"])
        run.notes["spans.records"] = tracer.drain()
    run.obs["attempted"] = run.obs.get("attempted", 0) + TRAIN_CALLS * n


def _serve_pass(run, tracer) -> None:
    from tcresnet_tpu_torch.ops.kernels import launch_counts

    d, o = run.driver, run.obs

    def send(count):
        for _ in range(count):
            off, b, x = d._request()
            d.done.append((off, b, d.fn(x).cpu()))

    n = d.t["trace_requests"] // 2
    before = launch_counts()["k5_tables"]
    with tracer.tracing(device_events=False):
        send(n)
        run.notes["spans.records"] = tracer.drain()
    o["spans.k5_tables"] = launch_counts()["k5_tables"] - before
    o["attempted"] = o.get("attempted", 0) + n
    if run.device.type != "cuda":
        return
    from torch.profiler import ProfilerActivity, profile

    m = d.t["profile_requests"]
    prof = profile(activities=[ProfilerActivity.CUDA])
    with tracer.tracing(device_events=False):
        run.sync()
        prof.start()
        try:
            w0 = tracer.clock_ns()
            send(m)
            run.sync()
            w1 = tracer.clock_ns()
        finally:
            prof.stop()
        records = tracer.drain()
    o["attempted"] += m
    origin = tracer.trace_start_ns(prof)
    busy = [(origin + round(1e3 * e.time_range.start), origin + round(1e3 * e.time_range.end))
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.time_range.end > e.time_range.start]
    idle = idle_by_span(busy, records, w0, w1)
    run.notes["spans.idle_s"] = idle
    o["spans.idle_s"] = sum(idle.values())
    o["spans.idle_in_request_s"] = idle_inside(busy, records, w0, w1, REQUEST)


# ---------------------------------------------------------------------------
# what the readers read
# ---------------------------------------------------------------------------


def records(run) -> List[dict]:
    return run.notes.get("spans.records", []) if observe(run) else []


def step_phases(recs: Sequence[dict]) -> List[Dict[str, float]]:
    """Per `train.step` with device times: the step's device ms and each of
    its child spans' (summed by name)."""
    children = defaultdict(list)
    for r in recs:
        children[r["parent"]].append(r)
    out = []
    for s in recs:
        if s["name"] != "train.step" or s["device_ms"] is None:
            continue
        row = {"train.step": s["device_ms"]}
        for c in children[s["id"]]:
            if c["device_ms"] is not None:
                row[c["name"]] = row.get(c["name"], 0.0) + c["device_ms"]
        out.append(row)
    return out


def phase_median(run, names: Iterable[str]) -> Optional[float]:
    """The median over steps of the named phases' device ms, summed."""
    names = tuple(names)
    per_step = [sum(row[n] for n in names) for row in step_phases(records(run))
                if all(n in row for n in names)]
    return statistics.median(per_step) if per_step else None


def requests(run, route: Optional[str] = None) -> List[dict]:
    return [r for r in records(run) if r["name"] == REQUEST
            and (route is None or r["attrs"].get("route") == route)]


def request_host_ms(run, route: str) -> Optional[float]:
    """The mean host ms of the `serve.request` spans on `route`."""
    reqs = requests(run, route)
    if not reqs:
        return None
    return 1e-6 * sum(r["end_ns"] - r["start_ns"] for r in reqs) / len(reqs)


def _segments(recs: Sequence[dict], w0: int, w1: int) -> List[Tuple[int, int, Tuple[str, ...]]]:
    """[w0, w1] cut at every span boundary, each piece with the names of the
    spans open over it, outermost first (spans of one thread nest)."""
    marks = sorted([(r["start_ns"], 1, -r["end_ns"], r["name"]) for r in recs]
                   + [(r["end_ns"], 0, 0, r["name"]) for r in recs])
    out, stack, t = [], [], w0
    for at, opens, _, name in marks:
        at = min(max(at, w0), w1)
        if at > t:
            out.append((t, at, tuple(stack)))
            t = at
        if opens:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
    if w1 > t:
        out.append((t, w1, tuple(stack)))
    return out


def _idle_pieces(busy, recs, w0, w1):
    """(seconds, open span names) of each piece of [w0, w1] in which the
    device ran nothing."""
    free, t = [], w0
    for a, b in _union([(max(a, w0), min(b, w1)) for a, b in busy if b > w0 and a < w1]):
        if a > t:
            free.append((t, a))
        t = max(t, b)
    if w1 > t:
        free.append((t, w1))
    segs = _segments(recs, w0, w1)
    i = 0
    for a, b in free:
        while i < len(segs) and segs[i][1] <= a:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < b:
            lo, hi = max(a, segs[j][0]), min(b, segs[j][1])
            if hi > lo:
                yield 1e-9 * (hi - lo), segs[j][2]
            j += 1


def idle_by_span(busy, recs, w0: int, w1: int) -> Dict[str, float]:
    """The device's idle seconds in [w0, w1] (spans' clock, ns), summed by
    the innermost span open on the host, OUTSIDE where none was."""
    out: Dict[str, float] = defaultdict(float)
    for seconds, stack in _idle_pieces(busy, recs, w0, w1):
        out[stack[-1] if stack else OUTSIDE] += seconds
    return dict(out)


def idle_inside(busy, recs, w0: int, w1: int, name: str) -> float:
    """The device's idle seconds in [w0, w1] while a span `name` was open."""
    return sum(s for s, stack in _idle_pieces(busy, recs, w0, w1) if name in stack)


def summary(run) -> dict:
    """What the stderr line prints (see the module's notes)."""
    recs = run.notes.get("spans.records", [])
    children = defaultdict(int)
    for r in recs:
        if r["parent"] is not None:
            children[r["parent"]] += r["end_ns"] - r["start_ns"]
    by: Dict[str, dict] = {}
    for r in recs:
        host = r["end_ns"] - r["start_ns"]
        row = by.setdefault(r["name"], {"count": 0, "host_ms": 0.0, "self_host_ms": 0.0})
        row["count"] += 1
        row["host_ms"] += 1e-6 * host
        row["self_host_ms"] += 1e-6 * (host - children[r["id"]])
        if r["device_ms"] is not None:
            row["device_ms"] = row.get("device_ms", 0.0) + r["device_ms"]
    out = {"spans": {k: {f: round(v, 4) for f, v in row.items()} for k, row in by.items()}}
    steps = step_phases(recs)
    if steps:
        ratio = [sum(row.get(p, 0.0) for p in PHASES) / row["train.step"] for row in steps
                 if row["train.step"] > 0]
        out["phases_over_step_median"] = round(statistics.median(ratio), 5) if ratio else None
        out["phases_over_step_range"] = [round(min(ratio), 5), round(max(ratio), 5)] \
            if ratio else None
        out["step_device_ms_median"] = round(statistics.median(r["train.step"] for r in steps), 4)
        if run.obs.get("train.steps"):
            out["untraced_step_ms"] = round(1e3 * run.obs["train.timed_s"]
                                            / run.obs["train.steps"], 4)
    if "spans.k5_tables" in run.obs:
        out["k5_tables"] = run.obs["spans.k5_tables"]
    if "spans.idle_s" in run.notes:
        out["idle_ms_by_span"] = {k: round(1e3 * v, 4) for k, v in sorted(
            run.notes["spans.idle_s"].items(), key=lambda kv: -kv[1])}
        out["idle_ms_in_request"] = round(1e3 * run.obs["spans.idle_in_request_s"], 4)
    return out
