"""One run of one cell: set-up, the measured (or traced) window, the check
of what the window produced, and the result line.

A traffic kind (`traffic/<kind>.py`) provides `Driver(run)` with:

- `setup()`: build the program, make inputs and weights from the seed,
  drive the checked work through the window's own call, warm every shape;
- `window(seconds) -> {end-to-end metric: value}` with `attempted`, `failed`;
- `traced(seconds)`: fill `run.obs` with what the per-layer readers read
  (spans of the harness, counters, probes timed alone) and profile a
  bounded sub-window;
- `release()`: drop the program's state once the memory peak is read;
- `check() -> {number: value}`: compare with the plain reference.

Each number's limit comes from `cells/<cell>.json`, which also keeps the
readings it was set from.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from portbench.harness import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "tcresnet_tpu")


def process_start() -> float:
    """The process's start on the `time.time()` clock (Linux: from
    /proc/self/stat; elsewhere the first call)."""
    try:
        ticks = int(open("/proc/self/stat").read().rsplit(")", 1)[1].split()[19])
        boot = next(float(line.split()[1]) for line in open("/proc/stat")
                    if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


@dataclass
class Run:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float = field(default_factory=process_start)
    obs: Dict[str, float] = field(default_factory=dict)
    notes: Dict[str, object] = field(default_factory=dict)
    breakdown: Optional[dict] = None
    driver: object = None

    @property
    def card(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    def mark(self, phase: str) -> None:
        """Note the seconds since the process started at the end of a set-up phase."""
        self.notes.setdefault("setup_phases", {})[phase] = round(time.time() - self.started, 3)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def limits(cell_name: str) -> Dict[str, float]:
    path = spec.BENCH_DIR / "cells" / f"{cell_name}.json"
    return json.loads(path.read_text())["limits"]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(r: Run, peak_bytes: int) -> dict:
    info = {"platform": "gpu" if r.device.type == "cuda" else r.device.type, "kind": r.card,
            "count": r.cell.chips if r.device.type == "cuda" else 1,
            "memory_peak_bytes": int(peak_bytes)}
    if r.trace:
        info["busy_s"] = r.obs.get("trace.busy_s", 0.0)
        info["window_s"] = r.obs.get("trace.window_s", 0.0)
    return info


def run_cell(r: Run) -> dict:
    """The result of one run; raises where a run cannot give one."""
    cell = r.cell
    driver = r.driver = cell.kind.Driver(r)
    driver.setup()
    setup_s = time.time() - r.started
    metrics: Dict[str, dict] = {}
    attempted = failed = 0
    if r.trace:
        driver.traced(r.seconds)
    else:
        out = driver.window(r.seconds)
        attempted, failed = out.pop("attempted"), out.pop("failed")
        values = {**out, "setup_s": setup_s}
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    peak_bytes = torch.cuda.max_memory_allocated(r.device) if r.device.type == "cuda" else 0
    if r.trace:
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(r)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        attempted, failed = r.obs.get("attempted", 0), r.obs.get("failed", 0)
    info = device_info(r, peak_bytes)
    driver.release()
    numbers = driver.check()
    lim = limits(cell.name)
    checks = {k: {"value": v, "limit": lim[k]} for k, v in numbers.items()}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values()) \
        and set(checks) == set(lim)
    result = {"correct": correct, "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": info}
    if r.trace and r.breakdown:
        result["breakdown"] = r.breakdown
    result["checks"] = checks
    return result
