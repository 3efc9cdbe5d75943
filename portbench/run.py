"""Run one cell of the benchmark once and print its result line.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix and per-layer metrics are found by
name from BENCHMARK.json at the checkout's root (portbench/harness/spec.py).
The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), `device`, with --trace 1 `breakdown`, and
last `checks`, each compared number beside its limit; the same numbers end
standard error. A run without the CUDA cards the cell asks for, or whose
process has loaded JAX or the JAX package once the window has closed,
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench.harness import run as harness  # noqa: E402
from portbench.harness import spec  # noqa: E402


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    started = harness.process_start()
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    r = harness.Run(cell, args.seed, args.seconds, bool(args.trace), device, started=started)
    result = harness.run_cell(r)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the process loaded {loaded}", file=sys.stderr)
        return 3
    for k, v in r.notes.items():
        if k in ("launches_per_step", "launches_per_request", "plain_routes", "setup_phases",
                 "window_calls_ms", "window_halves_ms"):
            print(f"portbench: {k} {json.dumps(v)}", file=sys.stderr)
    print(f"portbench: card {power_limit()}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"portbench: check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
