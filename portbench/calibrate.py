"""The readings that a cell's limits are set from, on the card:

    python portbench/calibrate.py --workload <name> --seeds <n> ... \\
        [--control-seeds <n> ...] [--seconds <s>] [--out <file>]

For every seed, one set-up of the program (as a run makes it), a window of
`--seconds` where the cell's kind serves requests, and the numbers that
decide `correct`; for every control seed also the control's numbers (the
plain reference in the next precision below the configuration's, in the
program's place) and those of the faults the cell can have. All seeds run
in one process. The lower reading of a number is its largest over the
program's seeds, the upper its smallest over the controls' (README.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench.harness import run as harness  # noqa: E402
from portbench.harness import spec  # noqa: E402


def readings(cell, seed: int, seconds: float, control: bool, device) -> dict:
    r = harness.Run(cell, seed, seconds, False, device)
    d = r.driver = cell.kind.Driver(r)
    t0 = time.time()
    d.setup()
    if seconds > 0:
        d.window(seconds)
    d.release()
    out = {"seed": seed, "program": d.check()}
    if control:
        out["control"] = d.control()
        out["faults"] = d.faults()
    if hasattr(d, "detail"):  # readings that are not compared
        out["detail"] = d.detail()
    out["seconds"] = time.time() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    rows = []
    for seed in args.seeds + [s for s in args.control_seeds if s not in args.seeds]:
        rows.append(readings(cell, seed, args.seconds, seed in args.control_seeds, device))
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "card": torch.cuda.get_device_name(device),
               "lower": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]}}
    controls = [r for r in rows if "control" in r]
    if controls:
        summary["upper_control"] = {k: min(r["control"][k] for r in controls)
                                    for k in controls[0]["control"]}
        for fault in controls[0]["faults"]:
            summary[f"upper_{fault}"] = {k: min(r["faults"][fault][k] for r in controls)
                                         for k in controls[0]["faults"][fault]}
    print(json.dumps(summary))
    if args.out:
        Path(args.out).write_text(json.dumps({"summary": summary, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
