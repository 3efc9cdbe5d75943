"""Everything a run needs, found by name from BENCHMARK.json.

- a cell (`workloads` entry) names its configuration and traffic mix;
- the configuration's `file` holds the model and recipe as run;
- the traffic mix is `traffic/<traffic>.json`, whose `kind` names the
  general generator that reads it, `traffic/<kind>.py`;
- each per-layer metric is `metrics/<name>.py`, a module with `read(ctx)`.

There is no list of them anywhere else: adding a file and an entry adds one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str) -> ModuleType:
    """A module from a file whose name need not be an identifier."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    kind: ModuleType  # the generator named by the traffic's `kind`
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    readers: Dict[str, ModuleType] = field(default_factory=dict)


def _applies(metric: dict, cell: str) -> bool:
    """An end-to-end metric without `workloads` is every cell's; a
    per-layer metric always lists its cells."""
    return cell in metric["workloads"] if "workloads" in metric else True


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json",
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of `bench_file`, its files read from `bench_dir`'s
    parent (the checkout's root)."""
    bench = json.loads(bench_file.read_text())
    root = bench_dir.parent
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_file}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    kind = load_module(bench_dir / "traffic" / f"{traffic['kind']}.py",
                       f"portbench_kind_{traffic['kind']}")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    readers = {m["name"]: load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                      f"portbench_metric_{m['name'].replace('.', '_')}")
               for m in per_layer}
    return Cell(name, int(w["chips"]), config, traffic, kind, e2e, per_layer, readers)
