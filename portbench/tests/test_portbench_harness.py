"""The harness: found by name, driven by the seed, its result line, its
refusals, and what it imports."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.harness import run as harness
from portbench.harness import spec, synth
from portbench.tests.conftest import ROOT, SEED, SERVE, TRAIN

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] \
        + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (spec.BENCH_DIR / "cells" / f"{w['name']}.json").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and (spec.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        assert m["workloads"] and set(m["workloads"]) <= cells
    for w in b["workloads"]:  # every cell reports setup_s, another e2e and a per-layer metric
        cell = spec.load_cell(w["name"])
        assert {"setup_s"} < {m["name"] for m in cell.end_to_end} and cell.per_layer


def test_cells_metrics_and_mixes_are_found_by_name(tmp_path):
    """A cell, a configuration, a traffic mix and a per-layer metric added
    as files and entries, with no list to edit anywhere else."""
    bench_dir = tmp_path / "portbench"
    for sub in ("traffic", "metrics", "configs", "cells"):
        (bench_dir / sub).mkdir(parents=True)
    shutil.copy(spec.BENCH_DIR / "traffic" / "serve.py", bench_dir / "traffic" / "serve.py")
    mix = json.loads((spec.BENCH_DIR / "traffic" / "serve_streams.json").read_text())
    mix["batch"] = {"min": 1, "max": 1, "grid": 4}
    (bench_dir / "traffic" / "serve_b1.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "requests_seen.py").write_text(
        "def read(run):\n    return run.obs.get('serve.requests')\n")
    (bench_dir / "configs" / "Res15.json").write_text(
        (spec.BENCH_DIR / "configs" / "Res15.json").read_text())
    b = bench()
    b["workloads"].append({"name": "res15_serve_b1", "config": "Res15", "traffic": "serve_b1",
                           "chips": 1, "why": "one clip a request"})
    b["configs"][1]["file"] = "portbench/configs/Res15.json"
    b["end_to_end"][1]["workloads"].append("res15_serve_b1")
    b["per_layer"].append({"name": "requests_seen", "unit": "1", "better": "higher",
                           "source": "program_counter", "layer": "serving entry",
                           "moves": "serve_utt_per_s", "workloads": ["res15_serve_b1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("res15_serve_b1", tmp_path / "BENCHMARK.json", bench_dir)
    assert cell.traffic["batch"]["max"] == 1 and cell.kind.__file__.startswith(str(tmp_path))
    assert [m["name"] for m in cell.per_layer] == ["requests_seen"]
    assert [m["name"] for m in cell.end_to_end] == ["serve_utt_per_s", "setup_s"]
    assert cell.readers["requests_seen"].read(type("R", (), {"obs": {"serve.requests": 3}})) == 3


def test_seed_fixes_sizes_offsets_data_and_weights():
    kind = spec.load_cell(SERVE).kind
    mix = {"min": 1, "max": 256, "grid": 1024}
    a, b, c = (kind.Schedule(mix, 4096, s) for s in (SEED, SEED, SEED + 1))
    first = [a[i] for i in range(3000)]
    assert first == [b[i] for i in range(3000)]
    assert first != [c[i] for i in range(3000)]
    grid = sorted(kind.batch_grid(mix).tolist())
    assert sorted(s for _, s in first[:1024]) == grid == sorted(c[i][1] for i in range(1024))
    assert min(grid) == 1 and max(grid) == 256 and 40 < np.mean(grid) < 52
    assert all(0 <= off <= 4096 - size for off, size in first)
    spec_ = {"clips": 16, "samples": 800, "sample_rate": 16000, "classes": 12,
             "noise_clips": 2, "noise_samples": 1600}
    d1, d2, d3 = (synth.tone_dataset(spec_, s, "cpu") for s in (SEED, SEED, SEED + 1))
    assert all(torch.equal(d1[k], d2[k]) for k in d1)
    assert not torch.equal(d1["wavs"], d3["wavs"])
    arch = json.loads((spec.BENCH_DIR / "configs" / "TCResNet8-1.0.json").read_text())
    w1, w2 = (synth.glorot_weights(arch["architecture"], 40, SEED, "cpu") for _ in range(2))
    assert all(torch.equal(w1[k], w2[k]) for k in w1)


@pytest.mark.parametrize("name", [TRAIN, SERVE])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(small_cell, name, trace):
    cell = small_cell(name)
    r = harness.Run(cell, SEED, 1.0, trace, torch.device("cpu"))
    out = harness.run_cell(r)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device"] \
        + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == set(harness.limits(name))
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(out, allow_nan=False)


def test_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", TRAIN, "--seed",
                        str(SEED), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout and "CUDA" in p.stderr


def test_run_outside_a_checkout_of_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", SERVE, "--seed",
                        str(SEED), "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and "{" not in p.stdout


_IMPORTS_EVERYTHING = """
import sys, torch
sys.path.insert(0, {root!r})
from portbench.harness import run as harness, spec
from portbench.tests.conftest import shrink
import portbench.calibrate
for name in {cells!r}:
    cell = shrink(spec.load_cell(name))
    for trace in (False, True):
        harness.run_cell(harness.Run(cell, 7, 0.2, trace, torch.device("cpu")))
print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "tcresnet_tpu"}}))
"""


def test_nothing_the_harness_imports_is_jax_or_the_jax_package():
    code = _IMPORTS_EVERYTHING.format(root=str(ROOT), cells=[TRAIN, SERVE])
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tcresnet_tpu_torch_fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tcresnet_tpu.fake", sys)
    assert harness.forbidden_modules() == ["tcresnet_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    root = spec.BENCH_DIR / "reference"
    files = sorted(root.rglob("*.py"))
    found = {f.relative_to(root).as_posix() for f in files}
    assert {"models.py", "train.py", "families/tcresnet.py", "families/res.py",
            "optimizers/mom.py", "optimizers/adam.py"} <= found, found
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"tcresnet_tpu_torch", "tcresnet_tpu", "jax", "jaxlib", "flax"}, f
        # nor by a name handed to importlib: the program's name appears nowhere
        assert "tcresnet_tpu" not in f.read_text(), f


def test_the_harness_reads_nothing_of_the_jax_era_files():
    banned = re.compile(r"(?<![\w/])bench\.py|BENCH_r0|BASELINE|MULTICHIP_|chip_smoke"
                        r"|(?<![\w/])tools/|(?<![\w/])csrc/")
    for f in spec.BENCH_DIR.rglob("*.py"):
        if "tests" in f.parts:
            continue
        assert not banned.search(f.read_text()), f
        assert not {m.split(".")[0] for m in _imports(f)} & {"jax", "tcresnet_tpu"}, f


@pytest.mark.cuda
@pytest.mark.parametrize("name", [TRAIN, SERVE])
def test_a_short_run_on_the_card(cuda_device, name):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed",
                        str(SEED), "--seconds", "2", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["busy_s"] > 0

