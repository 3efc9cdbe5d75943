"""The batch norms' frozen bytes and readers (`harness/batchnorm.py`,
`metrics/train_bn_ms.py`, `metrics/bn_roofline_pct.py`) on the CPU, the
traced pass's `model.batch_norm` spans, and a short traced run of
`dscnnl_train_b4096` on the card."""

from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest
import torch

from portbench.harness import batchnorm, spec
from portbench.harness import run as harness
from portbench.tests.conftest import ROOT, SEED

CELL = "dscnnl_train_b4096"
MS = 1_000_000  # ns


def _config(name="DSCNNL") -> dict:
    return json.loads((spec.BENCH_DIR / "configs" / f"{name}.json").read_text())


def test_the_frozen_bytes():
    """DS-CNN L at 4096: 11 batch norms, conv_1's over [276, 25, 10], the ten
    others over [276, 13, 5]; TCResNet8-1.0 at 8192: ten, 9,368 floats a
    clip; five float32 passes each."""
    assert batchnorm.work_bytes(_config(), 4096) == 20_348_928_000
    assert batchnorm.work_bytes(_config(), 4096) == 5 * 4 * 4096 * (276 * 25 * 10
                                                                   + 10 * 276 * 13 * 5)
    assert batchnorm.work_bytes(_config("TCResNet8-1.0"), 8192) == 5 * 4 * 8192 * 9_368


def _rec(i, name, parent, start, end, device_ms, **attrs):
    return {"name": name, "id": i, "parent": parent, "attrs": attrs, "start_ns": start * MS,
            "end_ns": end * MS, "device_ms": device_ms}


def _fake_run(records):
    return types.SimpleNamespace(
        obs={"spans.ran": 1.0}, notes={"spans.records": records}, card="NVIDIA H100 80GB HBM3",
        cell=types.SimpleNamespace(traffic={"kind": "train"}, config=_config()))


def _reader(name):
    return spec.load_module(spec.BENCH_DIR / "metrics" / f"{name}.py", f"t_{name}")


def test_the_readers_place_parentless_backward_spans_by_host_time():
    """Three steps 0-100, 100-200, 200-300 ms: forward spans under each
    step's `train.forward`, backward spans with no parent inside its host
    interval (autograd's thread on a card); the third step has none."""
    recs, i = [], 1
    for k, (fwd, bwd) in enumerate([(4.0, 6.0), (5.0, 9.0), (None, None)]):
        base = 100 * k
        recs.append(_rec(i, "train.step", None, base, base + 90, 50.0))
        recs.append(_rec(i + 1, "train.forward", i, base + 10, base + 20, 10.0))
        if fwd is not None:
            recs.append(_rec(i + 2, "model.batch_norm", i + 1, base + 11, base + 12, fwd,
                             phase="forward", channels=276))
            recs.append(_rec(i + 3, "model.batch_norm", None, base + 40, base + 41, bwd,
                             phase="backward", channels=276))
        i += 4
    run = _fake_run(recs)
    assert _reader("train_bn_ms").read(run) == pytest.approx(12.0)  # 10.0 and 14.0
    least = 20_348_928_000 / 3.35e12
    assert _reader("bn_roofline_pct").read(run) == pytest.approx(100 * least / 12e-3)


@pytest.mark.parametrize("name", ["train_bn_ms", "bn_roofline_pct"])
def test_the_readers_give_none_without_batch_norm_spans(name):
    """A program without the spans (the parent of the change that added
    them) records steps, depthwise spans and nothing else."""
    run = _fake_run([_rec(1, "train.step", None, 0, 90, 50.0),
                     _rec(2, "model.depthwise", None, 40, 41, 3.0, phase="backward")])
    assert _reader(name).read(run) is None


def test_the_traced_pass_records_the_batch_norm_spans_on_the_cpu(small_cell):
    """Each step of the cell's traced pass records a forward and a backward
    span for each of DS-CNN L's 11 batch norms (device times only on a
    card, so the readers give None here)."""
    from portbench.harness import spans

    cell = small_cell(CELL)
    r = harness.Run(cell, SEED, 1.0, True, torch.device("cpu"))
    assert harness.run_cell(r)["correct"] is True
    recs = r.notes["spans.records"]
    steps = spans.TRAIN_CALLS * cell.traffic["steps_per_call"]
    bn = [x for x in recs if x["name"] == "model.batch_norm"]
    assert sum(x["name"] == "train.step" for x in recs) == steps
    assert len(bn) == steps * 2 * 11
    assert {x["attrs"]["phase"] for x in bn} == {"forward", "backward"}
    assert {x["attrs"]["channels"] for x in bn} == {276}
    assert _reader("train_bn_ms").read(r) is None


@pytest.mark.cuda
def test_a_short_traced_run_reads_both_metrics_on_the_card(cuda_device):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
                        str(SEED), "--seconds", "2", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"]
    metrics = out["metrics"]
    assert metrics["train_bn_ms"]["value"] > 0
    assert 0 < metrics["bn_roofline_pct"]["value"] <= 100
