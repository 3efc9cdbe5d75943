"""The span metrics (`harness/spans.py` and the readers that call it) on
fake runs whose records are known, the idle account on known intervals,
and the traced pass on the CPU at a test's size."""

from __future__ import annotations

import types

import pytest
import torch

from portbench.harness import run as harness
from portbench.harness import spans, spec
from portbench.tests.conftest import SERVE, SEED, TRAIN

MS = 1_000_000  # ns


def reader(name):
    return spec.load_module(spec.BENCH_DIR / "metrics" / f"{name}.py", f"t_{name}")


TRAIN_READERS = ("train_input_step_ms", "train_model_step_ms", "train_optimizer_step_ms")
SERVE_READERS = ("serve_enqueue_ms.fused", "serve_enqueue_ms.xla",
                 "k5_table_builds_per_fused_request", "device_idle_in_program_pct.serve")


def fake_run(kind, records=(), ran=True, **obs):
    o = {"spans.ran": 1.0 if ran else 0.0, **obs}
    return types.SimpleNamespace(obs=o, notes={"spans.records": list(records)},
                                 cell=types.SimpleNamespace(traffic={"kind": kind}))


def rec(i, name, parent=None, start=0, end=1, device_ms=None, **attrs):
    return {"name": name, "id": i, "parent": parent, "attrs": attrs, "start_ns": start * MS,
            "end_ns": end * MS, "device_ms": device_ms}


def train_records(steps):
    """`train.call` > a `train.step` per row of (input, forward, backward,
    optimizer) device ms; the draw takes 0.5 ms."""
    out, i = [rec(1, "train.call", None, 0, 100 * len(steps))], 2
    for k, (inp, fwd, bwd, opt) in enumerate(steps):
        step = i
        parts = (("train.draw", 0.5), ("train.input", inp), ("train.forward", fwd),
                 ("train.backward", bwd), ("train.optimizer", opt))
        out.append(rec(step, "train.step", 1, 100 * k, 100 * k + 90,
                       device_ms=sum(ms for _, ms in parts), step=k))
        for j, (name, ms) in enumerate(parts):
            out.append(rec(step + 1 + j, name, step, 100 * k + j, 100 * k + j + 1, device_ms=ms))
        i += 1 + len(parts)
    return out


def test_training_readers_take_the_median_over_steps():
    run = fake_run("train", train_records([(10, 7, 9, 3), (12, 8, 10, 4), (11, 6, 8, 2),
                                           (30, 20, 20, 9)]))
    assert reader("train_input_step_ms").read(run) == pytest.approx(11.5)
    assert reader("train_model_step_ms").read(run) == pytest.approx(17.0)  # 16, 18, 14, 40
    assert reader("train_optimizer_step_ms").read(run) == pytest.approx(3.5)
    s = spans.summary(run)
    assert s["phases_over_step_median"] == pytest.approx(1.0)
    assert s["spans"]["train.step"]["count"] == 4
    assert s["spans"]["train.step"]["self_host_ms"] == pytest.approx(4 * 85.0)
    assert s["spans"]["train.input"]["device_ms"] == pytest.approx(63.0)


def test_training_readers_skip_steps_without_device_times():
    recs = train_records([(10, 7, 9, 3)])
    for r in recs:
        r["device_ms"] = None
    run = fake_run("train", recs)
    assert all(reader(n).read(run) is None for n in TRAIN_READERS)


def serve_records():
    """Four requests: two fused (1 and 3 ms on the host, the first with a
    `k5.plan` inside), two xla (2 and 4 ms)."""
    return [rec(1, "serve.request", None, 0, 1, batch=4, route="fused"),
            rec(2, "k5.plan", 1, 0, 1, batch=4),
            rec(3, "serve.request", None, 2, 4, batch=40, route="xla"),
            rec(4, "serve.request", None, 5, 8, batch=7, route="fused"),
            rec(5, "serve.request", None, 9, 13, batch=90, route="xla")]


def test_serving_readers():
    run = fake_run("serve", serve_records(), **{"spans.k5_tables": 1, "spans.idle_s": 0.004,
                                                "spans.idle_in_request_s": 0.001})
    assert reader("serve_enqueue_ms.fused").read(run) == pytest.approx(2.0)
    assert reader("serve_enqueue_ms.xla").read(run) == pytest.approx(3.0)
    assert reader("k5_table_builds_per_fused_request").read(run) == pytest.approx(0.5)
    assert reader("device_idle_in_program_pct.serve").read(run) == pytest.approx(25.0)


@pytest.mark.parametrize("ran", [False, True])
@pytest.mark.parametrize("name", TRAIN_READERS + SERVE_READERS)
def test_every_reader_gives_none_where_nothing_was_recorded(name, ran):
    kind = "train" if name in TRAIN_READERS else "serve"
    assert reader(name).read(fake_run(kind, ran=ran)) is None


def test_a_program_without_the_tracer_gives_no_pass(monkeypatch):
    monkeypatch.setattr(spans, "_tracer", lambda: None)
    run = types.SimpleNamespace(obs={}, notes={},
                                cell=types.SimpleNamespace(traffic={"kind": "serve"}))
    assert spans.observe(run) is False
    assert all(reader(n).read(run) is None for n in TRAIN_READERS + SERVE_READERS)
    assert run.obs == {"spans.ran": 0.0} and run.notes == {}


def test_idle_goes_to_the_innermost_open_span():
    """Window 0-20 ms; the device busy 2-4 and 9-15; a request 1-8 with a
    plan 5-6 inside, another 10-18."""
    recs = [rec(1, "serve.request", None, 1, 8), rec(2, "k5.plan", 1, 5, 6),
            rec(3, "serve.request", None, 10, 18)]
    busy = [(2 * MS, 4 * MS), (9 * MS, 12 * MS), (11 * MS, 15 * MS)]
    idle = spans.idle_by_span(busy, recs, 0, 20 * MS)
    # free: 0-2, 4-9, 15-20; 0-1 outside, 1-2 request, 4-5 request, 5-6 plan,
    # 6-8 request, 8-9 outside, 15-18 request, 18-20 outside
    assert idle == pytest.approx({"outside": 0.004, "serve.request": 0.007, "k5.plan": 0.001})
    assert spans.idle_inside(busy, recs, 0, 20 * MS, "serve.request") == pytest.approx(0.008)
    assert spans.idle_by_span([], [], 0, 3 * MS) == pytest.approx({"outside": 0.003})


@pytest.mark.parametrize("name", [TRAIN, SERVE])
def test_the_pass_runs_the_cells_own_traffic_on_the_cpu(small_cell, name, capsys):
    cell = small_cell(name)
    r = harness.Run(cell, SEED, 1.0, True, torch.device("cpu"))
    out = harness.run_cell(r)
    assert out["correct"] is True and r.obs["spans.ran"] == 1.0
    recs = r.notes["spans.records"]
    if name == TRAIN:
        n = spans.TRAIN_CALLS * cell.traffic["steps_per_call"]
        assert sum(x["name"] == "train.step" for x in recs) == n
        assert sum(x["name"] == "train.call" for x in recs) == spans.TRAIN_CALLS
    else:
        n = cell.traffic["trace_requests"] // 2
        reqs = spans.requests(r)
        assert len(reqs) == n and all(x["attrs"]["route"] == "xla" for x in reqs)
        assert len(r.driver.done) >= n
    assert "portbench: spans {" in capsys.readouterr().err
