"""The port's tracer (`tcresnet_tpu_torch/utils/profiling.py`: `span`,
`tracing`, `drain`, the spans' clock) and the spans and counters the
program records: the training step's phases, the served request's route
and K5's op-table builds (CPU, small geometry)."""

import json

import numpy as np
import pytest
import torch

from tcresnet_tpu_torch.config import (AudioConfig, AugmentConfig, ExperimentConfig,
                                       ModelConfig, OptimConfig, TrainConfig, get_preset)
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset
from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
from tcresnet_tpu_torch.models.layers import SlimBatchNorm
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.ops.kernels import infer2d as k5
from tcresnet_tpu_torch.ops.kernels import launch_counts, launches_since
from tcresnet_tpu_torch.serve.export import build_inference_fn
from tcresnet_tpu_torch.train.trainer import Trainer
from tcresnet_tpu_torch.utils import profiling
from tcresnet_tpu_torch.utils.profiling import drain, span, tracing

torch.set_num_threads(1)

PHASES = ["train.draw", "train.input", "train.forward", "train.backward", "train.optimizer"]
# the input path's route per config: the augmentation's and front end's
# backends, and K3's fusion
ROUTES = {
    "plain": dict(augment="xla", frontend_fuse="off"),
    "kernels": dict(augment="pallas", frontend_fuse="off"),
    "k3": dict(augment="pallas", frontend_fuse="on"),
}
# the enclosure a span's record keeps around the operators run inside it,
# on the profiler's clock
CLOCK_SLACK_NS = 50_000


def _cfg(tmp_path, route="kernels"):
    r = ROUTES[route]
    return ExperimentConfig(
        audio=AudioConfig(clip_duration_ms=160, num_mfccs=20, num_mel_bins=32,
                          frontend_fuse=r["frontend_fuse"]),
        augment=AugmentConfig(background_frequency=0.5, background_max_volume=0.1,
                              backend=r["augment"]),
        model=ModelConfig(name="TCResNet8", num_classes=4),
        optim=OptimConfig(optimizer="mom", lr_list=(0.1, 0.05), boundaries=(3,), use_ema=True),
        train=TrainConfig(batch_size=8, max_step=4, train_dir=str(tmp_path)),
    )


@pytest.fixture(scope="module")
def dataset():
    return DeviceDataset(make_synthetic_dataset(num_samples=32, num_classes=4,
                                                desired_samples=2560, seed=3), "cpu")


def _children(records, parent):
    return sorted((r for r in records if r["parent"] == parent["id"]),
                  key=lambda r: r["start_ns"])


def _state(trainer):
    s = trainer.state
    out = {f"params/{k}": v for k, v in s.params.items()}
    out.update({f"stats/{k}": v for k, v in s.batch_stats.items()})
    out.update({f"ema/{k}": v for k, v in s.ema_params.items()})
    out.update({f"opt/{k}": v for k, v in s.opt_state.items() if torch.is_tensor(v)})
    out["step"] = s.step
    return {k: v.detach().clone() for k, v in out.items()}


def test_off_span_is_the_shared_no_op_and_reads_nothing():
    """With the tracer off a span reads no clock, opens no record_function,
    makes no CUDA event and records nothing."""
    def refuse(*args, **kwargs):
        raise AssertionError("a span of a tracer that is off did work")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling.time, "perf_counter_ns", refuse)
        mp.setattr(profiling.time, "time_ns", refuse)
        mp.setattr(torch.profiler, "record_function", refuse)
        mp.setattr(torch.cuda, "Event", refuse)
        first, second = span("a", batch=1), span("b")
        with first as entered:
            with second:
                pass
    assert first is second is entered is profiling._OFF
    with tracing():
        assert drain() == []


def _batch_norms(trainer) -> list:
    return [m for m in trainer.model.modules() if isinstance(m, SlimBatchNorm)]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_two_steps_make_the_span_tree(tmp_path, dataset, route):
    """`train.call` > 2 x `train.step` > the five phases in order, each
    record's parent the enclosing span, host times nested, `step`, `start`,
    `n_steps` and the input path's `route` set; each batch norm's
    `model.batch_norm` span inside `train.forward` and, on the CPU (autograd
    runs the backward on this thread), inside `train.backward`."""
    trainer = Trainer(_cfg(tmp_path, route), dataset, steps_per_call=2)
    channels = [m.running_mean.shape[0] for m in _batch_norms(trainer)]
    with tracing():
        trainer.train_steps(2, start=0)
        records = drain()
    assert profiling.dropped() == 0
    calls = [r for r in records if r["name"] == "train.call"]
    assert len(calls) == 1 and calls[0]["parent"] is None
    assert calls[0]["attrs"] == {"start": 0, "n_steps": 2}
    steps = _children(records, calls[0])
    assert [(r["name"], r["attrs"]) for r in steps] == [("train.step", {"step": 0}),
                                                        ("train.step", {"step": 1})]
    assert len(records) == 1 + 2 * (1 + len(PHASES) + 2 * len(channels))
    for step in steps:
        phases = _children(records, step)
        assert [r["name"] for r in phases] == PHASES
        for phase, direction, order in ((phases[2], "forward", channels),
                                        (phases[3], "backward", channels[::-1])):
            bn = _children(records, phase)
            assert [(r["name"], r["attrs"]) for r in bn] == [
                ("model.batch_norm", {"phase": direction, "channels": c}) for c in order]
        assert phases[1]["attrs"] == {"route": route}
        assert all(r["attrs"] == {} for i, r in enumerate(phases) if i != 1)
        assert calls[0]["start_ns"] <= step["start_ns"] <= phases[0]["start_ns"]
        for a, b in zip(phases, phases[1:]):
            assert a["start_ns"] < a["end_ns"] <= b["start_ns"]
        assert phases[-1]["end_ns"] <= step["end_ns"] <= calls[0]["end_ns"]
        assert all(r["device_ms"] is None for r in phases)  # no CUDA events on the CPU
    assert len({r["id"] for r in records}) == len(records)


def test_state_after_two_steps_is_bit_equal_with_tracing_on_and_off(tmp_path, dataset):
    off = Trainer(_cfg(tmp_path / "off"), dataset, steps_per_call=2)
    on = Trainer(_cfg(tmp_path / "on"), dataset, steps_per_call=2)
    want = off.train_steps(2, start=0)
    with tracing():
        got = on.train_steps(2, start=0)
        assert len(drain()) == 1 + 2 * (1 + len(PHASES) + 2 * len(_batch_norms(on)))
    a, b = _state(off), _state(on)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k in want:
        assert torch.equal(torch.as_tensor(want[k]), torch.as_tensor(got[k])), k


def _serve_cfg():
    return ExperimentConfig(
        audio=AudioConfig(clip_duration_ms=160, num_mfccs=20, num_mel_bins=32),
        model=ModelConfig(name="TCResNet8", num_classes=12), train=TrainConfig())


@pytest.mark.parametrize("backend,route", [("xla", "xla"), ("fused", "fused"),
                                           ("auto", "xla")])
def test_a_served_request_records_its_route_and_batch(backend, route):
    """Every backend's callable is a `serve.request` span; "auto" records
    the route it took (on a CPU tensor the `xla` route)."""
    cfg = _serve_cfg()
    v = variables_from_jax(cfg.model, **seeded_variables(cfg.model, dsp.feature_shape(cfg.audio),
                                                         0))
    fn = build_inference_fn(cfg, v, backend=backend, device="cpu")
    wavs = torch.tensor(np.random.default_rng(1).uniform(
        -1, 1, (3, cfg.audio.desired_samples)).astype(np.float32))
    want = fn(wavs)
    with tracing():
        got = fn(wavs)
        fn(wavs[:1])
        records = drain()
    assert torch.equal(want, got)
    assert [(r["name"], r["parent"], r["attrs"]) for r in records] == [
        ("serve.request", None, {"batch": 3, "route": route}),
        ("serve.request", None, {"batch": 1, "route": route})]


def test_k5_counts_each_table_it_builds():
    """17 distinct batch sizes, then the first again: the first table was
    dropped (MAX_TABLES = 16), so 18 builds, each a `k5.plan` span."""
    assert k5.MAX_TABLES == 16
    cfg = get_preset("DSCNNS")
    v = variables_from_jax(cfg.model, **seeded_variables(cfg.model, dsp.feature_shape(cfg.audio),
                                                         0))
    plan = k5.build_fused_infer2d(cfg.model, cfg.audio, v["params"], v["batch_stats"],
                                  device="cpu")
    sizes = list(range(1, 18)) + [1]
    before = launch_counts()
    with tracing():
        for b in sizes:
            plan.op_table(b)
            plan.partial_floats(b)  # a kept table: no build
        records = drain()
    assert launches_since(before) == {"k5_tables": 18}
    assert [(r["name"], r["attrs"]) for r in records] == [("k5.plan", {"batch": b})
                                                         for b in sizes]


def test_the_buffer_stops_at_its_cap_and_counts_the_drops(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 4)
    with tracing():
        for i in range(10):
            with span("s", i=i):
                pass
        assert profiling.dropped() == 6
        assert [r["attrs"]["i"] for r in drain()] == [6, 7, 8, 9]
        assert drain() == []
        with span("after"):
            pass
        assert [r["name"] for r in drain()] == ["after"]
        assert profiling.dropped() == 6
    with tracing():
        assert profiling.dropped() == 0


def test_nested_spans_and_tracing_blocks():
    """A span's parent is the span open around it; an inner `tracing` block
    keeps the outer's records and restores its setting."""
    with tracing(device_events=True):
        with span("outer"):
            with tracing(device_events=False):
                assert not profiling._TRACER.device_events
                with span("inner"):
                    pass
            assert profiling._TRACER.device_events
        inner, outer = drain()
    assert not profiling._TRACER.on
    assert (inner["name"], outer["name"]) == ("inner", "outer")
    assert inner["parent"] == outer["id"] and outer["parent"] is None
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= outer["end_ns"]
    with span("off"):
        pass
    with tracing():
        assert drain() == []


def test_the_spans_clock_is_unix_time():
    with tracing():
        a = profiling.clock_ns()
        unix = __import__("time").time_ns()
        b = profiling.clock_ns()
    assert a <= b and abs(unix - (a + b) // 2) < 5_000_000


def test_profile_dir_trace_carries_the_spans_on_the_profilers_clock(tmp_path, dataset):
    """Under `trace(log_dir)` the Chrome trace holds the program's spans,
    and a span's record, put on the profiler's clock, encloses the aten
    operators run inside it to within 50 us."""
    trainer = Trainer(_cfg(tmp_path / "run"), dataset, steps_per_call=1)
    a = torch.randn(128, 128)
    with profiling.trace(str(tmp_path / "prof")) as prof:
        trainer.train_steps(1, start=0)
        with span("test.outer"):
            for _ in range(3):
                with span("test.inner"):
                    torch.mm(a, a)
                torch.add(a, 1.0)
        records = drain()
    assert not profiling._TRACER.on
    names = {e["name"] for e in json.loads(next((tmp_path / "prof").glob("trace_*.json"))
                                           .read_text())["traceEvents"]}
    assert {"train.call", "train.step", *PHASES, "test.outer", "test.inner"} <= names
    origin = profiling.trace_start_ns(prof)
    events = list(prof.events())

    def ops(name):  # the last three: those the block runs after the step
        return sorted((origin + round(1e3 * e.time_range.start),
                       origin + round(1e3 * e.time_range.end))
                      for e in events if e.name == name)[-3:]

    inner = [r for r in records if r["name"] == "test.inner"]
    outer = next(r for r in records if r["name"] == "test.outer")
    mms, adds = ops("aten::mm"), ops("aten::add")
    assert len(inner) == 3
    for rec, (s, e) in zip(inner, mms):
        assert rec["start_ns"] <= s + CLOCK_SLACK_NS and rec["end_ns"] >= e - CLOCK_SLACK_NS
    for s, e in adds:  # outside every inner span, inside the outer
        assert outer["start_ns"] <= s + CLOCK_SLACK_NS and outer["end_ns"] >= e - CLOCK_SLACK_NS
        assert not any(r["start_ns"] <= s and e <= r["end_ns"] for r in inner)
    assert outer["start_ns"] <= inner[0]["start_ns"] and inner[-1]["end_ns"] <= outer["end_ns"]
