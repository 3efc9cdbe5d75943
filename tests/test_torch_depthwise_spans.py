"""The DS-CNN's depthwise spans (`model.depthwise`, `models/ds_cnn.py`;
the backward one through `utils/profiling.py::backward_span`) in a
Trainer's step on the CPU, at a small geometry: with the tracer off a step
runs no hook; with it on, each step records a forward
and a backward span per depthwise conv, inside the step; the state is
bit-equal either way; no other family records one. On a card (`cuda`
marker; skipped without one) the backward span opens and closes on the
node of the depthwise conv's Function (`ops/kernels/dwconv.py`)."""

import sys

import pytest
import torch

from tcresnet_tpu_torch.config import (AudioConfig, AugmentConfig, ExperimentConfig,
                                       ModelConfig, OptimConfig, TrainConfig)
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset
from tcresnet_tpu_torch.models import ds_cnn
from tcresnet_tpu_torch.train.trainer import Trainer
from tcresnet_tpu_torch.utils import profiling
from tcresnet_tpu_torch.utils.profiling import drain, tracing

torch.set_num_threads(1)

DW_LAYERS = [f"{b.name}_dw" for b in ds_cnn.L_NET_DEF if b.type == "separable"]


def _cfg(tmp_path, name="DSCNNL"):
    """The preset's MFCC-10 at 40/20 ms and Adam, on 160 ms clips (7 frames)."""
    return ExperimentConfig(
        audio=AudioConfig(clip_duration_ms=160, window_size_ms=40.0, window_stride_ms=20.0,
                          num_mfccs=10),
        augment=AugmentConfig(background_frequency=0.5, background_max_volume=0.1),
        model=ModelConfig(name=name, num_classes=4, weight_decay=0.0),
        optim=OptimConfig(optimizer="adam", lr_list=(5e-4,), boundaries=()),
        train=TrainConfig(batch_size=4, max_step=4, train_dir=str(tmp_path)),
    )


@pytest.fixture(scope="module")
def dataset():
    return DeviceDataset(make_synthetic_dataset(num_samples=16, num_classes=4,
                                                desired_samples=2560, seed=5), "cpu")


class _HookCalls:
    """The calls of the span hooks `backward_span` registers (Python
    functions of profiling.py named `pre` and `post`), seen by a profile
    function on this thread: on the CPU, autograd runs every node on the
    thread that asks for the gradients."""

    def __init__(self):
        self.calls = []

    def __call__(self, frame, event, arg):
        code = frame.f_code
        if event == "call" and code.co_filename == profiling.__file__ \
                and code.co_name in ("pre", "post"):
            self.calls.append(code.co_name)

    def __enter__(self):
        sys.setprofile(self)
        return self

    def __exit__(self, *exc):
        sys.setprofile(None)
        return False


def _state(trainer):
    s = trainer.state
    out = {f"params/{k}": v for k, v in s.params.items()}
    out.update({f"stats/{k}": v for k, v in s.batch_stats.items()})
    out.update({f"opt/{k}": v for k, v in s.opt_state.items() if torch.is_tensor(v)})
    return {k: v.detach().clone() for k, v in out.items()}


def test_with_the_tracer_off_a_step_runs_no_hook(tmp_path, dataset):
    trainer = Trainer(_cfg(tmp_path), dataset, steps_per_call=1)
    with _HookCalls() as off:
        trainer.train_steps(1, start=0)
    assert off.calls == []
    with tracing(), _HookCalls() as on:  # the same detector sees the hooks when they exist
        trainer.train_steps(1, start=1)
        drain()
    assert on.calls == ["pre", "post"] * len(DW_LAYERS)


@pytest.mark.cuda
def test_each_backward_span_opens_and_closes_on_the_depthwise_functions_node(tmp_path,
                                                                           monkeypatch):
    """On a card `backward_span` hooks each depthwise conv's output on the
    node of `ops/kernels/dwconv.py`'s Function, one per conv and step, and
    records one backward span there; that node hands back dx of the
    conv's own input (no padded copy), dW [C, 1, 3, 3] and db [C]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the depthwise conv kernels have no CPU mode")
    from tcresnet_tpu_torch.ops.kernels import dwconv

    dev = torch.device("cuda", 0)
    dataset = DeviceDataset(make_synthetic_dataset(num_samples=16, num_classes=4,
                                                   desired_samples=2560, seed=5), dev)
    nodes, grads = [], []
    real = ds_cnn.backward_span

    def spy(t, name, **attrs):
        nodes.append((attrs["layer"], t.grad_fn))
        t.grad_fn.register_hook(lambda grad_inputs, grad_outputs: grads.append(tuple(
            None if g is None else tuple(g.shape) for g in grad_inputs)))
        return real(t, name, **attrs)

    monkeypatch.setattr(ds_cnn, "backward_span", spy)
    trainer = Trainer(_cfg(tmp_path), dataset, steps_per_call=2)
    with tracing():
        trainer.train_steps(2, start=0)
        torch.cuda.synchronize()
        records = drain()
    assert [layer for layer, _ in nodes] == DW_LAYERS * 2
    assert all(node._forward_cls is dwconv.DepthwiseConv3x3 for _, node in nodes)
    # 7 frames x 10 MFCCs are 4 x 10 after conv_1 (stride 2 x 1), then 2 x 5
    # after conv_ds_1; autograd runs the last conv's node first
    c = ds_cnn.L_NET_DEF[0].depth
    step = [(4, c, 2, 5)] * (len(DW_LAYERS) - 1) + [(4, c, 4, 10)]
    assert grads == [(x, (c, 1, 3, 3), (c,)) for x in step * 2]
    assert sum(r["name"] == "model.depthwise" and r["attrs"]["phase"] == "backward"
               for r in records) == len(nodes)


def test_each_step_records_five_forward_and_five_backward_depthwise_spans(tmp_path, dataset):
    trainer = Trainer(_cfg(tmp_path), dataset, steps_per_call=2)
    with tracing():
        trainer.train_steps(2, start=0)
        records = drain()
    assert profiling.dropped() == 0
    steps = [r for r in records if r["name"] == "train.step"]
    dw = [r for r in records if r["name"] == "model.depthwise"]
    assert len(steps) == 2 and len(dw) == 2 * 2 * len(DW_LAYERS)
    by_id = {r["id"]: r for r in records}
    for step in steps:
        inside = sorted((r for r in dw if step["start_ns"] <= r["start_ns"]
                         and r["end_ns"] <= step["end_ns"]), key=lambda r: r["start_ns"])
        fwd = [r for r in inside if r["attrs"]["phase"] == "forward"]
        bwd = [r for r in inside if r["attrs"]["phase"] == "backward"]
        assert [r["attrs"]["layer"] for r in fwd] == DW_LAYERS
        assert [r["attrs"]["layer"] for r in bwd] == DW_LAYERS[::-1]  # autograd's order
        assert all(by_id[r["parent"]]["name"] == "train.forward" for r in fwd)
        # on the CPU the backward runs on the caller's thread, inside `train.backward`;
        # on a card it runs on autograd's device thread, with no parent
        assert all(by_id[r["parent"]]["name"] == "train.backward" for r in bwd)
        assert all(r["start_ns"] <= r["end_ns"] for r in inside)
        assert all(r["device_ms"] is None for r in inside)  # no CUDA events on the CPU
    assert len({r["id"] for r in dw}) == len(dw)


def test_the_state_is_bit_equal_with_the_depthwise_spans_on_and_off(tmp_path, dataset):
    off = Trainer(_cfg(tmp_path / "off"), dataset, steps_per_call=2)
    on = Trainer(_cfg(tmp_path / "on"), dataset, steps_per_call=2)
    want = off.train_steps(2, start=0)
    with tracing():
        got = on.train_steps(2, start=0)
        drain()
    a, b = _state(off), _state(on)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(want["total_loss"], got["total_loss"])


def test_a_backward_span_without_a_graph_registers_nothing():
    x = torch.ones(3)
    with tracing():
        assert profiling.backward_span(x, "model.depthwise") is x
        with torch.no_grad():
            y = torch.ones(3, requires_grad=True) * 2
        assert profiling.backward_span(y, "model.depthwise") is y
        assert drain() == []


@pytest.mark.parametrize("name", ["TCResNet8", "Res8Narrow", "ResNet2D8"])
def test_no_other_family_records_a_depthwise_span(tmp_path, dataset, name):
    cfg = _cfg(tmp_path, name)
    if name == "TCResNet8":  # MFCC as channels, 30/10 ms: 14 frames
        cfg = cfg.replace(audio=AudioConfig(clip_duration_ms=160, num_mfccs=10))
    trainer = Trainer(cfg, dataset, steps_per_call=1)
    with tracing():
        trainer.train_steps(1, start=0)
        records = drain()
    assert sum(r["name"] == "train.step" for r in records) == 1
    assert not [r for r in records if r["name"] == "model.depthwise"]
