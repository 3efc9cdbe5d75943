"""The DS-CNN reference (`reference/families/dscnn.py`) and the depthwise
count and readers (`harness/dwconv.py`, `metrics/train_dw_conv_ms.py`,
`metrics/dw_conv_roofline_pct.py`) against the port on the CPU: the
leaves, the logits, three Adam steps through the Trainer compared as the
cell compares them, the depthwise convolution against its sum of shifted
products, the frozen counts; and a short run of `dscnnl_train_b4096` on
the card."""

from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest
import torch

from portbench.harness import dwconv, flops, spec, synth
from portbench.harness import run as harness
from portbench.reference import frontend, models
from portbench.reference.families import dscnn
from portbench.tests.conftest import ROOT, SEED
from tcresnet_tpu_torch.models.ds_cnn import DSCNN, L_NET_DEF, Block

CELL = "dscnnl_train_b4096"
NARROW = (Block("conv", 12, (10, 4), (2, 1), "conv_1"),
          Block("separable", 12, (3, 3), (2, 2), "conv_ds_1"),
          Block("separable", 8, (3, 3), (1, 1), "conv_ds_2"))


def _config() -> dict:
    return json.loads((spec.BENCH_DIR / "configs" / "DSCNNL.json").read_text())


def _arch(net_def, classes=12) -> dict:
    return {"family": "DSCNN", "classes": classes,
            "blocks": [{"type": b.type, "depth": b.depth, "kernel": list(b.kernel),
                        "stride": list(b.stride), "name": b.name} for b in net_def]}


def test_the_configuration_holds_the_ports_layout():
    assert _config()["architecture"] == _arch(L_NET_DEF)


@pytest.mark.parametrize("net_def", [L_NET_DEF, NARROW], ids=["L", "narrow"])
def test_leaves_are_the_ports_state_dict(net_def):
    port = DSCNN(12, net_def).state_dict()
    leaves = models.leaves(_arch(net_def), 10)
    assert list(leaves) == list(port)
    assert {k: s for k, (s, _) in leaves.items()} == {k: tuple(v.shape) for k, v in port.items()}
    kinds = {k: kind for k, (_, kind) in leaves.items()}
    assert kinds["conv_ds_1_dw.weight"] == kinds["conv_ds_1_pw.weight"] == "conv"
    assert kinds["conv_1.bias"] == kinds["conv_1_bn.bias"] == kinds["fc1.bias"] == "shift"
    assert kinds["fc1.weight"] == "fc" and "conv_1_bn.weight" not in kinds
    assert models.dropout_shape(_arch(net_def), 4) is None


# The port's batch norm takes the variance as E[x^2] - E[x]^2 in float32 and
# the reference as the mean of squared deviations: on maps of about unit
# size over 6 clips they part by some float32 roundings of the logits'
# order (read 7.7e-7 in training, 1.2e-7 in eval); 1e-5 leaves them room.
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("net_def", [L_NET_DEF, NARROW], ids=["L", "narrow"])
def test_seeded_weights_give_the_ports_logits(net_def, training):
    arch = _arch(net_def)
    w = synth.glorot_weights(arch, 10, SEED, "cpu")
    gen = torch.Generator().manual_seed(1)
    for k, (shape, kind) in models.leaves(arch, 10).items():
        if kind in ("shift", "mean"):
            w[k] = 0.1 * torch.randn(shape, generator=gen)
        elif kind == "var":
            w[k] = 0.5 + torch.rand(shape, generator=gen)
    port = DSCNN(12, net_def)
    port.load_state_dict(w)
    port.train(training)
    feats = 3 * torch.randn(6, 49, 10, generator=gen)
    with torch.no_grad():
        want = port(feats[..., None])
        got = models.forward(w, feats, arch, training)
    torch.testing.assert_close(got, want, **LOGIT_TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_the_depthwise_conv_is_the_sum_of_its_shifted_products(stride):
    """F.conv2d with groups = channels under TF-SAME against the 9 taps
    summed by hand in float64: out[c, i, j] = sum over (a, b) of w[c, a, b]
    x[c, s i + a - lo_t, s j + b - lo_f], zero outside the map."""
    gen = torch.Generator().manual_seed(stride)
    x = torch.randn(2, 5, 13, 5, generator=gen, dtype=torch.float64)
    w = torch.randn(5, 1, 3, 3, generator=gen, dtype=torch.float64)
    b = torch.randn(5, generator=gen, dtype=torch.float64)
    got = dscnn._conv2d(x, w, b, (3, 3), (stride, stride), 5, torch.float64)
    t_lo, _ = models.same_pad(13, 3, stride)
    f_lo, _ = models.same_pad(5, 3, stride)
    rows, cols = -(-13 // stride), -(-5 // stride)
    want = b.view(1, -1, 1, 1).expand(2, 5, rows, cols).clone()
    for a in range(3):
        for c in range(3):
            for i in range(rows):
                for j in range(cols):
                    ti, fj = stride * i + a - t_lo, stride * j + c - f_lo
                    if 0 <= ti < 13 and 0 <= fj < 5:
                        want[:, :, i, j] += w[:, 0, a, c] * x[:, :, ti, fj]
    # the helper computes in the dtype given and returns float32: the two
    # float64 sums, in their own orders, round to the same float32 or to
    # one of its neighbours
    assert got.dtype == torch.float32 and got.shape == (2, 5, rows, cols)
    torch.testing.assert_close(got, want.float(), rtol=2 ** -23, atol=0)


def test_the_frozen_counts():
    cfg = _config()
    assert flops.model_step_flops(cfg, 1) == 161_946_864
    assert flops.model_step_flops(cfg, 4096) == 663_334_354_944
    assert flops.step_flops(cfg, 4096) == 940_350_832_640
    # the five depthwise convs at 4096: 2 x 276 channels x the taps that land,
    # forward, dx and dW; bytes as dwconv's docstring counts them
    assert dwconv.work(cfg, 4096) == (16_564_027_392, 9_858_035_520)


def test_the_depthwise_bytes_by_hand():
    """Forward: read x, W, b, write y; backward: read dy, x, write dx, dW,
    db; float32; the first block's conv from the 25 x 10 map (conv_1's
    stride 2 x 1) to 13 x 5, the other four 13 x 5 to 13 x 5."""
    c, b = 276, 4096
    first, rest = c * 25 * 10, c * 13 * 5
    weight = c * 9 + c
    per_clip = (first + rest) + (rest + 2 * first) + 4 * (2 * rest + 3 * rest)
    assert dwconv.work(_config(), b)[1] == 4 * (b * per_clip + 5 * 2 * weight)


def test_a_model_without_depthwise_convs_counts_nothing():
    cfg = json.loads((spec.BENCH_DIR / "configs" / "TCResNet8-1.0.json").read_text())
    assert dwconv.work(cfg, 8) == (0, 0)


MS = 1_000_000  # ns


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
    """Three steps 0-100, 100-200, 200-300 ms: each has forward spans under
    its `train.forward` and backward spans with no parent (autograd's
    thread) inside its host interval; the third has none."""
    recs, i = [], 1
    for k, (fwd, bwd) in enumerate([(1.0, 2.0), (1.5, 3.5), (None, None)]):
        base = 100 * k
        recs.append(_rec(i, "train.step", None, base, base + 90, 50.0))
        recs.append(_rec(i + 1, "train.forward", i, base + 10, base + 20, 10.0))
        if fwd is not None:
            recs.append(_rec(i + 2, "model.depthwise", i + 1, base + 11, base + 12, fwd,
                             layer="conv_ds_1_dw", phase="forward"))
            recs.append(_rec(i + 3, "model.depthwise", None, base + 40, base + 41, bwd,
                             layer="conv_ds_1_dw", phase="backward"))
        i += 4
    run = _fake_run(recs)
    assert _reader("train_dw_conv_ms").read(run) == pytest.approx(4.0)  # 3.0 and 5.0
    ops, nbytes = dwconv.work(_config(), 4096)
    least = max(ops / 495e12, nbytes / 3.35e12)
    assert _reader("dw_conv_roofline_pct").read(run) == pytest.approx(100 * least / 4e-3)


@pytest.mark.parametrize("name", ["train_dw_conv_ms", "dw_conv_roofline_pct"])
def test_the_readers_give_none_without_depthwise_spans(name):
    """A program without the spans (the parent of the change that added
    them) records steps and nothing else."""
    run = _fake_run([_rec(1, "train.step", None, 0, 90, 50.0)])
    assert _reader(name).read(run) is None


# Three Adam steps at batch 8 on 64 clips, both sides float32 on the CPU;
# they differ by their front ends' arithmetic and the order of their sums.
# Over four seeds (SEED, 11, 12, 13) the program read at most the first
# number in each comment; the 5%-high learning rate reads 0.048-0.050 on
# `change_median_gap`, the half batch 0.17-0.23 on `grad_row_median_gap`:
TOLERANCES = {
    "loss1_gap": 1e-5,  # 2.0e-7: one forward pass and the mean loss over 8 rows
    "grad_row_median_gap": 2e-3,  # 3.8e-4: one backward pass, by rows
    # 2.3e-3: Adam moves each element by about lr whatever its gradient's size,
    # so a rounding where |g| is small moves it by as much
    "change_median_gap": 1e-2,
    "grad_leaf_worst": 5e-3,  # 8.2e-4: the worst leaf, a small one
    "change_leaf_worst": 5e-2,  # 2.5e-2: a batch norm's 276 shifts, moved by lr each
}


@pytest.fixture(scope="module")
def dscnn_adam():
    from portbench.tests.conftest import shrink

    cell = shrink(spec.load_cell(CELL))
    r = harness.Run(cell, SEED, 0.0, False, torch.device("cpu"))
    d = r.driver = cell.kind.Driver(r)
    d.setup()
    d.release()
    program = d.check()
    return program, d.faults(), d.detail(), d.control()


def test_three_adam_steps_of_the_port_match_the_reference(dscnn_adam):
    program, _, _, _ = dscnn_adam
    assert set(program) == set(TOLERANCES)
    assert all(program[k] <= TOLERANCES[k] for k in TOLERANCES), program


@pytest.mark.parametrize("fault", ["lr_high", "half_batch"])
def test_the_same_comparison_fails_each_fault(dscnn_adam, fault):
    _, faults, _, _ = dscnn_adam
    assert any(faults[fault][k] > TOLERANCES[k] for k in TOLERANCES), faults[fault]


def test_the_cells_limits_pass_the_program_and_fail_the_control_and_each_fault(dscnn_adam):
    """The limits set on the card at batch 4096, read at the CPU's size."""
    program, faults, _, control = dscnn_adam
    limits = harness.limits(CELL)
    assert set(limits) == set(program)
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control
    for name, numbers in faults.items():
        assert any(numbers[k] > limits[k] for k in limits), (name, numbers)


def test_the_conv_biases_are_quiet_and_fc1_bias_is_not(dscnn_adam):
    """Each conv bias meets a batch norm in training mode, so its gradient is
    rounding noise: `compare.QUIET` leaves the 11 out of the change gaps."""
    _, _, detail, _ = dscnn_adam
    program = detail["program"]
    quiet = set(program["grad_leaves"]) - set(program["change_leaves"])
    convs = {f"{name}.bias" for name, *_ in dscnn.convs(_config()["architecture"])}
    assert len(convs) == 11 and quiet == convs
    assert "fc1.bias" in program["change_leaves"]


def test_the_guard_walks_the_family_file():
    """`test_the_reference_imports_nothing_of_the_program` walks the
    reference folder recursively; the family file is in that walk and
    imports nothing of the program."""
    from portbench.tests.test_portbench_harness import _imports

    root = spec.BENCH_DIR / "reference"
    path = root / "families" / "dscnn.py"
    assert path in set(root.rglob("*.py"))
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"tcresnet_tpu_torch", "tcresnet_tpu", "jax", "jaxlib", "flax"}
    assert "tcresnet_tpu" not in path.read_text()


def test_the_reference_front_end_geometry():
    g = frontend.Geometry.from_audio(_config()["audio"])
    assert (g.window, g.hop, g.fft, g.frames, g.coeffs) == (640, 320, 1024, 49, 10)


def test_the_traced_pass_records_the_depthwise_spans_on_the_cpu(small_cell):
    from portbench.harness import spans

    cell = small_cell(CELL)
    r = harness.Run(cell, SEED, 1.0, True, torch.device("cpu"))
    assert harness.run_cell(r)["correct"] is True
    recs = r.notes["spans.records"]
    steps = spans.TRAIN_CALLS * cell.traffic["steps_per_call"]
    dw = [x for x in recs if x["name"] == "model.depthwise"]
    assert sum(x["name"] == "train.step" for x in recs) == steps
    assert len(dw) == steps * 2 * 5
    assert {x["attrs"]["phase"] for x in dw} == {"forward", "backward"}


@pytest.mark.cuda
def test_a_short_run_of_the_cell_on_the_card(cuda_device):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
                        str(SEED), "--seconds", "2", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["busy_s"] > 0
    metrics = out["metrics"]
    assert 0 < metrics["dw_conv_roofline_pct"]["value"] <= 100
    assert metrics["train_dw_conv_ms"]["value"] > 0
