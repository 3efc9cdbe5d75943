"""K5's host side and plain version (ops/kernels/infer2d.py) against the
JAX package's 2D inference kernel (ops/pallas/infer2d.py).

- The port's op list equals JAX's `build_op_list`, op for op, weights
  bit for bit, for every family and KWS architecture.
- The kernel's GEMM plan at batch 1 and 1024 for every preset: its tiles
  and K parts cover each output and each (tap, channel) index once, and a
  batch-1 conv reaches every block of the grid; the program replayed with
  the kernel's im2col indexing and its split-K order meets the plain
  version.
- The plain version (features -> logits through the lowered program that
  the CUDA kernel runs) meets the JAX kernel in interpret mode and the
  JAX "xla" path within the 1e-5 softmax gate, on the same numpy weights
  and wavs. KWS `conv` and `low_latency_conv` are held to the "xla" path
  only: the JAX package keeps their interpret-mode cases in its slow tier.

The CNN families run at the JAX test's small geometry (250 ms, MFCC-20:
23 x 20 features), KWS at its preset's 49 x 40.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu import config as jconfig
from tcresnet_tpu.models import build_model as jax_build_model
from tcresnet_tpu.ops.pallas import infer2d as jk5
from tcresnet_tpu.serve.export import build_inference_fn as jax_build_inference_fn
from tcresnet_tpu_torch import config as tconfig
from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
from tcresnet_tpu_torch.models.kws import KWS_ARCHITECTURES
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.ops.kernels import infer2d as k5
from tcresnet_tpu_torch.serve.export import build_inference_fn

torch.set_num_threads(1)

SOFTMAX_ATOL = 1e-5
SMALL_AUDIO = tconfig.AudioConfig(clip_duration_ms=250, num_mfccs=20, num_mel_bins=32)
CNN_PRESETS = ["TCResNet2D8-1.0", "TCResNet2D8Pool-1.0", "Res8", "Res8Narrow", "Res15",
               "Res15Narrow", "DSCNNS", "DSCNNM", "DSCNNL"]
# the JAX package's default-tier interpret-mode cases (test_pallas_infer2d.py)
INTERPRET_PRESETS = ["DSCNNS", "DSCNNL", "TCResNet2D8-1.0", "TCResNet2D8Pool-1.0",
                     "Res8Narrow", "Res15", "Res15Narrow"]
INTERPRET_KWS = ["single_fc", "one_fstride4", "trad_fpool3", "low_latency_svdf", "tiny_conv"]


def _cfg(preset, arch=None, **model_kw):
    """(port config, JAX config): CNN presets at the small geometry, KWS at
    its own; float32 compute."""
    cfg = tconfig.get_preset(preset)
    if arch is not None:
        model_kw["kws_architecture"] = arch
    cfg = cfg.replace(
        audio=cfg.audio if cfg.model.name == "KWS" else SMALL_AUDIO,
        model=dataclasses.replace(cfg.model, **model_kw),
        train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    return cfg, jconfig.ExperimentConfig.from_json(cfg.to_json())


def _flax_variables(jcfg, seed=0):
    shape = dsp.feature_shape(jcfg.audio)
    v = jax_build_model(jcfg.model, shape, "float32").init(
        {"params": jax.random.key(seed), "dropout": jax.random.key(seed + 1)},
        jnp.zeros((2,) + shape, jnp.float32), training=True)
    # batch statistics off their initial values, so the folding is exercised
    stats = jax.tree_util.tree_map(lambda a: jnp.abs(a + 0.07), v.get("batch_stats", {}))
    to_np = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    return {"params": to_np(v["params"]), "batch_stats": to_np(stats)}


def _wavs(cfg, batch, seed=3):
    return np.random.default_rng(seed).uniform(
        -0.5, 0.5, (batch, cfg.audio.desired_samples)).astype(np.float32)


def _plan(cfg, variables):
    v = variables_from_jax(cfg.model, **variables)
    return k5.build_fused_infer2d(cfg.model, cfg.audio, v["params"], v["batch_stats"],
                                  device="cpu")


def _port_softmax(cfg, variables, wavs):
    with torch.no_grad():
        return torch.softmax(_plan(cfg, variables)(torch.tensor(wavs)), -1).numpy()


def _assert_parity(preset, arch=None, interpret=True, batch=2, **model_kw):
    cfg, jcfg = _cfg(preset, arch, **model_kw)
    assert k5.fused_infer2d_available(cfg.model, cfg.audio)
    variables = _flax_variables(jcfg)
    wavs = _wavs(cfg, batch)
    got = _port_softmax(cfg, variables, wavs)
    assert got.shape == (batch, cfg.model.num_classes)
    xla = np.asarray(jax_build_inference_fn(jcfg, variables, backend="xla")(jnp.asarray(wavs)))
    np.testing.assert_allclose(got, xla, rtol=0, atol=SOFTMAX_ATOL)
    if interpret:
        fused = jk5.build_fused_infer2d(jcfg.model, jcfg.audio, variables["params"],
                                        variables["batch_stats"], interpret=True)
        want = np.asarray(jax.nn.softmax(fused(jnp.asarray(wavs)), axis=-1))
        np.testing.assert_allclose(got, want, rtol=0, atol=SOFTMAX_ATOL)


OP_LIST_CASES = [(p, None) for p in CNN_PRESETS] + [("KWSfpool3", a) for a in KWS_ARCHITECTURES]


@pytest.mark.parametrize("preset,arch", OP_LIST_CASES,
                         ids=[p if a is None else f"KWS-{a}" for p, a in OP_LIST_CASES])
def test_op_list_matches_jax(preset, arch):
    """Same ops, same folded weights (bit for bit), same input rank."""
    cfg, jcfg = _cfg(preset, arch)
    variables = _flax_variables(jcfg)
    shape = dsp.feature_shape(cfg.audio)
    want_ops, want_w, want_rank = jk5.build_op_list(
        jcfg.model, variables["params"], variables["batch_stats"], shape)
    v = variables_from_jax(cfg.model, **variables)
    ops, weights, rank = k5.build_op_list(cfg.model, v["params"], v["batch_stats"], shape)
    assert ops == want_ops and rank == want_rank
    assert len(weights) == len(want_w)
    for got, want in zip(weights, want_w):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("preset", INTERPRET_PRESETS)
def test_plain_version_matches_jax_kernel(preset):
    _assert_parity(preset)


@pytest.mark.parametrize("preset", ["Res8", "DSCNNM"])
def test_plain_version_matches_jax_xla(preset):
    """The presets JAX's default tier runs in interpret mode only at real
    geometry (its slow tier): held to the "xla" path."""
    _assert_parity(preset, interpret=False)


@pytest.mark.parametrize("arch", KWS_ARCHITECTURES)
def test_kws_plain_version_matches_jax(arch):
    _assert_parity("KWSfpool3", arch, interpret=arch in INTERPRET_KWS)


@pytest.mark.parametrize("preset,wm,ncls", [("TCResNet2D8-1.0", 1.5, 12),
                                            ("TCResNet2D8-1.0", 0.5, 7),
                                            ("DSCNNS", 1.0, 5), ("Res8Narrow", 1.0, 9)])
def test_nondefault_width_and_classes(preset, wm, ncls):
    """test_pallas_infer2d.py's non-default widths and class counts: odd
    channel counts pad the kernel's weights to a multiple of 4."""
    _assert_parity(preset, width_multiplier=wm, num_classes=ncls)


@pytest.mark.parametrize("batch", [0, 1, 5])
def test_batch_sizes(batch):
    cfg, jcfg = _cfg("DSCNNS")
    variables = _flax_variables(jcfg)
    wavs = _wavs(cfg, batch, seed=11)
    plan = _plan(cfg, variables)
    logits = plan(torch.tensor(wavs))
    assert tuple(logits.shape) == (batch, cfg.model.num_classes)
    if batch:
        xla = np.asarray(jax_build_inference_fn(jcfg, variables, backend="xla")(jnp.asarray(wavs)))
        np.testing.assert_allclose(torch.softmax(logits, -1).numpy(), xla, rtol=0,
                                   atol=SOFTMAX_ATOL)


def test_program_slots_and_epilogues():
    """Res15's program: save / roles become slots, each affine and addsc a
    conv epilogue; three slots; the last op writes the logits."""
    cfg, jcfg = _cfg("Res15")
    plan = _plan(cfg, _flax_variables(jcfg))
    kinds = [op.kind for op in plan.program]
    assert kinds == ["conv"] * 14 + ["gap", "dense"]
    convs = plan.program[:14]
    assert [op.dil for op in convs] == [1] + [2 ** (i // 3) for i in range(13)]
    assert all(op.aff_off >= 0 for op in convs[1:]) and convs[0].aff_off < 0
    assert [op.res >= 0 for op in convs[1:]] == [i % 2 == 1 and i < 12 for i in range(13)]
    for op in plan.program:
        assert op.dst != op.src and op.dst != op.res
        assert op.src in (k5.INPUT, 0, 1, 2)
    assert plan.program[-1].dst == k5.OUTPUT
    table = plan.op_table(1)
    assert table.shape == (16, len(k5.OP_FIELDS) + len(k5.PLAN_FIELDS))
    assert table.dtype == torch.int32 and plan.op_table(1) is table  # made once per batch
    col = {f: len(k5.OP_FIELDS) + i for i, f in enumerate(k5.PLAN_FIELDS)}
    assert bool((table[:14, col["splits"]] >= 1).all())
    assert table[14, len(k5.OP_FIELDS):].abs().sum() == 0  # gap has no GEMM plan
    assert int(table[15, col["k_total"]]) == plan.program[15].c_in  # dense: K = its inputs
    assert int(plan.wts.numel()) % 4 == 0
    for op in plan.program:
        for off in (op.w_off, op.w2_off):
            assert off == -1 or off % 4 == 0  # 16-byte loads


def test_inference_fn_routes_to_plain_version_on_cpu(monkeypatch):
    """backend "fused" and "auto" on a CPU tensor run K2's and K5's plain
    versions; "fused" raises where the kernel does not serve the model."""
    cfg, jcfg = _cfg("DSCNNS")
    variables = _flax_variables(jcfg)
    v = variables_from_jax(cfg.model, **variables)
    wavs = torch.tensor(_wavs(cfg, 3, seed=5))
    calls = []
    real = k5.fused_infer2d_reference
    monkeypatch.setattr(k5, "fused_infer2d_reference",
                        lambda feats, plan: calls.append(feats.shape[0]) or real(feats, plan))
    xla = np.asarray(jax_build_inference_fn(jcfg, variables, backend="xla")(wavs.numpy()))
    for backend in ("fused", "auto"):
        got = build_inference_fn(cfg, v, backend=backend, device="cpu")(wavs).numpy()
        np.testing.assert_allclose(got, xla, rtol=0, atol=SOFTMAX_ATOL)
    assert calls == [3]  # "auto" on the CPU takes the plain path
    bad = cfg.replace(audio=dataclasses.replace(cfg.audio, window_size_ms=25.0))
    with pytest.raises(ValueError, match="backend='fused'"):
        build_inference_fn(bad, v, backend="fused", device="cpu")
    with pytest.raises(ValueError, match="backend='fused'"):
        build_inference_fn(cfg, v, backend="fused", include_preprocess=False, device="cpu")
    assert not k5.fused_infer2d_available(
        dataclasses.replace(cfg.model, name="KWS", kws_architecture="nope"), cfg.audio)
    assert not k5.fused_infer2d_available(tconfig.ModelConfig(name="TCResNet8"), cfg.audio)


def test_every_preset_is_served_by_a_fused_kernel():
    """All 15 presets (latency_bench's default list): the temporal
    TC-ResNets through K4, the other 11 through K2 + K5."""
    from tcresnet_tpu_torch.ops.kernels import infer as k4
    from tcresnet_tpu_torch.tools.latency_bench import SUPPORTED

    assert sorted(SUPPORTED) == sorted(tconfig.PRESETS)
    by_k5 = [p for p in SUPPORTED
             if k5.fused_infer2d_available(tconfig.get_preset(p).model, tconfig.get_preset(p).audio)]
    by_k4 = [p for p in SUPPORTED
             if k4.fused_infer_available(tconfig.get_preset(p).model, tconfig.get_preset(p).audio)]
    assert len(by_k5) == 11 and len(by_k4) == 4 and not set(by_k4) & set(by_k5)


# ---------------------------------------------------------------------------
# the kernel's GEMM plan (tiles, K parts), made on the host per batch
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _preset_plan(preset, arch):
    """A plan at the preset's own geometry (random weights from a seed)."""
    cfg = tconfig.get_preset(preset)
    if arch is not None:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, kws_architecture=arch))
    v = variables_from_jax(cfg.model, **seeded_variables(cfg.model, dsp.feature_shape(cfg.audio), 0))
    return k5.build_fused_infer2d(cfg.model, cfg.audio, v["params"], v["batch_stats"],
                                  device="cpu")


def _plan_fields(plan, batch):
    rows = plan.op_table(batch).tolist()
    return [dict(zip(k5.OP_FIELDS + k5.PLAN_FIELDS, row)) for row in rows]


def _partition(starts, total, tile):
    """The [start, start + tile) runs, cut at `total`, tile [0, total) once."""
    starts = np.asarray(starts)
    ends = np.minimum(starts + tile, total)
    assert starts[0] == 0 and ends[-1] == total
    assert np.all(ends > starts) and np.array_equal(ends[:-1], starts[1:])


@pytest.mark.parametrize("batch", [1, 1024])
@pytest.mark.parametrize("preset,arch", OP_LIST_CASES,
                         ids=[p if a is None else f"KWS-{a}" for p, a in OP_LIST_CASES])
def test_gemm_plan_covers_every_output_and_k_index_once(preset, arch, batch):
    """Every conv (full, c1) and dense step: the M x N tiles cover each
    output element once, the K parts each (tap, input channel) index once;
    the other steps carry no plan."""
    plan = _preset_plan(preset, arch)
    gemms = 0
    for op, f in zip(plan.program, _plan_fields(plan, batch)):
        if not k5.is_gemm(op):
            assert all(f[name] == 0 for name in k5.PLAN_FIELDS), op.kind
            continue
        gemms += 1
        bm, bn, bk = k5.GEMM_TILES[f["tile"]]
        assert f["tile"] == (1 if op.c_pad <= k5.NARROW_N else 0)
        m_total = batch * op.t_out * op.f_out
        taps = op.kh * op.kw
        assert f["k_total"] == taps * op.c_in and (op.mode != "c1" or op.c_in == 1)
        _partition(np.arange(f["tiles_m"]) * bm, m_total, bm)
        _partition(np.arange(f["tiles_n"]) * bn, op.c_out, bn)
        slices = -(-f["k_total"] // bk)
        part = f["split_slices"] * bk
        _partition(np.arange(f["splits"]) * part, slices * bk, part)
        # the kernel's unit index u -> (n tile fastest, then m tile, then part)
        units = f["tiles_m"] * f["tiles_n"] * f["splits"]
        u = np.arange(units)
        decoded = {(int(s), int(tm), int(tn)) for s, tm, tn in zip(
            u // f["tiles_n"] // f["tiles_m"], u // f["tiles_n"] % f["tiles_m"], u % f["tiles_n"])}
        assert len(decoded) == units
        assert f["vec"] == (4 if op.c_in % 4 == 0 else 1)
    assert gemms >= 1


@pytest.mark.parametrize("preset,arch", OP_LIST_CASES,
                         ids=[p if a is None else f"KWS-{a}" for p, a in OP_LIST_CASES])
def test_batch_one_spreads_every_conv_over_the_grid(preset, arch):
    """At batch 1 each conv step (full, c1) has at least as many work units
    as an H100's 264-block grid, or is cut into K parts of the minimum
    length (MIN_K_PART, 32 K indices: one slice); no part of any GEMM step
    is shorter, but a step's last; a split step sizes its partial buffer."""
    plan = _preset_plan(preset, arch)
    assert k5.H100_GRID_BLOCKS == 264 and k5.MIN_K_PART == 32
    fields = _plan_fields(plan, 1)
    for op, f in zip(plan.program, fields):
        if not k5.is_gemm(op):
            continue
        bk = k5.GEMM_TILES[f["tile"]][2]
        assert k5.MIN_K_PART % bk == 0
        part = f["split_slices"] * bk
        assert part >= k5.MIN_K_PART
        if op.kind == "conv":
            units = f["tiles_m"] * f["tiles_n"] * f["splits"]
            assert units >= 264 or part == k5.MIN_K_PART, (op.mode, units, f)
        if f["splits"] > 1:
            assert plan.partial_floats(1) >= f["splits"] * op.t_out * op.f_out * op.c_out


def test_op_tables_are_kept_for_the_last_batch_sizes():
    """A plan makes its op table once per batch size, equal to `op_rows`,
    and keeps only the MAX_TABLES sizes used last."""
    plan = _preset_plan("DSCNNS", None)
    first = plan.op_table(1)
    assert plan.op_table(1) is first
    rows, partial = k5.op_rows(plan.program, 1, k5.H100_GRID_BLOCKS)
    assert first.dtype == torch.int32 and first.tolist() == rows
    assert plan.partial_floats(1) == partial
    for batch in range(2, k5.MAX_TABLES + 6):
        plan.op_table(batch)
        assert len(plan._tables) <= k5.MAX_TABLES
    assert 1 not in plan._tables and k5.MAX_TABLES + 5 in plan._tables
    assert plan.op_table(1) is not first and plan.op_table(1).tolist() == rows


def _replay_split_k(feats, plan):
    """The kernel's program on the CPU with its GEMM steps computed its
    way: the im2col operand gathered by the kernel's index arithmetic
    (row -> utterance and window origin, k -> tap and channel, taps off the
    map zero), one partial product per K part, the parts added in split
    order, then the epilogue. The other steps take the plain version's."""
    batch = feats.shape[0]
    slots = {k5.INPUT: feats}
    out = None
    for op, f in zip(plan.program, _plan_fields(plan, batch)):
        x = slots[op.src].reshape(batch, op.t_in, op.f_in, op.c_in)
        if not k5.is_gemm(op):
            if op.kind == "conv":
                res = None if op.res < 0 else slots[op.res]
                y = k5._conv_ref(x, op, res)
            elif op.kind in ("pool", "maxpool"):
                y = k5._pool_ref(x, op)
            elif op.kind == "gap":
                y = x.mean(dim=(1, 2))
            elif op.kind == "tconv_full":
                y = k5._tconv_full_ref(x, op)
            else:
                y = k5._svdf_ref(x, op)
            out = slots[op.dst] = y
            continue
        p = op.t_out * op.f_out
        m = torch.arange(batch * p)
        b, q = m // p, m % p
        r0, c0 = (q // op.f_out) * op.sh - op.pad_t, (q % op.f_out) * op.sw - op.pad_f
        k = torch.arange(f["k_total"])
        tap, ci = k // op.c_in, k % op.c_in
        rows = r0[:, None] + (tap // op.kw)[None] * op.dil
        cols = c0[:, None] + (tap % op.kw)[None] * op.dil
        ok = (rows >= 0) & (rows < op.t_in) & (cols >= 0) & (cols < op.f_in)
        at = ((rows.clamp(0, op.t_in - 1) * op.f_in + cols.clamp(0, op.f_in - 1)) * op.c_in
              + ci[None])
        a = torch.where(ok, x.reshape(batch, -1)[b[:, None], at], torch.zeros(()))
        w = op.w.reshape(-1, op.c_pad)[:, :op.c_out]
        bk = k5.GEMM_TILES[f["tile"]][2]
        acc = None
        for s in range(f["splits"]):
            k0 = s * f["split_slices"] * bk
            k1 = min(k0 + f["split_slices"] * bk, f["k_total"])
            part = a[:, k0:k1] @ w[k0:k1]
            acc = part if acc is None else acc + part
        y = (acc if op.b is None else acc + op.b).reshape(batch, op.t_out, op.f_out, op.c_out)
        if op.relu:
            y = torch.relu(y)
        if op.res >= 0:
            y = y + slots[op.res].reshape(y.shape)
            if op.relu2:
                y = torch.relu(y)
        if op.aff is not None:
            y = y * op.aff[0] + op.aff[1]
        out = slots[op.dst] = y
    return out.reshape(batch, plan.ncls)


@pytest.mark.parametrize("preset,arch", OP_LIST_CASES,
                         ids=[p if a is None else f"KWS-{a}" for p, a in OP_LIST_CASES])
def test_split_k_replay_matches_the_plain_version(preset, arch):
    """The batch-1 plan (the most K parts) replayed in the kernel's order
    meets fused_infer2d_reference within the logit tolerance (atol 5e-4,
    rtol 1e-4) and the 1e-5 softmax gate; CNN presets at the small
    geometry, KWS at its own."""
    cfg, jcfg = _cfg(preset, arch)
    plan = _plan(cfg, _flax_variables(jcfg))
    feats = torch.tensor(np.random.default_rng(17).normal(
        2.0, 3.0, (1,) + dsp.feature_shape(cfg.audio)[:2]).astype(np.float32))
    with torch.no_grad():
        got, want = _replay_split_k(feats, plan), k5.fused_infer2d_reference(feats, plan)
    assert any(f["splits"] > 1 for f in _plan_fields(plan, 1))
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-4)
    torch.testing.assert_close(torch.softmax(got, -1), torch.softmax(want, -1),
                               atol=SOFTMAX_ATOL, rtol=0)
