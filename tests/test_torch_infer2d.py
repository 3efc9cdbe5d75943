"""K5's host side and plain version (ops/kernels/infer2d.py) against the
JAX package's 2D inference kernel (ops/pallas/infer2d.py).

- The port's op list equals JAX's `build_op_list`, op for op, weights
  bit for bit, for every family and KWS architecture.
- The plain version (features -> logits through the lowered program that
  the CUDA kernel runs) meets the JAX kernel in interpret mode and the
  JAX "xla" path within the 1e-5 softmax gate, on the same numpy weights
  and wavs. KWS `conv` and `low_latency_conv` are held to the "xla" path
  only: the JAX package keeps their interpret-mode cases in its slow tier.

The CNN families run at the JAX test's small geometry (250 ms, MFCC-20:
23 x 20 features), KWS at its preset's 49 x 40.
"""

import dataclasses

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
from tcresnet_tpu_torch.models.convert import variables_from_jax
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
    assert plan.ops.shape == (16, len(k5.OP_FIELDS))
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
