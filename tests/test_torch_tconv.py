"""Kernel K7's plain versions (tcresnet_tpu_torch/ops/kernels/tconv.py)
and the port's conv_backend against the JAX Pallas temporal conv, run in
interpret mode as tests/test_pallas_tconv.py runs it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu.config import ModelConfig
from tcresnet_tpu.models import build_model as jax_build_model
from tcresnet_tpu.ops.pallas.tconv import pallas_temporal_conv as jax_tconv
from tcresnet_tpu_torch.models import build_model, layers
from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
from tcresnet_tpu_torch.models.convert import variables_to_jax
from tcresnet_tpu_torch.ops.kernels import tconv

torch.set_num_threads(1)

# tests/test_pallas_tconv.py:19-25, and a batch that is not a multiple of 8
CASES = [
    (5, 3, 1, 40, 16, 98),
    (5, 9, 1, 24, 24, 49),
    (5, 9, 2, 16, 24, 98),
    (5, 1, 2, 16, 24, 98),
    (5, 9, 2, 24, 32, 49),
    (11, 9, 2, 16, 24, 98),
]
# the JAX kernel test's tolerances (tests/test_pallas_tconv.py:35, :55-56):
# float32 sums in another order, dw over B * To products
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
DX_TOL = dict(atol=2e-4, rtol=1e-4)
DW_TOL = dict(atol=2e-3, rtol=1e-4)


def _case(b, k, stride, ci, co, t, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, 1, ci)).astype(np.float32)
    w = (rng.normal(size=(k, 1, ci, co)) * 0.1).astype(np.float32)
    to = -(-t // stride)
    cot = rng.normal(size=(b, to, 1, co)).astype(np.float32)
    return x, w, cot


def _jax_value_and_grads(x, w, cot, stride, dtype=jnp.float32):
    def loss(x, w):
        y = jax_tconv(x.astype(dtype), w.astype(dtype), stride, tb=4, interpret=True)
        return jnp.sum(y * cot), y

    (_, y), (gx, gw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    return np.asarray(y), np.asarray(gx), np.asarray(gw)


@pytest.mark.parametrize("b,k,stride,ci,co,t", CASES)
def test_plain_fwd_dx_dw_match_the_jax_kernel(b, k, stride, ci, co, t):
    x, w, cot = _case(b, k, stride, ci, co, t)
    jy, jgx, jgw = _jax_value_and_grads(x, w, cot, stride)

    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    y = tconv.pallas_temporal_conv(xt, wt, stride)
    (y * torch.tensor(cot)).sum().backward()
    assert y.shape == jy.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), jy, **FWD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), jgx, **DX_TOL)
    np.testing.assert_allclose(wt.grad.numpy(), jgw, **DW_TOL)

    # the three plain functions on the port's own layout
    xs = torch.tensor(x[:, :, 0].transpose(0, 2, 1).copy())
    ws = torch.tensor(w[:, 0].transpose(2, 1, 0).copy())
    dy = torch.tensor(cot[:, :, 0].transpose(0, 2, 1).copy())
    np.testing.assert_allclose(tconv.tconv_fwd_reference(xs, ws, stride).numpy(),
                               jy[:, :, 0].transpose(0, 2, 1), **FWD_TOL)
    np.testing.assert_allclose(tconv.tconv_dx_reference(dy, ws, t, stride).numpy(),
                               jgx[:, :, 0].transpose(0, 2, 1), **DX_TOL)
    np.testing.assert_allclose(tconv.tconv_dw_reference(xs, dy, k, stride).numpy(),
                               jgw[:, 0].transpose(2, 1, 0), **DW_TOL)


@pytest.mark.parametrize("k,stride,t", [(3, 1, 7), (9, 2, 11), (1, 2, 6), (4, 3, 10)])
def test_gradcheck_in_float64(k, stride, t):
    rng = np.random.default_rng(k * 10 + stride)
    x = torch.tensor(rng.normal(size=(2, 3, t)), dtype=torch.float64, requires_grad=True)
    w = torch.tensor(rng.normal(size=(4, 3, k)), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x, w: tconv.temporal_conv(x, w, stride), (x, w), eps=1e-6, atol=1e-8)


def test_bf16_compute_returns_f32_with_jax_rounded_gradients():
    """Under compute_dtype bf16 the K7 conv casts x and w to bf16 then to
    f32, returns f32, and autograd rounds dx and dw through bf16 as the
    VJP of JAX's casts does."""
    b, k, stride, ci, co, t = 5, 9, 2, 16, 24, 98
    x, w, cot = _case(b, k, stride, ci, co, t, seed=3)
    jy, jgx, jgw = _jax_value_and_grads(x, w, cot, stride, dtype=jnp.bfloat16)

    conv = layers.slim_conv(ci, co, (k, 1), (stride, 1), conv_backend="pallas",
                            dtype=torch.bfloat16)
    with torch.no_grad():
        conv.weight.copy_(torch.tensor(w[:, 0].transpose(2, 1, 0).copy()))
    xs = torch.tensor(x[:, :, 0].transpose(0, 2, 1).copy(), requires_grad=True)
    y = conv(xs)
    assert y.dtype == torch.float32
    (y * torch.tensor(cot[:, :, 0].transpose(0, 2, 1).copy())).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), jy[:, :, 0].transpose(0, 2, 1), **FWD_TOL)
    # both gradients come out rounded to bf16: equal up to the f32 sums'
    # order before that rounding (one bf16 ulp where a sum sits on a tie)
    gx = jgx[:, :, 0].transpose(0, 2, 1)
    gw = jgw[:, 0].transpose(2, 1, 0)
    for got, want in ((xs.grad.numpy(), gx), (conv.weight.grad.numpy(), gw)):
        assert np.array_equal(got, np.asarray(jnp.asarray(got, jnp.bfloat16), np.float32))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=2 ** -8)


def test_dx_skipped_for_an_input_that_needs_no_grad(monkeypatch):
    """The first conv's input needs no gradient: backward computes dw only.
    No kernel counter moves on the CPU, and the plain dx is not called."""
    calls = {"dx": 0, "dw": 0}
    real_dx, real_dw = tconv.tconv_dx_reference, tconv.tconv_dw_reference

    def spy_dx(*a):
        calls["dx"] += 1
        return real_dx(*a)

    def spy_dw(*a):
        calls["dw"] += 1
        return real_dw(*a)

    monkeypatch.setattr(tconv, "tconv_dx_reference", spy_dx)
    monkeypatch.setattr(tconv, "tconv_dw_reference", spy_dw)
    counts = (tconv.fwd_launches, tconv.dx_launches, tconv.dw_launches)
    x = torch.randn(3, 4, 10)
    w = torch.randn(5, 4, 3, requires_grad=True)
    tconv.temporal_conv(x, w, 1).sum().backward()
    assert calls == {"dx": 0, "dw": 1} and w.grad is not None
    x.requires_grad_(True)
    w.requires_grad_(False)
    tconv.temporal_conv(x, w, 2).sum().backward()
    assert calls == {"dx": 1, "dw": 1} and x.grad is not None
    assert (tconv.fwd_launches, tconv.dx_launches, tconv.dw_launches) == counts


def test_wrappers_refuse_bad_shapes_and_devices():
    x, w = torch.randn(2, 4, 10), torch.randn(5, 4, 3)
    with pytest.raises(ValueError):
        tconv.tconv_fwd(x, torch.randn(5, 3, 3))
    with pytest.raises(ValueError):
        tconv.tconv_dx(torch.randn(2, 5, 4), w, 10, 1)  # 4 rows, want 10
    with pytest.raises(ValueError):
        tconv.tconv_dw(x, torch.randn(2, 5, 5), 3, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tconv.tconv_fwd(x.to("meta"), w.to("meta"))


# ---------------------------------------------------------------------------
# the model's conv_backend
# ---------------------------------------------------------------------------

SHAPE = (24, 20, 1)
MODEL_TOL = dict(rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,wm", [("TCResNet8", 1.0), ("TCResNet14", 1.5)])
def test_pallas_model_matches_jax_pallas_interpret(name, wm):
    """Train-mode logits, BN statistics and parameter gradients of the
    port's "pallas" model against JAX "pallas-interpret" from the same
    weights, in float32."""
    cfg = ModelConfig(name=name, width_multiplier=wm, num_classes=7, dropout_keep_prob=1.0,
                      conv_backend="pallas")
    jcfg = ModelConfig(name=name, width_multiplier=wm, num_classes=7, dropout_keep_prob=1.0,
                       conv_backend="pallas-interpret")
    seeded = seeded_variables(cfg, SHAPE, seed=3)
    feats = np.random.default_rng(4).standard_normal((5,) + SHAPE).astype(np.float32)
    weights = np.random.default_rng(5).standard_normal((5, 7)).astype(np.float32)
    jmodel = jax_build_model(jcfg, SHAPE)
    tree = jax.tree_util.tree_map(jnp.asarray, seeded)

    def jloss(params):
        logits, mutated = jmodel.apply({"params": params, "batch_stats": tree["batch_stats"]},
                                       jnp.asarray(feats), training=True,
                                       mutable=["batch_stats"])
        return jnp.mean(logits * weights), (logits, mutated["batch_stats"])

    (_, (jlogits, jstats)), jgrads = jax.value_and_grad(jloss, has_aux=True)(tree["params"])

    model = build_model(cfg, SHAPE, device="cpu").train()
    convs = [m for m in model.modules() if isinstance(m, layers.TemporalConv)]
    assert convs and all(isinstance(m, layers.PallasTemporalConv) and not m.interpret
                         for m in convs)
    v = variables_from_jax(**seeded)
    model.load_state_dict({**v["params"], **v["batch_stats"]})
    logits = model(torch.tensor(feats))
    (logits * torch.tensor(weights)).mean().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **MODEL_TOL)
    back = variables_to_jax({"params": {k: p.grad for k, p in model.named_parameters()},
                             "batch_stats": dict(model.named_buffers())})
    for scope, leaves in jax.tree_util.tree_map(np.asarray, jstats).items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(back["batch_stats"][scope][leaf], want, **MODEL_TOL)
    for scope, leaves in jax.tree_util.tree_map(np.asarray, jgrads).items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(back["params"][scope][leaf], want, **MODEL_TOL,
                                       err_msg=f"{scope}/{leaf}")


def test_pallas_routes_every_conv_through_k7_and_matches_xla(monkeypatch):
    """Every conv of TCResNet8, the 1x1 stride-2 shortcuts included, goes
    through K7 (its plain forward here), and "pallas" equals "xla" from the
    same weights (the counterpart of test_tcresnet_conv_backend_equivalence)."""
    calls = []
    real = tconv.tconv_fwd_reference

    def spy(x, w, stride):
        calls.append((tuple(w.shape), stride))
        return real(x, w, stride)

    monkeypatch.setattr(tconv, "tconv_fwd_reference", spy)
    feat = (23, 20, 1)
    x = torch.tensor(np.random.default_rng(1).standard_normal((4,) + feat), dtype=torch.float32)
    seeded = variables_from_jax(**seeded_variables(ModelConfig(name="TCResNet8"), feat, seed=6))
    out = {}
    for backend in ("xla", "pallas"):
        model = build_model(ModelConfig(name="TCResNet8", num_classes=12, conv_backend=backend),
                            feat, device="cpu")
        model.load_state_dict({**seeded["params"], **seeded["batch_stats"]})
        logits = model(x)
        (logits ** 2).sum().backward()
        out[backend] = (logits.detach(), {k: p.grad for k, p in model.named_parameters()})
    assert len(calls) == 10
    assert sorted(c for c in calls if c[0][-1] == 1) == [((24, 16, 1), 2), ((32, 24, 1), 2),
                                                         ((48, 32, 1), 2)]
    torch.testing.assert_close(out["pallas"][0], out["xla"][0], atol=1e-5, rtol=1e-5)
    for k, g in out["xla"][1].items():
        torch.testing.assert_close(out["pallas"][1][k], g, atol=1e-3, rtol=1e-4, msg=k)


def test_conv_backend_im2col_and_unknown_values_raise():
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        build_model(ModelConfig(conv_backend="im2col"), SHAPE, device="cpu")
    with pytest.raises(ValueError, match="conv_backend"):
        build_model(ModelConfig(conv_backend="cudnn"), SHAPE, device="cpu")
    model = build_model(ModelConfig(conv_backend="pallas-interpret"), SHAPE, device="cpu")
    assert all(m.interpret for m in model.modules() if isinstance(m, layers.PallasTemporalConv))
    with pytest.raises(NotImplementedError, match="temporal"):
        layers.slim_conv(4, 4, (3, 3), (1, 1))
