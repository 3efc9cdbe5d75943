"""PyTorch TC-ResNet (tcresnet_tpu_torch.models) against the Flax one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu.models import build_model as jax_build_model
from tcresnet_tpu.models import param_count as jax_param_count
from tcresnet_tpu_torch.config import ModelConfig
from tcresnet_tpu_torch.models import build_model, param_count
from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
from tests.test_torch_config import to_jax_config

torch.set_num_threads(1)

SHAPE = (24, 20, 1)  # small front end: 24 frames x 20 coefficients


def _to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jax.device_get(a)), tree)


def _flax_variables(model, shape, seed=0):
    v = model.init({"params": jax.random.key(seed), "dropout": jax.random.key(1)},
                   jnp.zeros((2,) + shape, jnp.float32), training=True)
    stats = jax.tree_util.tree_map(
        lambda x: np.random.default_rng(seed).uniform(0.5, 1.5, x.shape).astype(np.float32),
        v["batch_stats"])
    return _to_numpy(v["params"]), _to_numpy(stats)


def _port_model(cfg, shape, variables):
    model = build_model(cfg, shape, device="cpu")
    model.load_state_dict({**variables["params"], **variables["batch_stats"]})
    return model


@pytest.mark.parametrize("name,wm,ncls", [("TCResNet8", 1.0, 12), ("TCResNet14", 1.5, 12),
                                          ("TCResNet8", 1.5, 7), ("TCResNet14", 1.0, 7)])
def test_eval_logits_match_flax(name, wm, ncls):
    """Converted Flax weights give eval logits within 1e-5 of model.apply."""
    cfg = ModelConfig(name=name, num_classes=ncls, width_multiplier=wm)
    jmodel = jax_build_model(to_jax_config(cfg), SHAPE)
    params, stats = _flax_variables(jmodel, SHAPE)
    feats = np.random.default_rng(3).standard_normal((3,) + SHAPE).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(feats), training=False))
    model = _port_model(cfg, SHAPE, variables_from_jax(cfg, params, stats))
    with torch.no_grad():
        got = model(torch.tensor(feats)).numpy()
        got3 = model(torch.tensor(feats[..., 0])).numpy()  # [B, T, C] input too
    assert got.shape == want.shape == (3, ncls)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got3, got)


@pytest.mark.parametrize("name,wm", [("TCResNet8", 1.0), ("TCResNet14", 1.5)])
def test_seeded_variables_are_a_flax_tree(name, wm):
    """seeded_variables has exactly Flax's scopes, leaves and shapes, and
    gives Flax and the port the same logits."""
    cfg = ModelConfig(name=name, width_multiplier=wm)
    jmodel = jax_build_model(to_jax_config(cfg), SHAPE)
    flax_params, flax_stats = _flax_variables(jmodel, SHAPE)
    seeded = seeded_variables(cfg, SHAPE, seed=5)
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)  # noqa: E731
    assert shapes(seeded["params"]) == shapes(flax_params)
    assert shapes(seeded["batch_stats"]) == shapes(flax_stats)
    again = seeded_variables(cfg, SHAPE, seed=5)
    for a, b in zip(jax.tree_util.tree_leaves(seeded), jax.tree_util.tree_leaves(again)):
        assert np.array_equal(a, b)

    feats = np.random.default_rng(4).standard_normal((2,) + SHAPE).astype(np.float32)
    want = np.asarray(jmodel.apply(seeded, jnp.asarray(feats), training=False))
    with torch.no_grad():
        got = _port_model(cfg, SHAPE, variables_from_jax(cfg, **seeded))(torch.tensor(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_tcresnet8_param_count():
    """65,168 for TCResNet8-1.0 at 40 MFCCs, 12 classes (tests/test_models.py)."""
    cfg = ModelConfig(name="TCResNet8", width_multiplier=1.0)
    model = build_model(cfg, (98, 40, 1), device="cpu")
    assert param_count(model) == 65168
    assert param_count(variables_from_jax(cfg, **seeded_variables(cfg, (98, 40, 1), 0))["params"]) == 65168


def test_tcresnet14_param_count_equals_flax():
    cfg = ModelConfig(name="TCResNet14", width_multiplier=1.5)
    params, _ = _flax_variables(jax_build_model(to_jax_config(cfg), (98, 40, 1)), (98, 40, 1))
    assert param_count(build_model(cfg, (98, 40, 1), device="cpu")) == jax_param_count(params)


def test_conversion_layouts_and_ema():
    """Conv [k,1,Ci,Co] -> [Co,Ci,k], Dense [in,out] -> [out,in], BN by
    name; the EMA copy converts like params."""
    cfg = ModelConfig(name="TCResNet8")
    seeded = seeded_variables(cfg, SHAPE, seed=2)
    ema = jax.tree_util.tree_map(lambda a: a * 2, seeded["params"])
    v = variables_from_jax(cfg, seeded["params"], seeded["batch_stats"], ema_params=ema)
    kern = seeded["params"]["block0_conv0_conv"]["kernel"]
    np.testing.assert_array_equal(v["params"]["block0_conv0_conv.weight"].numpy(),
                                  kern[:, 0].transpose(2, 1, 0))
    np.testing.assert_array_equal(v["params"]["fc.weight"].numpy(),
                                  seeded["params"]["fc"]["kernel"].T)
    np.testing.assert_array_equal(v["batch_stats"]["conv0_bn.running_var"].numpy(),
                                  seeded["batch_stats"]["conv0_bn"]["var"])
    np.testing.assert_array_equal(v["ema_params"]["conv0_bn.weight"].numpy(),
                                  2 * seeded["params"]["conv0_bn"]["scale"])
    with pytest.raises(KeyError, match="no port counterpart"):
        variables_from_jax(cfg, {**seeded["params"], "svdf": {"kernel": np.zeros(3)}}, {})


def test_build_model_rejects_what_is_not_ported():
    """Every family of the JAX registry builds now (tests/test_torch_models2d.py
    holds them to Flax); the im2col conv backend is not carried over."""
    for name in ("Res8", "DSCNNS", "KWS", "ResNet2D8"):
        assert not build_model(ModelConfig(name=name), (98, 40, 1), device="cpu").training
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(ModelConfig(name="Res8", conv_backend="im2col"), (98, 40, 1), device="cpu")
    with pytest.raises(KeyError):
        build_model(ModelConfig(name="NoSuchNet"), (98, 40, 1), device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        build_model(ModelConfig(), (98, 40, 1), "float16", device="cpu")
    # training mode and bf16 compute are ported now
    model = build_model(ModelConfig(), SHAPE, "bfloat16", device="cpu").train()
    assert model(torch.zeros((2,) + SHAPE)).shape == (2, 12)
