"""The port's 2D model families (TCResNet2D8[Pool], Res, DS-CNN, KWS)
against the Flax ones, and the weight conversion for every family.

The same numpy weights (Flax `model.init`, batch statistics pushed off
their identity values) and the same numpy features go through the JAX
`model.apply` and the port's eval-mode model. The CNN families run at the
JAX kernel test's small geometry (250 ms, MFCC-20: 23 x 20 features);
KWS at its preset's 49 x 40, as tests/test_pallas_infer2d.py does
(trad_fpool3's VALID convs need at least 29 frames).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu import config as jconfig
from tcresnet_tpu.models import build_model as jax_build_model
from tcresnet_tpu.models import param_count as jax_param_count
from tcresnet_tpu_torch import config as tconfig
from tcresnet_tpu_torch.models import build_model, param_count
from tcresnet_tpu_torch.models.convert import (
    seeded_variables,
    variables_from_jax,
    variables_to_jax,
)
from tcresnet_tpu_torch.models.kws import KWS_ARCHITECTURES

torch.set_num_threads(1)

SMALL = (23, 20, 1)  # 250 ms at 30/10 ms, MFCC-20
KWS_SHAPE = (49, 40, 1)  # KWSfpool3's 40/20 ms MFCC-40
LOGIT_ATOL = 1e-5

CNN_FAMILIES = ["ResNet2D8", "ResNet2D8Pool", "Res8", "Res8Narrow", "Res15", "Res15Narrow",
                "DSCNNS", "DSCNNM", "DSCNNL"]
CASES = [(name, "conv", SMALL) for name in CNN_FAMILIES] + [
    ("KWS", arch, KWS_SHAPE) for arch in KWS_ARCHITECTURES]
IDS = CNN_FAMILIES + [f"KWS-{arch}" for arch in KWS_ARCHITECTURES]


def _cfgs(name, arch, **kw):
    port = tconfig.ModelConfig(name=name, kws_architecture=arch, **kw)
    return port, jconfig.ModelConfig(**dataclasses.asdict(port))


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(jax.device_get(a), np.float32), tree)


def _flax_variables(jmodel, shape, seed=0):
    v = jmodel.init({"params": jax.random.key(seed), "dropout": jax.random.key(seed + 1)},
                    jnp.zeros((2,) + shape, jnp.float32), training=True)
    stats = jax.tree_util.tree_map(
        lambda a: np.random.default_rng(seed).uniform(0.5, 1.5, a.shape).astype(np.float32),
        v.get("batch_stats", {}))
    return {"params": _numpy(v["params"]), "batch_stats": _numpy(stats)}


def _port_model(cfg, shape, variables):
    model = build_model(cfg, shape, device="cpu")
    model.load_state_dict({**variables["params"], **variables["batch_stats"]})
    return model


def _logits(cfg, jcfg, shape, variables, batch=3, seed=3):
    feats = np.random.default_rng(seed).standard_normal((batch,) + shape).astype(np.float32)
    want = np.asarray(jax_build_model(jcfg, shape).apply(variables, jnp.asarray(feats),
                                                         training=False))
    model = _port_model(cfg, shape, variables_from_jax(cfg, **variables))
    with torch.no_grad():
        got = model(torch.tensor(feats)).numpy()
    return got, want


@pytest.mark.parametrize("name,arch,shape", CASES, ids=IDS)
def test_eval_logits_match_flax(name, arch, shape):
    """Flax-initialised weights, converted: eval logits within 1e-5 of
    model.apply, and the same parameter count."""
    cfg, jcfg = _cfgs(name, arch, num_classes=12)
    variables = _flax_variables(jax_build_model(jcfg, shape), shape)
    got, want = _logits(cfg, jcfg, shape, variables)
    assert got.shape == want.shape == (3, 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    assert param_count(build_model(cfg, shape, device="cpu")) == jax_param_count(
        variables["params"])


@pytest.mark.parametrize("name,arch,shape", CASES, ids=IDS)
def test_seeded_variables_round_trip(name, arch, shape):
    """seeded_variables has exactly Flax's scopes, leaves and shapes;
    variables_to_jax(variables_from_jax(v)) == v, leaf for leaf; and the
    seeded weights give Flax and the port the same logits."""
    cfg, jcfg = _cfgs(name, arch)
    flax_v = _flax_variables(jax_build_model(jcfg, shape), shape)
    seeded = seeded_variables(cfg, shape, seed=5)
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)  # noqa: E731
    assert shapes(seeded) == shapes(flax_v)
    back = variables_to_jax(cfg, variables_from_jax(cfg, **seeded))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(seeded)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(seeded)):
        np.testing.assert_array_equal(a, b)
    got, want = _logits(cfg, jcfg, shape, seeded, batch=2, seed=4)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def test_tcresnet2d8_down_kernel_maps_as_2d():
    """TCResNet2D8's 1x1 stride-2 "down" kernel [1, 1, Ci, Co] is a 2D conv
    weight [Co, Ci, 1, 1], by family and scope name: the same scope of
    TCResNet8 is a temporal [Co, Ci, k]."""
    cfg2d, _ = _cfgs("ResNet2D8", "conv")
    seeded = seeded_variables(cfg2d, SMALL, seed=1)
    kern = seeded["params"]["block0_down_conv"]["kernel"]
    assert kern.shape[:2] == (1, 1)
    w = variables_from_jax(cfg2d, **seeded)["params"]["block0_down_conv.weight"]
    assert tuple(w.shape) == (kern.shape[3], kern.shape[2], 1, 1)
    np.testing.assert_array_equal(w.numpy()[:, :, 0, 0], kern[0, 0].T)
    cfg1d, _ = _cfgs("TCResNet8", "conv")
    w1d = variables_from_jax(cfg1d, **seeded_variables(cfg1d, SMALL, 1))["params"]
    assert w1d["block0_down_conv.weight"].dim() == 3
    with pytest.raises(ValueError, match=r"\[k, 1, Ci, Co\]"):
        variables_from_jax(cfg1d, {"block0_down_conv": {"kernel": np.zeros((3, 3, 2, 4))}}, {})


def test_res_batch_norm_has_no_params_and_dscnn_only_a_shift():
    """Res's BN has neither scale nor shift, so Flax keeps no params entry
    for it; DS-CNN's keeps only the shift. The port's state dicts agree."""
    for name, want in (("Res8Narrow", set()), ("DSCNNS", {"bias"})):
        cfg, jcfg = _cfgs(name, "conv")
        flax_v = _flax_variables(jax_build_model(jcfg, SMALL), SMALL)
        bn = [s for s in flax_v["batch_stats"] if s.endswith("_bn")]
        assert bn
        for scope in bn:
            assert set(flax_v["params"].get(scope, {})) == want
        v = variables_from_jax(cfg, **flax_v)
        model = _port_model(cfg, SMALL, v)
        assert set(model.state_dict()) == set(v["params"]) | set(v["batch_stats"])


def test_unknown_names_raise():
    with pytest.raises(KeyError, match="Unknown model"):
        build_model(tconfig.ModelConfig(name="NoSuchNet"), SMALL, device="cpu")
    with pytest.raises(ValueError, match="Unknown KWS architecture"):
        build_model(tconfig.ModelConfig(name="KWS", kws_architecture="nope"), KWS_SHAPE,
                    device="cpu")
    cfg, _ = _cfgs("Res8", "conv")
    with pytest.raises(KeyError, match="no port counterpart"):
        variables_from_jax(cfg, {"lin": {"kernel": np.zeros((3, 3))}}, {})


def test_trainer_trains_each_2d_family(tmp_path):
    """Each 2D family takes two adam steps in the Trainer on the CPU with a
    finite loss (train mode and steps are held to JAX in
    tests/test_torch_train2d.py); with optim.trainable_scopes=("fc",) only
    the fc params move."""
    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset
    from tcresnet_tpu_torch.train.trainer import Trainer

    audio = tconfig.AudioConfig(clip_duration_ms=250, num_mfccs=20, num_mel_bins=32)
    host = make_synthetic_dataset(num_samples=8, num_classes=4,
                                  desired_samples=audio.desired_samples, seed=0)
    for name in ("Res8Narrow", "DSCNNS", "KWS", "ResNet2D8"):
        cfg = tconfig.ExperimentConfig(
            audio=audio, model=tconfig.ModelConfig(name=name, num_classes=4),
            optim=tconfig.OptimConfig(optimizer="adam", lr_list=(1e-3,), boundaries=()),
            train=tconfig.TrainConfig(batch_size=4))
        trainer = Trainer(cfg, DeviceDataset(host, "cpu"), workdir=tmp_path / name)
        out = trainer.train_steps(2, start=0)
        assert np.isfinite(float(out["total_loss"])) and int(trainer.state.step) == 2, name
    frozen = Trainer(cfg.replace(optim=dataclasses.replace(cfg.optim, trainable_scopes=("fc",))),
                     DeviceDataset(host, "cpu"), workdir=tmp_path / "scopes")
    before = {k: p.detach().clone() for k, p in frozen.state.params.items()}
    frozen.train_steps(2, start=0)
    for k, p in frozen.state.params.items():
        assert torch.equal(p, before[k]) != k.startswith("fc."), k
