"""The training slice (tcresnet_tpu_torch models in train mode, loss,
optimizer, trainer step) against the JAX package on the same inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tcresnet_tpu_torch.config import AudioConfig, AugmentConfig, ExperimentConfig, ModelConfig
from tcresnet_tpu_torch.config import OptimConfig, TrainConfig
from tcresnet_tpu.models import build_model as jax_build_model
from tcresnet_tpu.ops import dsp as jdsp
from tcresnet_tpu.ops.pallas.augment import _fused_gather_augment_impl
from tcresnet_tpu.train import loss as jloss
from tcresnet_tpu.train import optim as joptim
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset
from tcresnet_tpu_torch.models import build_model, layers
from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
from tcresnet_tpu_torch.models.convert import variables_to_jax
from tcresnet_tpu_torch.ops import augment as aug
from tcresnet_tpu_torch.ops.kernels.augment import AugmentScalars
from tcresnet_tpu_torch.train import loss, optim
from tcresnet_tpu_torch.train.trainer import Trainer
from tests.test_torch_config import to_jax_config

torch.set_num_threads(1)

SHAPE = (24, 20, 1)
TOL = dict(rtol=1e-4, atol=1e-5)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("name,wm", [("TCResNet8", 1.0), ("TCResNet14", 1.5)])
def test_train_mode_logits_stats_and_grads_match_flax(name, wm):
    cfg = ModelConfig(name=name, width_multiplier=wm, num_classes=7, dropout_keep_prob=1.0)
    seeded = seeded_variables(cfg, SHAPE, seed=3)
    feats = np.random.default_rng(4).standard_normal((5,) + SHAPE).astype(np.float32)
    weights = np.random.default_rng(5).standard_normal((5, 7)).astype(np.float32)

    jmodel = jax_build_model(to_jax_config(cfg), SHAPE)

    def jloss_fn(params):
        logits, mutated = jmodel.apply(
            {"params": params, "batch_stats": _jnp(seeded["batch_stats"])},
            jnp.asarray(feats), training=True, mutable=["batch_stats"])
        return jnp.mean(logits * weights), (logits, mutated["batch_stats"])

    (_, (jlogits, jstats)), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
        _jnp(seeded["params"]))

    model = build_model(cfg, SHAPE, device="cpu").train()
    v = variables_from_jax(cfg, **seeded)
    model.load_state_dict({**v["params"], **v["batch_stats"]})
    logits = model(torch.tensor(feats))
    (logits * torch.tensor(weights)).mean().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **TOL)
    back = variables_to_jax(cfg, {
        "params": {k: p.grad for k, p in model.named_parameters()},
        "batch_stats": dict(model.named_buffers())})
    for scope, leaves in jax.tree_util.tree_map(np.asarray, jstats).items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(back["batch_stats"][scope][leaf], want, **TOL)
    for scope, leaves in jax.tree_util.tree_map(np.asarray, jgrads).items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(back["params"][scope][leaf], want, **TOL,
                                       err_msg=f"{scope}/{leaf}")


def test_weight_round_trip_through_convert():
    cfg = ModelConfig(name="TCResNet8")
    seeded = seeded_variables(cfg, SHAPE, seed=8)
    back = variables_to_jax(cfg, variables_from_jax(cfg, **seeded))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(seeded)):
        np.testing.assert_array_equal(a, b)


def test_dropout_keeps_the_expected_fraction():
    x = torch.ones(400, 500)
    gen = torch.Generator().manual_seed(0)
    y = layers.dropout(x, 0.3, True, gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.3) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.3))
    assert torch.equal(layers.dropout(x, 0.3, True, gen.manual_seed(0)), y)
    assert layers.dropout(x, 0.3, False, gen) is x
    assert layers.dropout(x, 1.0, True, gen) is x


def test_bf16_compute_keeps_f32_params():
    cfg = ModelConfig(name="TCResNet8", num_classes=5)
    model = build_model(cfg, SHAPE, "bfloat16", device="cpu").train()
    feats = torch.tensor(np.random.default_rng(0).standard_normal((6,) + SHAPE), dtype=torch.float32)
    logits = model(feats, generator=torch.Generator().manual_seed(0))
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    logits.sum().backward()
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        build_model(cfg, SHAPE, "float16", device="cpu")


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_loss_and_l2_match_jax(smoothing):
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((9, 12)).astype(np.float32)
    labels = rng.integers(0, 12, 9)
    onehot = np.eye(12, dtype=np.float32)[labels]
    want = jloss.smoothed_softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(onehot), smoothing)
    got = loss.smoothed_softmax_cross_entropy(torch.tensor(logits), torch.tensor(onehot), smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    tc8 = ModelConfig(name="TCResNet8")
    seeded = seeded_variables(tc8, SHAPE, seed=2)
    want = jloss.l2_regularization(_jnp(seeded["params"]), 1e-3)
    got = loss.l2_regularization(variables_from_jax(tc8, **seeded)["params"], 1e-3)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert loss.is_batch_norm_name("conv0_bn.weight")
    assert not loss.is_batch_norm_name("conv0_conv.weight")


@pytest.mark.parametrize("name", ["mom", "gd"])
def test_optimizer_matches_optax(name):
    """Five steps, the same grads: unit-LR update, schedule scaling, EMA."""
    ocfg = OptimConfig(optimizer=name, momentum=0.9, lr_list=(0.1, 0.01, 0.001),
                       boundaries=(2, 3))
    tx, jsched = joptim.build_optimizer(to_jax_config(ocfg))
    opt, sched = optim.build_optimizer(ocfg)
    rng = np.random.default_rng(7)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    jp, jstate, jema = _jnp(p0), tx.init(_jnp(p0)), _jnp(p0)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    tstate, tema = opt.init(tp), {k: v.clone() for k, v in tp.items()}
    for step in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
        updates, jstate = tx.update(_jnp(g), jstate, jp)
        updates = joptim.scale_updates(updates, jsched(step))
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        jema = joptim.ema_update(jema, jp, 0.9)
        assert sched(step) == pytest.approx(float(jsched(step)))
        upd, tstate = opt.update({k: torch.tensor(v) for k, v in g.items()}, tstate)
        upd = optim.scale_updates(upd, sched(step))
        tp = {k: tp[k] + upd[k] for k in tp}
        tema = optim.ema_update(tema, tp, 0.9)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(tema[k].numpy(), np.asarray(jema[k]), rtol=1e-6, atol=1e-7)
    assert optim.resolve_boundaries(
        OptimConfig(boundaries=(3,), boundaries_epoch=True), 1000, 64) == (46,)
    # adam and rmsprop: tests/test_torch_train2d.py; trainable_scopes needs
    # the params for its mask, as in the JAX package
    # (tests/test_torch_trainable_scopes.py)
    with pytest.raises(ValueError, match="requires params"):
        optim.build_optimizer(OptimConfig(optimizer="adam", trainable_scopes=("fc",)))


# ---------------------------------------------------------------------------
# three whole steps against a JAX step composed from the JAX package
# ---------------------------------------------------------------------------

N, P, BATCH = 3200, 4096, 8


def _step_cfg(tmp_path, fuse, conv_backend="xla"):
    return ExperimentConfig(
        audio=AudioConfig(clip_duration_ms=200, num_mel_bins=32, num_mfccs=20,
                          dsp_backend="pallas", frontend_fuse=fuse),
        augment=AugmentConfig(background_frequency=0.8, background_max_volume=0.3,
                              backend="pallas"),
        model=ModelConfig(name="TCResNet8", num_classes=4, dropout_keep_prob=1.0,
                          label_smoothing=0.1, conv_backend=conv_backend),
        optim=OptimConfig(optimizer="mom", lr_list=(0.1, 0.05), boundaries=(1,)),
        train=TrainConfig(batch_size=BATCH, train_dir=str(tmp_path)),
    )


@pytest.mark.parametrize("fuse,conv_backend", [
    pytest.param("off", "xla", id="off"), pytest.param("on", "xla", id="on"),
    pytest.param("off", "pallas", id="off-pallas")])
def test_three_steps_match_a_jax_step(tmp_path, monkeypatch, fuse, conv_backend):
    """The port's Trainer step with injected indices and augmentation
    scalars (dropout off) against decode_rows -> the JAX gather+augment
    kernel (interpret) -> dsp.preprocess -> model.apply -> loss ->
    tx.update -> scale_updates: losses within 1e-5. "off" runs K1 then K2
    (their plain versions here), "on" K3's; conv_backend "pallas" runs
    every conv through K7's plain version, against JAX "pallas-interpret"."""
    cfg = _step_cfg(tmp_path, fuse, conv_backend)
    host = make_synthetic_dataset(num_samples=40, num_classes=4, desired_samples=N, seed=6)
    draws = step_draws(3, BATCH)

    ds = DeviceDataset(host, "cpu")
    trainer = Trainer(cfg, ds, workdir=tmp_path)
    init = variables_to_jax(cfg.model, {"params": trainer.state.params,
                             "batch_stats": trainer.state.batch_stats})
    calls = {"n": 0}

    def fake_indices(arrays, generator, batch_size, sample_row=None):
        idx = torch.tensor(draws[calls["n"]]["idx"])
        return idx, arrays[1][idx.long()], arrays[2][idx.long()]

    def fake_scalars(generator, is_silent, aug_cfg, noise_bank, n, is_training):
        d = draws[calls["n"]]
        calls["n"] += 1
        keeps = torch.where(is_silent, 0.0, 1.0).to(torch.float32)
        return AugmentScalars(*(torch.tensor(a) for a in d["scalars"]), keeps)

    monkeypatch.setattr(DeviceDataset, "sample_indices", staticmethod(fake_indices))
    monkeypatch.setattr(aug, "draw_scalars", fake_scalars)
    got = [float(trainer.train_steps(1)["total_loss"]) for _ in range(3)]
    assert calls["n"] == 3 and int(trainer.state.step) == 3

    want = jax_step_losses(cfg, host, draws, init)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert want[2] != want[0]


def step_draws(n_steps: int, batch: int, seed: int = 8) -> list:
    """Injected draws of `n_steps` steps: batch indices into a 40-row
    dataset and the augmentation scalars (shift, clip, offset, volume)."""
    rng = np.random.default_rng(seed)
    draws = []
    for _ in range(n_steps):
        draws.append(dict(
            idx=rng.integers(0, 40, batch).astype(np.int32),
            scalars=(rng.integers(-320, 320, batch).astype(np.int32),
                     rng.integers(0, 4, batch).astype(np.int32),
                     rng.integers(0, 2 * N - N + 1, batch).astype(np.int32),
                     np.where(rng.uniform(size=batch) < 0.8,
                              rng.uniform(0, 0.3, batch), 0).astype(np.float32))))
    return draws


def jax_step_losses(cfg, host, draws, init, conv_backend=None) -> list:
    """The total loss of each JAX step composed from the JAX package with
    the injected `draws`, from the Flax variables `init`: decode_rows ->
    the JAX gather+augment kernel (interpret) -> dsp.preprocess ->
    model.apply -> loss -> tx.update -> scale_updates. The convs are the
    config's (`conv_backend` names another)."""
    conv_backend = conv_backend or cfg.model.conv_backend
    jconv = "pallas-interpret" if conv_backend == "pallas" else conv_backend
    jmodel = jax_build_model(to_jax_config(dataclasses.replace(cfg.model, conv_backend=jconv)),
                             jdsp.feature_shape(to_jax_config(cfg.audio)))
    tx, sched = joptim.build_optimizer(to_jax_config(cfg.optim))
    params, stats = _jnp(init["params"]), _jnp(init["batch_stats"])
    opt_state = tx.init(params)
    padded = np.zeros((40, P), np.int16)
    padded[:, :N] = host.wavs
    wavs3d = jnp.asarray(padded.reshape(40, P // 128, 128))
    noise = jnp.asarray(host.noise_bank)
    want = []
    for step, d in enumerate(draws):
        idx = jnp.asarray(d["idx"])
        keeps = jnp.where(jnp.asarray(host.is_silent)[idx], 0.0, 1.0)
        scalars = tuple(jnp.asarray(a) for a in d["scalars"]) + (keeps,)
        wavs = _fused_gather_augment_impl(wavs3d, idx, scalars, noise, N, True)
        feats = jdsp.preprocess(wavs, to_jax_config(dataclasses.replace(cfg.audio, dsp_backend="xla")))
        onehot = jax.nn.one_hot(jnp.asarray(host.labels)[idx], 4)

        def loss_fn(p):
            logits, mutated = jmodel.apply({"params": p, "batch_stats": stats}, feats,
                                           training=True, mutable=["batch_stats"])
            total = (jloss.smoothed_softmax_cross_entropy(logits, onehot, 0.1)
                     + jloss.l2_regularization(p, cfg.model.weight_decay))
            return total, mutated["batch_stats"]

        (total, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        updates = joptim.scale_updates(updates, sched(step))
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        want.append(float(total))
    return want
