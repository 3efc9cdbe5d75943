"""trainable_scopes and the relative LR shift of the port against the JAX
package: the mask over every family's params, frozen tensors after steps
of mom and adam (and the trained ones against a JAX step with the same
draws), and the shifted schedule over a grid of restore steps.

`port_steps` and `jax_steps` are shared with tests/test_torch_warm_start.py:
the port's Trainer step with injected indices and augmentation scalars,
and the same step composed from the JAX package (the step of
tests/test_torch_train.py::test_three_steps_match_a_jax_step)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu.models import build_model as jax_build_model
from tcresnet_tpu.ops import dsp as jdsp
from tcresnet_tpu.ops.pallas.augment import _fused_gather_augment_impl
from tcresnet_tpu.train import loss as jloss
from tcresnet_tpu.train import optim as joptim
from tcresnet_tpu_torch import config as tconfig
from tcresnet_tpu_torch.config import AudioConfig, AugmentConfig, ExperimentConfig, ModelConfig
from tcresnet_tpu_torch.config import OptimConfig, TrainConfig
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset
from tcresnet_tpu_torch.models.convert import jax_path, seeded_variables, variables_from_jax
from tcresnet_tpu_torch.models.convert import variables_to_jax
from tcresnet_tpu_torch.ops import augment as aug
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.ops.kernels.augment import AugmentScalars
from tcresnet_tpu_torch.train import optim
from tcresnet_tpu_torch.train.trainer import Trainer
from tests.test_torch_config import to_jax_config

torch.set_num_threads(1)

N, P, BATCH, ROWS = 3200, 4096, 8, 40


def step_cfg(tmp_path, optim_cfg, name="TCResNet8", width=1.0):
    return ExperimentConfig(
        audio=AudioConfig(clip_duration_ms=200, num_mel_bins=32, num_mfccs=20,
                          dsp_backend="pallas", frontend_fuse="off"),
        augment=AugmentConfig(background_frequency=0.8, background_max_volume=0.3,
                              backend="pallas"),
        model=ModelConfig(name=name, width_multiplier=width, num_classes=4,
                          dropout_keep_prob=1.0, label_smoothing=0.1),
        optim=optim_cfg,
        train=TrainConfig(batch_size=BATCH, train_dir=str(tmp_path)),
    )


@functools.lru_cache(maxsize=None)
def host_data():
    return make_synthetic_dataset(num_samples=ROWS, num_classes=4, desired_samples=N, seed=6)


def draws(seed, steps):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        out.append(dict(
            idx=rng.integers(0, ROWS, BATCH).astype(np.int32),
            scalars=(rng.integers(-320, 320, BATCH).astype(np.int32),
                     rng.integers(0, 4, BATCH).astype(np.int32),
                     rng.integers(0, N + 1, BATCH).astype(np.int32),
                     np.where(rng.uniform(size=BATCH) < 0.8,
                              rng.uniform(0, 0.3, BATCH), 0).astype(np.float32))))
    return out


def port_steps(trainer, steps, monkeypatch):
    """The trainer's steps from its state's step, with `steps`' draws."""
    calls = {"n": 0}

    def fake_indices(arrays, generator, batch_size, sample_row=None):
        idx = torch.tensor(steps[calls["n"]]["idx"])
        return idx, arrays[1][idx.long()], arrays[2][idx.long()]

    def fake_scalars(generator, is_silent, aug_cfg, noise_bank, n, is_training):
        d = steps[calls["n"]]
        calls["n"] += 1
        keeps = torch.where(is_silent, 0.0, 1.0).to(torch.float32)
        return AugmentScalars(*(torch.tensor(a) for a in d["scalars"]), keeps)

    with monkeypatch.context() as m:
        m.setattr(DeviceDataset, "sample_indices", staticmethod(fake_indices))
        m.setattr(aug, "draw_scalars", fake_scalars)
        losses = [float(trainer.train_steps(1)["total_loss"]) for _ in steps]
    assert calls["n"] == len(steps)
    return losses


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def jax_steps(cfg, variables, steps, start=0):
    """The same steps composed from the JAX package: decode -> the JAX
    gather+augment kernel (interpret) -> dsp.preprocess -> model.apply ->
    loss -> tx.update (with its trainable_scopes mask) -> scale_updates.
    Returns (losses, params, batch_stats) as numpy."""
    host = host_data()
    jmodel = jax_build_model(to_jax_config(cfg.model), jdsp.feature_shape(to_jax_config(cfg.audio)))
    params, stats = _jnp(variables["params"]), _jnp(variables["batch_stats"])
    tx, sched = joptim.build_optimizer(to_jax_config(cfg.optim), params=params)
    opt_state = tx.init(params)
    padded = np.zeros((ROWS, P), np.int16)
    padded[:, :N] = host.wavs
    wavs3d = jnp.asarray(padded.reshape(ROWS, P // 128, 128))
    noise = jnp.asarray(host.noise_bank)
    audio = to_jax_config(dataclasses.replace(cfg.audio, dsp_backend="xla"))
    losses = []
    for step, d in enumerate(steps, start):
        idx = jnp.asarray(d["idx"])
        keeps = jnp.where(jnp.asarray(host.is_silent)[idx], 0.0, 1.0)
        scalars = tuple(jnp.asarray(a) for a in d["scalars"]) + (keeps,)
        feats = jdsp.preprocess(_fused_gather_augment_impl(wavs3d, idx, scalars, noise, N, True),
                                audio)
        onehot = jax.nn.one_hot(jnp.asarray(host.labels)[idx], 4)

        def loss_fn(p, stats=stats, feats=feats, onehot=onehot):
            logits, mutated = jmodel.apply({"params": p, "batch_stats": stats}, feats,
                                           training=True, mutable=["batch_stats"])
            total = (jloss.smoothed_softmax_cross_entropy(logits, onehot, 0.1)
                     + jloss.l2_regularization(p, cfg.model.weight_decay))
            return total, mutated["batch_stats"]

        (total, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        updates = joptim.scale_updates(updates, sched(step))
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        losses.append(float(total))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return losses, to_np(params), to_np(stats)


def flat(tree):
    """{'/'-joined path: leaf} of a nested dict."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", k)) for k in path)] = leaf
    return out


def port_as_jax(cfg, state):
    return variables_to_jax(cfg.model, {"params": state.params, "batch_stats": state.batch_stats})


SCOPES = [("fc",), ("conv0",), ("block1", "fc"), ("conv0_conv/kernel",), (r".*_bn",),
          (r"block\d+_conv0",), ("fc/bias",), ("weights_",), ("conv_ds_1",), ("lin",),
          ("f_conv",), ("conv1",), ("nothing",)]


@pytest.mark.parametrize("preset", sorted(tconfig.PRESETS))
def test_mask_selects_what_jax_selects(preset):
    cfg = tconfig.get_preset(preset)
    seeded = seeded_variables(cfg.model, dsp.feature_shape(cfg.audio), seed=1)
    params = variables_from_jax(cfg.model, **seeded)["params"]
    path_of = functools.partial(jax_path, cfg.model.name)
    assert sorted(map(path_of, params)) == sorted(flat(seeded["params"]))
    for scopes in SCOPES:
        want = flat(joptim.trainable_mask(seeded["params"], scopes))
        got = optim.trainable_mask(params, scopes, path_of)
        assert {path_of(k): v for k, v in got.items()} == want, (preset, scopes)


def test_mask_is_prefix_anchored():
    params = {"fc/kernel": 0, "block3/fc_proj/kernel": 0}
    assert optim.trainable_mask(params, ["fc"]) == {"fc/kernel": True,
                                                     "block3/fc_proj/kernel": False}
    with pytest.raises(ValueError, match="requires params"):
        optim.build_optimizer(OptimConfig(trainable_scopes=("fc",)))


@pytest.mark.parametrize("scopes", [("fc",), ("block1", "fc")], ids=["fc", "block1+fc"])
@pytest.mark.parametrize("name", ["mom", "adam"])
def test_frozen_tensors_stay_and_trained_ones_match_jax(tmp_path, monkeypatch, name, scopes):
    ocfg = OptimConfig(optimizer=name, lr_list=(0.05 if name == "mom" else 0.01, 0.02),
                       boundaries=(1,), trainable_scopes=scopes)
    cfg = step_cfg(tmp_path, ocfg)
    trainer = Trainer(cfg, DeviceDataset(host_data(), "cpu"), workdir=tmp_path)
    init = port_as_jax(cfg, trainer.state)
    path_of = functools.partial(jax_path, cfg.model.name)
    # frozen tensors keep no optimizer state (optax's set_to_zero keeps none)
    moments = {k.rpartition("/")[2] if "/" in k else k for k in trainer.state.opt_state} - {
        "count"}
    assert moments == {k for k in trainer.state.params
                       if any(path_of(k).startswith(s) for s in scopes)}
    steps = draws(8, 3)
    got = port_steps(trainer, steps, monkeypatch)
    want, jparams, _ = jax_steps(cfg, init, steps)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    after, before = flat(port_as_jax(cfg, trainer.state)["params"]), flat(init["params"])
    jflat, mask = flat(jparams), flat(joptim.trainable_mask(init["params"], scopes))
    assert any(mask.values()) and not all(mask.values())
    for path, trained in mask.items():
        if trained:
            assert not np.array_equal(after[path], before[path]), path
            np.testing.assert_allclose(after[path], jflat[path], rtol=0, atol=1e-5,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(after[path], before[path], err_msg=path)
            np.testing.assert_array_equal(jflat[path], before[path], err_msg=path)


@pytest.mark.parametrize("epoch_units", [False, True], ids=["steps", "epochs"])
def test_relative_schedule_equals_jax(tmp_path, epoch_units):
    ocfg = OptimConfig(lr_list=(0.1, 0.01, 0.001), boundaries=(2, 5),
                       boundaries_epoch=epoch_units, relative_schedule=True)
    cfg = step_cfg(tmp_path, ocfg)
    trainer = Trainer(cfg, DeviceDataset(host_data(), "cpu"), workdir=tmp_path)
    jcfg = to_jax_config(ocfg)
    grid = range(0, 60, 3)
    for restore in (0, 1, 4, 7, 13, 25):
        trainer._apply_relative_schedule(restore)
        bounds = joptim.resolve_boundaries(jcfg, ROWS, BATCH, restore_step=restore,
                                           relative=True)
        assert optim.resolve_boundaries(ocfg, ROWS, BATCH, restore, True) == bounds
        sched = joptim.piecewise_constant(bounds, jcfg.lr_list)
        assert [trainer.lr_schedule(s) for s in grid] == pytest.approx(
            [float(sched(s)) for s in grid], rel=1e-7)


def test_relative_resume_draws_what_an_uninterrupted_run_draws(tmp_path):
    """Draws are a function of (seed, step): a run resumed at step 2 under
    relative_schedule (its boundary shifted past the steps run) takes the
    same batches, and so the same steps, as an uninterrupted run."""
    ocfg = OptimConfig(lr_list=(0.05, 0.01), boundaries=(100,), relative_schedule=True)
    straight = Trainer(step_cfg(tmp_path / "a", ocfg), DeviceDataset(host_data(), "cpu"),
                       workdir=tmp_path / "a")
    want = [float(straight.train_steps(1)["total_loss"]) for _ in range(4)]
    first = Trainer(step_cfg(tmp_path / "b", ocfg), DeviceDataset(host_data(), "cpu"),
                    workdir=tmp_path / "b")
    got = [float(first.train_steps(1)["total_loss"]) for _ in range(2)]
    first.ckpt.save(2, first.state)
    resumed = Trainer(step_cfg(tmp_path / "b", ocfg), DeviceDataset(host_data(), "cpu"),
                      workdir=tmp_path / "b")
    assert resumed.maybe_restore() == 2 and resumed.lr_schedule(101) == 0.05
    got += [float(resumed.train_steps(1)["total_loss"]) for _ in range(2)]
    assert got == want
