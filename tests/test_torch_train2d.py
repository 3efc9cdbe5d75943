"""Training the 2D families (TCResNet2D8[Pool], Res, DS-CNN, KWS) in the
port against the JAX package: train-mode forward and backward against
Flax, adam and rmsprop against optax, three whole Trainer steps against a
JAX step (with the phase-grouped and radix-4 front ends), and an exact
resume of adam's state through a checkpoint.

Dropout draws differ between the frameworks, so where a model drops
(TCResNet2D8's pooled vector, every KWS architecture but single_fc) the
test gives both sides the same masks: the i-th dropout call of either
side gets mask i, made with numpy in the JAX layout (NHWC; the port's
NCHW activations take it transposed). The JAX package's `layers.dropout`
is replaced for the test only, at run time."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu.models import build_model as jax_build_model
from tcresnet_tpu.models import layers as jlayers
from tcresnet_tpu.ops import dsp as jdsp
from tcresnet_tpu.ops.pallas.augment import _fused_gather_augment_impl
from tcresnet_tpu.train import loss as jloss
from tcresnet_tpu.train import optim as joptim
from tcresnet_tpu_torch.config import AudioConfig, AugmentConfig, ExperimentConfig, ModelConfig
from tcresnet_tpu_torch.config import OptimConfig, TrainConfig
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset
from tcresnet_tpu_torch.models import build_model
from tcresnet_tpu_torch.models import layers as tlayers
from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
from tcresnet_tpu_torch.models.convert import variables_to_jax
from tcresnet_tpu_torch.models.kws import KWS_ARCHITECTURES
from tcresnet_tpu_torch.ops import augment as aug
from tcresnet_tpu_torch.ops.kernels import frontend, mfcc
from tcresnet_tpu_torch.ops.kernels.augment import AugmentScalars, augment_reference
from tcresnet_tpu_torch.train import loss, optim
from tcresnet_tpu_torch.train.checkpoint import CheckpointManager
from tcresnet_tpu_torch.train.trainer import Trainer
from tests.test_torch_config import to_jax_config

torch.set_num_threads(1)

SMALL = (23, 20, 1)  # 250 ms at 30/10 ms, MFCC-20
KWS_SHAPE = (49, 40, 1)  # KWSfpool3's geometry (trad_fpool3 needs >= 29 frames)
TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_train.py's

CNN = ["Res8", "Res15Narrow", "DSCNNS", "ResNet2D8", "ResNet2D8Pool"]
CASES = [(n, "conv", SMALL) for n in CNN] + [("KWS", a, KWS_SHAPE) for a in KWS_ARCHITECTURES]
IDS = CNN + [f"KWS-{a}" for a in KWS_ARCHITECTURES]


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


class SharedMasks:
    """The same dropout masks on both sides, by call order."""

    def __init__(self, seed: int):
        self.seed = seed
        self.jax_calls = self.port_calls = 0

    def _mask(self, i, shape, keep_prob):
        return np.random.default_rng([self.seed, i]).uniform(size=shape) < keep_prob

    def jax_dropout(self, x, *, keep_prob, training, name=None):
        if not training or keep_prob >= 1.0:
            return x
        mask = self._mask(self.jax_calls, x.shape, keep_prob)
        self.jax_calls += 1
        return jnp.where(mask, x / keep_prob, jnp.zeros_like(x))

    def port_dropout(self, x, keep_prob, training, generator=None):
        if not training or keep_prob >= 1.0:
            return x
        nhwc = (x.shape[0], *x.shape[2:], x.shape[1]) if x.dim() == 4 else tuple(x.shape)
        mask = torch.tensor(self._mask(self.port_calls, nhwc, keep_prob))
        self.port_calls += 1
        if x.dim() == 4:
            mask = mask.permute(0, 3, 1, 2)
        return torch.where(mask, x / keep_prob, torch.zeros_like(x))

    def install(self, monkeypatch):
        monkeypatch.setattr(jlayers, "dropout", self.jax_dropout)
        monkeypatch.setattr(tlayers, "dropout", self.port_dropout)
        return self


@pytest.mark.parametrize("name,arch,shape", CASES, ids=IDS)
def test_train_mode_logits_stats_and_grads_match_flax(monkeypatch, name, arch, shape):
    """Batch statistics in every BN (Res's stat-only, DS-CNN's shift-only
    at momentum 0.96), TCResNet2D8's and KWS's dropout with shared masks:
    logits, updated BN statistics and every gradient against Flax."""
    masks = SharedMasks(11).install(monkeypatch)
    cfg = ModelConfig(name=name, kws_architecture=arch, num_classes=7)
    seeded = seeded_variables(cfg, shape, seed=3)
    feats = np.random.default_rng(4).standard_normal((5,) + shape).astype(np.float32)
    weights = np.random.default_rng(5).standard_normal((5, 7)).astype(np.float32)

    jmodel = jax_build_model(to_jax_config(cfg), shape)

    def jloss_fn(params):
        logits, mutated = jmodel.apply(
            {"params": params, "batch_stats": _jnp(seeded["batch_stats"])},
            jnp.asarray(feats), training=True, mutable=["batch_stats"])
        return jnp.mean(logits * weights), (logits, mutated.get("batch_stats", {}))

    (_, (jlogits, jstats)), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
        _jnp(seeded["params"]))

    model = build_model(cfg, shape, device="cpu").train()
    v = variables_from_jax(cfg, **seeded)
    model.load_state_dict({**v["params"], **v["batch_stats"]})
    logits = model(torch.tensor(feats))
    (logits * torch.tensor(weights)).mean().backward()
    assert masks.port_calls == masks.jax_calls
    assert (masks.jax_calls > 0) == (name.startswith("ResNet2D8")
                                     or (name == "KWS" and arch != "single_fc"))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **TOL)
    back = variables_to_jax(cfg, {
        "params": {k: p.grad for k, p in model.named_parameters()},
        "batch_stats": dict(model.named_buffers())})
    jstats = jax.tree_util.tree_map(np.asarray, jstats)
    assert set(jstats) == set(back["batch_stats"])
    for scope, leaves in jstats.items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(back["batch_stats"][scope][leaf], want, **TOL)
    for scope, leaves in jax.tree_util.tree_map(np.asarray, jgrads).items():
        if not isinstance(leaves, dict):  # SVDF's top-level weights
            leaves, back["params"][scope] = {"": leaves}, {"": back["params"][scope]}
        for leaf, want in leaves.items():
            np.testing.assert_allclose(back["params"][scope][leaf], want, **TOL,
                                       err_msg=f"{scope}/{leaf}")


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("center,scale", [(False, False), (True, False), (True, True)])
def test_batch_norm_of_a_dead_channel_matches_flax(center, scale, relu):
    """A channel that is all zeros (a dead ReLU, common in Res's BN after
    the ReLU at initialisation) has variance E[x^2] - E[x]^2 = 0 exactly,
    at the clip's kink: the gradient through it is jnp.maximum's. With
    `relu` the batch norm's own ReLU (DS-CNN, TC-ResNet) against Flax's
    BatchNorm then nn.relu, with a shift of 0.5 where the layer has one, so
    that the ReLU passes the dead channel's outputs (without a shift they
    are 0 and pass no gradient, on both sides)."""
    import flax.linen as nn

    x = np.maximum(np.random.default_rng(6).standard_normal((4, 5, 3, 6)), 0).astype(np.float32)
    x[..., 2] = 0.0
    x[..., 4] = 0.0
    x[0, 1, 1, 4] = 0.25  # and one channel with a single non-zero value
    w = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-3,
                      use_bias=center, use_scale=scale)
    variables = bn.init(jax.random.key(0), jnp.asarray(x))
    shift = 0.5 if relu else 0.0
    if center:
        variables = {**variables, "params": {**variables["params"],
                                             "bias": jnp.full((6,), shift, jnp.float32)}}

    def jfn(xx):
        y, _ = bn.apply(variables, xx, mutable=["batch_stats"])
        return jnp.sum((nn.relu(y) if relu else y) * w)

    want = np.asarray(jax.grad(jfn)(jnp.asarray(x)))
    port = tlayers.SlimBatchNorm(6, momentum=0.9, center=center, scale=scale).train()
    if center:
        with torch.no_grad():
            port.bias.fill_(shift)
    xt = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_(True)
    (port(xt, relu=relu) * torch.tensor(w).permute(0, 3, 1, 2)).sum().backward()
    got = xt.grad.permute(0, 2, 3, 1).numpy()
    if center or not relu:
        assert np.abs(want[..., 2]).max() > 0  # the kink's half-gradient, not zero
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name,arch,shape", CASES, ids=IDS)
def test_l2_excludes_every_familys_batch_norm(name, arch, shape):
    """The L2 term skips exactly the BN parameters, by the JAX package's
    name rule, for every family: DS-CNN's shifts and TCResNet2D8's scales
    and shifts (Res's BN has no parameters)."""
    cfg = ModelConfig(name=name, kws_architecture=arch)
    seeded = seeded_variables(cfg, shape, seed=2)
    params = variables_from_jax(cfg, **seeded)["params"]
    want = jloss.l2_regularization(_jnp(seeded["params"]), 1e-3)
    got = loss.l2_regularization(params, 1e-3)
    # a float32 sum over up to ~2e5 squares, in another order
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k in params:
        assert loss.is_batch_norm_name(k) == ("_bn." in k), k


@pytest.mark.parametrize("name", ["adam", "rmsprop"])
def test_adam_and_rmsprop_match_optax(name):
    """Six steps, the same grads: unit-LR update in optax's order and
    initial state, schedule scaling across a boundary, EMA."""
    ocfg = OptimConfig(optimizer=name, lr_list=(0.1, 0.01, 0.001), boundaries=(2, 4),
                       adam_epsilon=1e-7, rmsprop_decay=0.8, rmsprop_epsilon=1e-6)
    tx, jsched = joptim.build_optimizer(to_jax_config(ocfg))
    opt, sched = optim.build_optimizer(ocfg)
    rng = np.random.default_rng(7)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    jp, jstate, jema = _jnp(p0), tx.init(_jnp(p0)), _jnp(p0)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    tstate, tema = opt.init(tp), {k: v.clone() for k, v in tp.items()}
    for step in range(6):
        g = {k: (rng.standard_normal(v.shape) * 10 ** (step % 3 - 1)).astype(np.float32)
             for k, v in p0.items()}
        updates, jstate = tx.update(_jnp(g), jstate, jp)
        updates = joptim.scale_updates(updates, jsched(step))
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        jema = joptim.ema_update(jema, jp, 0.9)
        upd, tstate = opt.update({k: torch.tensor(v) for k, v in g.items()}, tstate)
        upd = optim.scale_updates(upd, sched(step))
        tp = {k: tp[k] + upd[k] for k in tp}
        tema = optim.ema_update(tema, tp, 0.9)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(tema[k].numpy(), np.asarray(jema[k]), rtol=1e-6, atol=1e-7)
    if name == "adam":
        assert int(tstate["count"]) == 6 and tstate["count"].dtype == torch.int32
        for k in p0:
            np.testing.assert_allclose(tstate[f"mu/{k}"].numpy(), np.asarray(jstate[0].mu[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(tstate[f"nu/{k}"].numpy(), np.asarray(jstate[0].nu[k]),
                                       rtol=1e-6, atol=1e-7)
    # trainable_scopes: only the matching params keep state and get updates
    # (against optax's multi_transform: tests/test_torch_trainable_scopes.py)
    frozen, _ = optim.build_optimizer(dataclasses.replace(ocfg, trainable_scopes=("a",)),
                                      params=p0)
    fstate = frozen.init({k: torch.tensor(v) for k, v in p0.items()})
    assert {k.rpartition("/")[2] for k in fstate if k != "count"} == {"a"}
    upd, _ = frozen.update({k: torch.tensor(v) for k, v in p0.items()}, fstate)
    assert set(upd) == {"a"}


# ---------------------------------------------------------------------------
# three whole steps against a JAX step composed from the JAX package
# ---------------------------------------------------------------------------

N, P, BATCH = 3200, 4096, 8  # 200 ms: a multiple of 128, 160, 320 and 640


def _step_cfg(tmp_path, name, arch, variant, fuse, window_ms, hop_ms, optimizer="adam",
              method="mfcc"):
    return ExperimentConfig(
        audio=AudioConfig(clip_duration_ms=200, num_mel_bins=32, num_mfccs=10 if
                          name.startswith("DSCNN") else 20, preprocess_method=method,
                          window_size_ms=window_ms,
                          window_stride_ms=hop_ms, dsp_backend="pallas", frontend_fuse=fuse,
                          dft_variant=variant),
        augment=AugmentConfig(background_frequency=0.8, background_max_volume=0.3,
                              backend="pallas"),
        model=ModelConfig(name=name, kws_architecture=arch, num_classes=4,
                          label_smoothing=0.1, weight_decay=1e-3),
        optim=OptimConfig(optimizer=optimizer, lr_list=(1e-3, 5e-4), boundaries=(1,)),
        train=TrainConfig(batch_size=BATCH, train_dir=str(tmp_path)),
    )


# Res8 steps on log-mel features with SGD-momentum. On MFCC features
# (c0 near 50, so post-ReLU activations whose mean dwarfs their spread)
# JAX's float32 gradients of Res8's block 0 are 1e-3 off (relative) from
# float64, while the port's are within 1e-7 and JAX's own float64 agrees
# with the port's to 2e-8: E[x^2] - E[x]^2 cancels, and XLA:CPU's float32
# sums are the less accurate. adam's normalised update turns such an error
# on a near-zero gradient into a full-size step, so that comparison would
# measure JAX's rounding, not the port.
STEP_CASES = [
    pytest.param("DSCNNS", "conv", "radix4", "on", 40.0, 20.0, "adam", "mfcc",
                 id="DSCNNS-radix4-on"),
    pytest.param("Res8", "conv", "phases", "off", 30.0, 10.0, "mom", "log_mel_spectrogram",
                 id="Res8-phases-off"),
    pytest.param("KWS", "conv", "hops", "off", 30.0, 10.0, "adam", "mfcc",
                 id="KWS-conv-dropout"),
]


def _step_draws(rows=40, steps=3):
    """Each step's indices and augmentation scalars, made with numpy."""
    rng = np.random.default_rng(8)
    draws = []
    for _ in range(steps):
        draws.append(dict(
            idx=rng.integers(0, rows, BATCH).astype(np.int32),
            scalars=(rng.integers(-320, 320, BATCH).astype(np.int32),
                     rng.integers(0, 4, BATCH).astype(np.int32),
                     rng.integers(0, N + 1, BATCH).astype(np.int32),
                     np.where(rng.uniform(size=BATCH) < 0.8,
                              rng.uniform(0, 0.3, BATCH), 0).astype(np.float32))))
    return draws


def _port_losses(tmp_path, monkeypatch, cfg, host, draws):
    """(the JAX-layout initial variables, the port Trainer's step losses)
    with the draws injected."""
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
    k3_before = (frontend.phases_launches, frontend.radix4_launches)
    got = [float(trainer.train_steps(1)["total_loss"]) for _ in range(len(draws))]
    assert calls["n"] == len(draws) and int(trainer.state.step) == len(draws)
    assert (frontend.phases_launches, frontend.radix4_launches) == k3_before  # CPU: plain
    if cfg.optim.optimizer == "adam":
        assert int(trainer.state.opt_state["count"]) == len(draws)
    return init, got


def _jax_features(cfg, host, draws):
    """Each step's (features, labels) through the JAX package's front end:
    decode_rows -> its gather+augment kernel (interpret) -> dsp.preprocess."""
    rows = host.wavs.shape[0]
    padded = np.zeros((rows, P), np.int16)
    padded[:, :N] = host.wavs
    wavs3d = jnp.asarray(padded.reshape(rows, P // 128, 128))
    noise = jnp.asarray(host.noise_bank)
    xla_audio = to_jax_config(dataclasses.replace(cfg.audio, dsp_backend="xla"))
    out = []
    for d in draws:
        idx = jnp.asarray(d["idx"])
        keeps = jnp.where(jnp.asarray(host.is_silent)[idx], 0.0, 1.0)
        scalars = tuple(jnp.asarray(a) for a in d["scalars"]) + (keeps,)
        wavs = _fused_gather_augment_impl(wavs3d, idx, scalars, noise, N, True)
        out.append((np.asarray(jdsp.preprocess(wavs, xla_audio)), host.labels[d["idx"]]))
    return out


def _jax_losses(cfg, init, batches, dtype=jnp.float32):
    """The JAX step composed from the JAX package from the same variables:
    model.apply(training=True) -> loss -> optax -> scale_updates over the
    (features, labels) batches, in `dtype` (float64 needs jax_enable_x64)."""
    jmodel = jax_build_model(to_jax_config(cfg.model),
                             jdsp.feature_shape(to_jax_config(cfg.audio)))
    tx, sched = joptim.build_optimizer(to_jax_config(cfg.optim))
    cast = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)  # noqa: E731
    params, stats = cast(init["params"]), cast(init["batch_stats"])
    opt_state = tx.init(params)
    want = []
    for step, (feats, labels) in enumerate(batches):
        feats = jnp.asarray(feats, dtype)
        onehot = jax.nn.one_hot(jnp.asarray(labels), cfg.model.num_classes, dtype=dtype)

        def loss_fn(p):
            logits, mutated = jmodel.apply({"params": p, "batch_stats": stats}, feats,
                                           training=True, mutable=["batch_stats"])
            total = (jloss.smoothed_softmax_cross_entropy(logits, onehot, 0.1)
                     + jloss.l2_regularization(p, cfg.model.weight_decay))
            return total, mutated.get("batch_stats", {})

        (total, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        updates = joptim.scale_updates(updates, sched(step))
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        want.append(float(total))
    return want


@pytest.mark.parametrize("name,arch,variant,fuse,window_ms,hop_ms,optimizer,method",
                         STEP_CASES)
def test_three_steps_match_a_jax_step(tmp_path, monkeypatch, name, arch, variant, fuse,
                                      window_ms, hop_ms, optimizer, method):
    """The port's Trainer step with injected indices, augmentation scalars
    and dropout masks against decode_rows -> the JAX gather+augment kernel
    (interpret) -> dsp.preprocess (the radix-4 XLA path for "radix4"; the
    dense one, whose math "phases" reorders) -> model.apply(training=True)
    -> loss -> optax -> scale_updates: losses within 1e-5. "on" runs K3's
    plain version in the config's variant, "off" K1's then the variant's
    MFCC plain version."""
    masks = SharedMasks(21).install(monkeypatch)
    cfg = _step_cfg(tmp_path, name, arch, variant, fuse, window_ms, hop_ms, optimizer, method)
    assert mfcc.resolve_dft_variant(cfg.audio, N) == variant
    host = make_synthetic_dataset(num_samples=40, num_classes=4, desired_samples=N, seed=6)
    draws = _step_draws()
    init, got = _port_losses(tmp_path, monkeypatch, cfg, host, draws)
    want = _jax_losses(cfg, init, _jax_features(cfg, host, draws))
    assert masks.port_calls == masks.jax_calls == (6 if name == "KWS" else 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert want[2] != want[0]


# The Res8 MFCC / adam case held to JAX in float64, in a child process: x64
# is process-wide in JAX, and no other test may see it. Both JAX steps take
# the port's features (K1's then K8's plain version, what the Trainer's
# "off" path ran): the two front ends differ by ~1e-5 on MFCCs up to ~25
# (float32 sums in another order), and adam's normalised update turns that
# into a 4e-5 loss difference by step 2, which is no fault of either step.
# The child reads the features, labels and the port's initial variables
# from a file and prints its losses.
RES8_MFCC_ARGS = ("Res8", "conv", "phases", "off", 30.0, 10.0, "adam", "mfcc")
_X64_CHILD = """
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, sys.argv[1])
from tests import test_torch_train2d as t
data = np.load(sys.argv[2])
init = {"params": {}, "batch_stats": {}}
for key in data.files:
    if key.startswith(("feats", "labels")):
        continue
    node = init
    *path, leaf = key.split("/")
    for part in path:
        node = node.setdefault(part, {})
    node[leaf] = data[key]
batches = [(data[f"feats{i}"], data[f"labels{i}"]) for i in range(3)]
cfg = t._step_cfg(sys.argv[3], *t.RES8_MFCC_ARGS)
losses = t._jax_losses(cfg, init, batches, jnp.float64)
print(json.dumps({"x64": bool(jax.config.jax_enable_x64), "losses": losses}))
"""


def _flatten(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        out.update(_flatten(value, name + "/") if isinstance(value, dict) else {name: value})
    return out


def _port_features(cfg, host, draws):
    """Each step's (features, labels) through the port's plain front end:
    K1's plain version, then the config's MFCC plain version."""
    ds = DeviceDataset(host, "cpu")
    out = []
    for d in draws:
        idx = torch.tensor(d["idx"])
        keeps = torch.where(torch.tensor(host.is_silent)[idx.long()], 0.0, 1.0)
        scalars = AugmentScalars(*(torch.tensor(a) for a in d["scalars"]), keeps)
        wavs = augment_reference(ds.wavs, idx, scalars, ds.noise_bank, N)
        out.append((mfcc.fused_mfcc_reference(wavs, cfg.audio).numpy()[..., None],
                    host.labels[d["idx"]]))
    return out


def test_res8_mfcc_adam_steps_match_jax_in_float64(tmp_path, monkeypatch):
    """Res8 on MFCC features with adam: three port Trainer steps (float32)
    against the JAX step on the same features in float32, within the 1e-5
    gate (measured 5e-7), and in float64 (model, loss and optimizer; x64 in
    a child process), within 2e-5: float32 arithmetic under adam drifts
    from float64 by 1.4e-5 at step 3, JAX's own float32 step by the same."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    cfg = _step_cfg(tmp_path, *RES8_MFCC_ARGS)
    host = make_synthetic_dataset(num_samples=40, num_classes=4, desired_samples=N, seed=6)
    draws = _step_draws()
    init, got = _port_losses(tmp_path, monkeypatch, cfg, host, draws)
    batches = _port_features(cfg, host, draws)
    np.testing.assert_allclose(got, _jax_losses(cfg, init, batches), rtol=0, atol=1e-5)
    flat = tmp_path / "steps.npz"
    np.savez(flat, **{f"{group}/{k}": np.asarray(v)
                      for group in ("params", "batch_stats")
                      for k, v in _flatten(init[group]).items()},
             **{f"feats{i}": f for i, (f, _) in enumerate(batches)},
             **{f"labels{i}": y for i, (_, y) in enumerate(batches)})
    root = str(Path(__file__).resolve().parent.parent)
    proc = subprocess.run([sys.executable, "-c", _X64_CHILD, root, str(flat), str(tmp_path)],
                          capture_output=True, text=True, timeout=420, cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    assert child["x64"] and not jax.config.jax_enable_x64
    np.testing.assert_allclose(got, child["losses"], rtol=0, atol=2e-5)
    assert child["losses"][2] != child["losses"][0]


def test_adam_resume_is_exact(tmp_path):
    """DSCNNS with adam (and radix4 on K3's plain version): 6 steps in one
    go, and 4 then a fresh Trainer restoring step 4 (params, BN statistics,
    adam's mu, nu and count) and training to 6: the same state, bit for bit."""
    cfg = _step_cfg(tmp_path, "DSCNNS", "conv", "radix4", "on", 40.0, 20.0)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, step_save_checkpoint=2,
                                                step_evaluation=4, summary_step_verbose=4,
                                                class_sampling_factor=2))
    ds = DeviceDataset(make_synthetic_dataset(num_samples=48, num_classes=4,
                                              desired_samples=N, seed=3), "cpu")
    whole = Trainer(cfg, ds, workdir=tmp_path / "whole", steps_per_call=2)
    whole.train(6)
    first = Trainer(cfg, ds, workdir=tmp_path / "split", steps_per_call=2)
    first.train(4)
    saved = torch.load(CheckpointManager(tmp_path / "split" / "ckpt").path(4),
                       map_location="cpu", weights_only=True)
    assert int(saved["opt_state"]["count"]) == 4
    second = Trainer(cfg, ds, workdir=tmp_path / "split", steps_per_call=2)
    assert second.maybe_restore() == 4
    second.train(6)
    a, b = whole.state.state_dict(), second.state.state_dict()
    assert int(b["opt_state"]["count"]) == 6
    for field in ("params", "batch_stats", "opt_state"):
        assert set(a[field]) == set(b[field])
        for k in a[field]:
            assert torch.equal(a[field][k], b[field][k]), (field, k)


def test_train_and_evaluate_clis_on_a_2d_preset(tmp_path):
    """`--preset DSCNNL --cfg audio.dft_variant=radix4` trains through the
    train CLI on the CPU, and the evaluate CLI scores its checkpoint with
    the run's config (the radix-4 front end, the 2D model)."""
    from tcresnet_tpu_torch.tools import evaluate as evaluate_cli
    from tcresnet_tpu_torch.tools import train as train_cli

    run = str(tmp_path / "run")
    trainer = train_cli.main(["--preset", "DSCNNL", "--synthetic", "--synthetic-samples", "40",
                              "--batch-size", "4", "--max-step", "2", "--steps-per-call", "1",
                              "--train-dir", run, "--device", "cpu",
                              "--cfg", "audio.dft_variant=radix4"])
    assert int(trainer.state.step) == 2 and trainer.feature_shape == (49, 10, 1)
    assert int(trainer.state.opt_state["count"]) == 2
    scores = evaluate_cli.main(["--train-dir", run, "--synthetic", "--split", "valid",
                                "--valid-type", "once", "--device", "cpu"])
    assert scores["num_samples"] == 128 and np.isfinite(scores["loss"])
