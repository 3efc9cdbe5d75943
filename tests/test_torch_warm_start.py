"""Warm start and scope-filtered partial restore of the port against the
JAX package (the cases of tests/test_warm_start.py): the warm-started
params bit for bit, one step later within 1e-5, across architectures and
widths, and prefix-anchored scopes."""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from tcresnet_tpu.data.device_data import DeviceDataset as JDeviceDataset
from tcresnet_tpu.data.synthetic import make_synthetic_dataset as jmake_synthetic
from tcresnet_tpu.train import checkpoint as jckpt
from tcresnet_tpu.train.trainer import Trainer as JTrainer
from tcresnet_tpu_torch.config import OptimConfig
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.models.convert import jax_path, seeded_variables, variables_from_jax
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.train.checkpoint import CheckpointManager, restore_params_partial
from tcresnet_tpu_torch.train.trainer import Trainer
from tests.test_torch_config import to_jax_config
from tests.test_torch_trainable_scopes import (
    N, ROWS, draws, flat, host_data, jax_steps, port_as_jax, port_steps, step_cfg)

torch.set_num_threads(1)

MOM = OptimConfig(optimizer="mom", lr_list=(0.05, 0.02), boundaries=(1,))


def _trainer(cfg, workdir):
    return Trainer(cfg, DeviceDataset(host_data(), "cpu"), workdir=workdir)


def _load(state, variables, cfg):
    """Copy JAX-layout numpy variables into a port state's tensors."""
    v = variables_from_jax(cfg.model, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        for field in ("params", "batch_stats"):
            for k, t in getattr(state, field).items():
                t.copy_(v[field][k])


def _source(tmp_path, cfg, step=30, seed=11):
    """Seeded variables of `cfg`'s model as a port checkpoint and an orbax
    one of the JAX package, both at `step`: (port dir, JAX dir, variables)."""
    seeded = seeded_variables(cfg.model, dsp.feature_shape(cfg.audio), seed=seed)
    src = _trainer(cfg, tmp_path / "src")
    _load(src.state, seeded, cfg)
    src.state.step.fill_(step)
    src.ckpt.save(step, src.state)
    jdir = tmp_path / "src_jax"
    mgr = jckpt.CheckpointManager(jdir)
    mgr.save(step, {"step": np.asarray(step, np.int32), **seeded})
    mgr.wait()
    return src.ckpt.directory, jdir, seeded


def jax_host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def want_tree(jtr):
    return {"params": jax_host(jtr.state.params), "batch_stats": jax_host(jtr.state.batch_stats)}


def _jax_trainer(cfg, workdir):
    """The JAX Trainer of `cfg` (its step is never run: XLA backends)."""
    jcfg = to_jax_config(cfg.replace(
        audio=dataclasses.replace(cfg.audio, dsp_backend="xla"),
        augment=dataclasses.replace(cfg.augment, backend="xla")))
    host = jmake_synthetic(num_samples=ROWS, num_classes=4, desired_samples=N, seed=6)
    return JTrainer(jcfg, JDeviceDataset(host), workdir=workdir)


@pytest.mark.parametrize("scopes", [
    dict(),
    dict(exclude_scopes=["fc"]),
    dict(include_scopes=[r"^conv0", r"^block0"]),
    dict(include_scopes=["block1"], exclude_scopes=["block1_conv1"]),
], ids=["all", "exclude_fc", "include_conv0_block0", "include_block1_but_conv1"])
def test_warm_start_matches_jax(tmp_path, monkeypatch, scopes):
    cfg = step_cfg(tmp_path / "dst", MOM)
    port_dir, jax_dir, seeded = _source(tmp_path, cfg)
    jtr = _jax_trainer(cfg, tmp_path / "dst_jax")
    fresh = want_tree(jtr)
    tr = _trainer(cfg, tmp_path / "dst")
    _load(tr.state, fresh, cfg)  # the same fresh tensors as JAX's
    jtr.warm_start(jax_dir, **scopes)
    tr.warm_start(port_dir, **scopes)
    assert int(jtr.state.step) == int(tr.state.step) == 0
    got = flat(port_as_jax(cfg, tr.state))
    want = flat(want_tree(jtr))
    assert sorted(got) == sorted(want)
    restored = flat(seeded)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    assert any(np.array_equal(got[p], restored[p]) for p in want)
    if scopes:
        assert any(not np.array_equal(got[p], restored[p]) for p in want)
    assert all(not v.any() for v in tr.state.opt_state.values())
    # one step later, from the warm-started state with the same draws
    steps = draws(9, 1)
    loss = port_steps(tr, steps, monkeypatch)
    jloss, jparams, _ = jax_steps(cfg, want_tree(jtr), steps)
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=1e-5)
    after = flat(port_as_jax(cfg, tr.state)["params"])
    for path, value in flat(jparams).items():
        np.testing.assert_allclose(after[path], value, rtol=0, atol=1e-5, err_msg=path)


def test_partial_restore_matches_jax_across_architectures(tmp_path):
    """TCResNet14 from TCResNet8 with ignore_missing: the shared scopes
    restored, the rest (deeper blocks, fc of another shape) fresh, in
    both packages; without ignore_missing both raise."""
    src_cfg = step_cfg(tmp_path, MOM)
    dst_cfg = step_cfg(tmp_path, MOM, name="TCResNet14")
    src = seeded_variables(src_cfg.model, dsp.feature_shape(src_cfg.audio), seed=3)
    dst = seeded_variables(dst_cfg.model, dsp.feature_shape(dst_cfg.audio), seed=4)
    tsrc = variables_from_jax(src_cfg.model, **src)
    tdst = variables_from_jax(dst_cfg.model, **dst)
    path_of = functools.partial(jax_path, dst_cfg.model.name)
    for kw in (dict(include_scopes=[r"^conv0", r"^block0"]), dict(exclude_scopes=["fc"]),
               dict(include_scopes=["fc"]), dict()):
        for field in ("params", "batch_stats"):
            want = flat(jckpt.restore_params_partial(dst[field], src[field], ignore_missing=True,
                                                     **kw))
            got = restore_params_partial(tdst[field], tsrc[field], ignore_missing=True,
                                         path_of=path_of, **kw)
            back = flat(port_as_jax(dst_cfg, SimpleNamespace(**{**tdst, field: got}))[field])
            assert sorted(back) == sorted(want)
            for path in want:
                np.testing.assert_array_equal(back[path], want[path], err_msg=(kw, path))
    with pytest.raises(KeyError, match="Missing"):  # TCResNet8 has no block5
        restore_params_partial(tdst["params"], tsrc["params"], include_scopes=["block5"],
                               path_of=path_of)
    with pytest.raises(Exception):
        jckpt.restore_params_partial(dst["params"], src["params"], include_scopes=["block5"])


def test_cross_architecture_warm_start(tmp_path):
    """The port's Trainer.warm_start of TCResNet14 from a TCResNet8 run
    (tests/test_warm_start.py::test_cross_architecture_warm_start)."""
    src_cfg = step_cfg(tmp_path / "src", MOM)
    port_dir, _, seeded = _source(tmp_path, src_cfg)
    src = variables_from_jax(src_cfg.model, **seeded)
    tr = _trainer(step_cfg(tmp_path / "dst", MOM, name="TCResNet14"), tmp_path / "dst")
    fresh = {k: v.clone() for k, v in tr.state.params.items()}
    tr.warm_start(port_dir, include_scopes=[r"^conv0", r"^block0"], ignore_missing=True)
    for name in ("conv0_conv.weight", "block0_conv0_conv.weight", "block0_down_conv.weight"):
        assert torch.equal(tr.state.params[name], src["params"][name]), name
        assert not torch.equal(tr.state.params[name], fresh[name]), name
    for name in ("block1_conv0_conv.weight", "block5_conv0_conv.weight", "fc.weight"):
        assert torch.equal(tr.state.params[name], fresh[name]), name
    assert torch.equal(tr.state.batch_stats["conv0_bn.running_mean"],
                       src["batch_stats"]["conv0_bn.running_mean"])
    tr.train_steps(2)
    assert int(tr.state.step) == 2


def test_cross_width_warm_start_all_fresh(tmp_path):
    src_cfg = step_cfg(tmp_path / "src", MOM)
    port_dir, _, _ = _source(tmp_path, src_cfg)
    tr = _trainer(step_cfg(tmp_path / "dst", MOM, width=1.5), tmp_path / "dst")
    fresh = {k: v.clone() for k, v in tr.state.params.items()}
    tr.warm_start(port_dir, ignore_missing=True)
    for k, v in tr.state.params.items():
        assert torch.equal(v, fresh[k]), k
    with pytest.raises(ValueError, match="Shape mismatch"):
        tr.warm_start(port_dir)


def test_kept_step_applies_the_relative_schedule(tmp_path):
    cfg = step_cfg(tmp_path / "dst", dataclasses.replace(
        MOM, relative_schedule=True, use_ema=True))
    port_dir, _, seeded = _source(tmp_path, step_cfg(tmp_path / "src", MOM), step=7)
    tr = _trainer(cfg, tmp_path / "dst")
    tr.warm_start(port_dir, reset_step=False)
    assert int(tr.state.step) == 7
    assert [tr.lr_schedule(s) for s in (7, 8, 9)] == [0.05, 0.05, 0.02]  # boundary 1 + 7
    src = variables_from_jax(cfg.model, **seeded)["params"]
    for k, v in tr.state.ema_params.items():
        assert torch.equal(v, src[k]) and v.data_ptr() != tr.state.params[k].data_ptr()


def test_partial_restore_scopes_prefix_anchored():
    params = {"fc/kernel": torch.zeros(2), "block3/fc_proj/kernel": torch.zeros(3)}
    restored = {"fc/kernel": torch.ones(2), "block3/fc_proj/kernel": torch.ones(3)}
    out = restore_params_partial(params, restored, include_scopes=["fc"])
    assert out["fc/kernel"].sum() == 2 and out["block3/fc_proj/kernel"].sum() == 0
    out = restore_params_partial(params, restored, exclude_scopes=["fc"])
    assert out["fc/kernel"].sum() == 0 and out["block3/fc_proj/kernel"].sum() == 3
    with pytest.raises(KeyError):
        restore_params_partial(params, {"fc/kernel": torch.ones(2)})
    out = restore_params_partial(params, {"fc/kernel": torch.ones(2)}, ignore_missing=True)
    assert out["fc/kernel"].sum() == 2 and out["block3/fc_proj/kernel"].sum() == 0


def test_restore_raw_reads_any_run(tmp_path):
    cfg = step_cfg(tmp_path, MOM, name="TCResNet14")
    port_dir, _, _ = _source(tmp_path, cfg, step=4)
    raw = CheckpointManager(port_dir).restore_raw()
    assert int(raw["step"]) == 4 and "block5_conv0_conv.weight" in raw["params"]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore_raw()


def test_reset_step_draws_what_a_fresh_run_draws(tmp_path):
    """A warm start that resets the step takes the batch a fresh run takes
    at step 0 (draws are a function of (seed, step))."""
    cfg = step_cfg(tmp_path / "dst", MOM)
    port_dir, _, _ = _source(tmp_path, step_cfg(tmp_path / "src", MOM), step=9)
    fresh, warm = _trainer(cfg, tmp_path / "fresh"), _trainer(cfg, tmp_path / "dst")
    warm.warm_start(port_dir)
    draws_of = [DeviceDataset.sample_indices(t.data.arrays, t.generator(int(t.state.step)), 8)
                for t in (fresh, warm)]
    for a, b in zip(*draws_of):
        assert torch.equal(a, b)
