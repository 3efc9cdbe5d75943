"""The port's evaluation (tcresnet_tpu_torch.metrics, .evaluation,
.tools.evaluate) against the JAX package on the same inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu.config import AudioConfig, AugmentConfig, DataConfig, ExperimentConfig
from tcresnet_tpu.config import ModelConfig, OptimConfig, TrainConfig
from tcresnet_tpu.data.device_data import DeviceDataset as JaxDeviceDataset
from tcresnet_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from tcresnet_tpu.evaluation.best_keeper import BestKeeper as JaxBestKeeper
from tcresnet_tpu.evaluation.evaluator import Evaluator as JaxEvaluator
from tcresnet_tpu.metrics.host_metrics import compute_classification_metrics as sk_metrics
from tcresnet_tpu.ops import augment as jaug
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset
from tcresnet_tpu_torch.evaluation.best_keeper import BestKeeper
from tcresnet_tpu_torch.evaluation.evaluator import Evaluator
from tcresnet_tpu_torch.evaluation.watcher import WatchingEvaluator, checkpoint_iterator
from tcresnet_tpu_torch.metrics import host_metrics
from tcresnet_tpu_torch.models import layers
from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
from tcresnet_tpu_torch.ops import augment as aug
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.ops.kernels import tconv
from tcresnet_tpu_torch.ops.kernels.augment import AugmentScalars
from tcresnet_tpu_torch.tools import evaluate as evaluate_cli
from tcresnet_tpu_torch.tools import train as train_cli
from tcresnet_tpu_torch.train.checkpoint import CheckpointManager
from tcresnet_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# the metric battery against scikit-learn (through the JAX package)
# ---------------------------------------------------------------------------


METRIC_CASES = ["random", "ties", "absent_class", "twelve"]


def _metric_case(name):
    rng = np.random.default_rng(METRIC_CASES.index(name))
    if name == "random":
        scores, labels = rng.dirichlet(np.ones(6), 50), rng.integers(0, 6, 50)
    elif name == "ties":  # scores on a coarse grid: many exact ties, in and across rows
        scores, labels = rng.integers(0, 4, (60, 5)) / 4.0, rng.integers(0, 5, 60)
    elif name == "absent_class":  # class 2 never labelled, class 4 never predicted
        scores = rng.dirichlet(np.ones(5), 40)
        scores[:, 4] *= 0.01
        labels = rng.choice([0, 1, 3, 4], 40)
    else:  # "twelve": 12 classes
        scores, labels = rng.dirichlet(np.ones(12), 300), rng.integers(0, 12, 300)
    return scores.astype(np.float32), labels.astype(np.int64)


@pytest.mark.parametrize("name", METRIC_CASES)
@pytest.mark.parametrize("class_metrics", [False, True])
def test_metric_battery_matches_sklearn(name, class_metrics):
    scores, labels = _metric_case(name)
    names = [f"c{i}" for i in range(scores.shape[1])]
    want = sk_metrics(scores, labels, names, use_class_metrics=class_metrics,
                      include_report=True)
    got = host_metrics.compute_classification_metrics(
        scores, labels, names, use_class_metrics=class_metrics, include_report=True)
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "classification_report":
            assert isinstance(got[k], str) and all(n in got[k] for n in ("c0", "accuracy"))
            continue
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)
    if name == "absent_class" and class_metrics:
        assert got["AP/c2"] == want["AP/c2"] == 0.0
    assert host_metrics.top_k_accuracy(np.ones((2, 6), np.float32), np.array([5, 0]), 5) == 0.5


# ---------------------------------------------------------------------------
# BestKeeper
# ---------------------------------------------------------------------------


def test_best_keeper_writes_jax_scores_tsv_and_resumes(tmp_path):
    modes = {"accuracy": "max", "loss": "min"}
    sequence = [{"accuracy": 0.5, "loss": 1.25, "mAP_macro": 0.6},
                {"accuracy": 0.50004, "loss": 1.1, "mAP_macro": 0.61},  # within epsilon
                {"accuracy": 0.75, "loss": 1.2, "mAP_macro": 1.0 / 3.0,
                 "classification_report": "text is not a score"}]
    jk = JaxBestKeeper(modes, "valid", tmp_path / "jax")
    pk = BestKeeper(modes, "valid", tmp_path / "port")
    for step, scores in enumerate(sequence):
        jany, jkeep = jk.monitor(scores)
        pany, pkeep = pk.monitor(scores)
        assert (jany, jkeep) == (pany, pkeep)
        meta = {"step": step * 10, "model_size": 65168}
        jk.save_scores(jkeep, scores, meta_info=meta)
        pk.save_scores(pkeep, scores, meta_info=meta)
    for metric in modes:
        rel = f"valid/{metric}/scores.tsv"
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    again = BestKeeper(modes, "valid", tmp_path / "port")
    assert again.metric_best == pk.metric_best == {"accuracy": 0.75, "loss": 1.1}
    assert again.monitor({"accuracy": 0.75})[1] == {"accuracy": False, "loss": False}
    with pytest.raises(ValueError):
        BestKeeper({"accuracy": "up"}, "valid", tmp_path)


# ---------------------------------------------------------------------------
# Evaluator against the JAX Evaluator
# ---------------------------------------------------------------------------

N_VALID, EVAL_BATCH = 70, 32  # three batches, the last padded


def _eval_cfg(naive, seed=7):
    return ExperimentConfig(
        audio=AudioConfig(clip_duration_ms=250, num_mfccs=20, num_mel_bins=32),
        augment=AugmentConfig(naive_background_mix=naive),
        model=ModelConfig(name="TCResNet8", num_classes=4, label_smoothing=0.1),
        train=TrainConfig(seed=seed),
        data=DataConfig(eval_batch_size=EVAL_BATCH),
    )


def _jax_silence_draws(cfg, host, ordinal):
    """The v2 eval draws the JAX Evaluator makes for batch `ordinal`
    (its key split: evaluator.py:131-138, augment.py:327-345)."""
    idx = np.arange(ordinal * EVAL_BATCH, (ordinal + 1) * EVAL_BATCH)
    idx = np.where(idx < host.num_samples, idx, 0)
    silent = jnp.asarray(host.is_silent[idx])
    key = jax.random.fold_in(jax.random.key(cfg.train.seed), ordinal)
    _, k_bg = jax.random.split(key)
    k_mix, k_vols = jax.random.split(k_bg)
    k_idx, k_off, _, _ = jax.random.split(k_mix, 4)
    num_clips, clip_len = host.noise_bank.shape
    n = cfg.audio.desired_samples
    eval_aug = dataclasses.replace(cfg.augment, method="anchored_slice_or_pad",
                                   background_frequency=0.0, background_max_volume=0.0)
    return (np.asarray(jax.random.randint(k_idx, (EVAL_BATCH,), 0, num_clips)),
            np.asarray(jax.random.randint(k_off, (EVAL_BATCH,), 0, clip_len - n + 1)),
            np.asarray(jaug.draw_background_volumes(k_vols, silent, eval_aug, False)))


@pytest.mark.parametrize("naive", [True, False])
def test_evaluator_matches_the_jax_evaluator(monkeypatch, naive):
    cfg = _eval_cfg(naive)
    n = cfg.audio.desired_samples
    jhost = jax_synthetic(num_samples=N_VALID, num_classes=4, desired_samples=n, seed=1,
                          split="valid")
    host = make_synthetic_dataset(num_samples=N_VALID, num_classes=4, desired_samples=n,
                                  seed=1, split="valid")
    seeded = seeded_variables(cfg.model, dsp.feature_shape(cfg.audio), seed=2)
    want = JaxEvaluator(cfg, JaxDeviceDataset(jhost)).evaluate(
        jax.tree_util.tree_map(jnp.asarray, seeded["params"]),
        jax.tree_util.tree_map(jnp.asarray, seeded["batch_stats"]))

    draws = [] if naive else [_jax_silence_draws(cfg, jhost, i) for i in range(3)]

    def injected(generator, is_silent, aug_cfg, noise_bank, n, is_training):
        clips, offs, vols = draws.pop(0)
        b = is_silent.shape[0]
        return AugmentScalars(torch.zeros(b, dtype=torch.int32), torch.tensor(clips, dtype=torch.int32),
                              torch.tensor(offs, dtype=torch.int32), torch.tensor(vols),
                              torch.where(is_silent, 0.0, 1.0).to(torch.float32))

    monkeypatch.setattr(aug, "draw_scalars", injected)
    v = variables_from_jax(**seeded)
    got = Evaluator(cfg, DeviceDataset(host, "cpu")).evaluate(v["params"], v["batch_stats"])
    assert draws == []
    assert got["num_samples"] == want["num_samples"] == N_VALID
    assert got["accuracy"] == want["accuracy"]
    if not naive:  # the silence rows were mixed with noise: the loss sees it
        assert host.is_silent.any()
    numeric = {k for k, x in want.items() if not isinstance(x, str)}
    assert numeric - {"batch_infer_time", "unit_infer_time"} <= set(got)
    assert any(k.startswith("AP/") for k in numeric)  # 4 < 10 labels: class metrics on
    for k in numeric - {"batch_infer_time", "unit_infer_time"}:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    assert "classification_report" in got


def test_evaluator_repeats_and_honours_exclusions():
    cfg = _eval_cfg(naive=False)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, exclude_metric_names=("accuracy",)))
    host = make_synthetic_dataset(num_samples=40, num_classes=4,
                                  desired_samples=cfg.audio.desired_samples, seed=3)
    v = variables_from_jax(**seeded_variables(cfg.model, dsp.feature_shape(cfg.audio), 4))
    ev = Evaluator(cfg, DeviceDataset(host, "cpu"))
    a = ev.evaluate(v["params"], v["batch_stats"], include_report=False)
    b = ev.evaluate(v["params"], v["batch_stats"], include_report=False)
    assert "accuracy" not in a and "classification_report" not in a
    assert a["loss"] == b["loss"] and a["mAP_macro"] == b["mAP_macro"]


# ---------------------------------------------------------------------------
# the loop evaluator over a run of the port's Trainer
# ---------------------------------------------------------------------------


def _run_cfg(tmp_path, conv_backend="xla"):
    return ExperimentConfig(
        audio=AudioConfig(clip_duration_ms=200, num_mfccs=20, num_mel_bins=32),
        augment=AugmentConfig(background_frequency=0.5, background_max_volume=0.2),
        model=ModelConfig(name="TCResNet8", num_classes=4, bn_momentum=0.9,
                          conv_backend=conv_backend),
        optim=OptimConfig(optimizer="mom", lr_list=(0.1,), boundaries=(), use_ema=True),
        train=TrainConfig(batch_size=16, max_step=3, step_save_checkpoint=1, max_to_keep=5,
                          train_dir=str(tmp_path)),
        data=DataConfig(eval_batch_size=24, use_synthetic=True, synthetic_num_samples=64),
    )


def _train(tmp_path, cfg):
    """Train the run; its valid split as the evaluate CLI builds it."""
    Trainer(cfg, DeviceDataset(train_cli.load_split(cfg, "train"), "cpu"),
            workdir=tmp_path).train()
    return train_cli.load_split(cfg, "valid")


def test_watcher_scores_each_checkpoint_once_and_promotes_the_best(tmp_path):
    cfg = _run_cfg(tmp_path, conv_backend="pallas")
    valid = _train(tmp_path, cfg)
    assert CheckpointManager(tmp_path / "ckpt").all_steps() == [1, 2, 3]
    watcher = WatchingEvaluator(cfg, DeviceDataset(valid, "cpu"), tmp_path)
    seen, recorded = [], {}
    evaluate = watcher.evaluator.evaluate

    def counting(state, *a, **kw):
        seen.append(int(state.step))
        recorded[seen[-1]] = evaluate(state, *a, **kw)
        return recorded[seen[-1]]

    watcher.evaluator.evaluate = counting
    restore = watcher.ckpt.restore

    def racing_restore(state, step):  # max_to_keep deletes step 2 after the listing
        if step == 2:
            watcher.ckpt.path(2).unlink()
        return restore(state, step)

    watcher.ckpt.restore = racing_restore
    calls = tconv.fwd_launches
    scores = watcher.watch(max_step=10**6, poll_interval=0.01, timeout=None)  # TRAIN_DONE ends it
    assert seen == [1, 3] and tconv.fwd_launches == calls  # CPU: K7's plain version
    assert np.isfinite(scores["loss"]) and scores["num_samples"] == 128  # 5 batches of 24

    best = watcher.best_keeper.best_checkpoint_dir("accuracy")
    tsv = (best / "scores.tsv").read_text().splitlines()
    row = dict(zip(tsv[0].split("\t"), tsv[1].split("\t")))
    step = CheckpointManager(best).latest_step()
    assert step in (1, 3) and float(row["step"]) == step
    assert int(float(row["model_size"])) == 65168 - 40 * 16 * 3 + 20 * 16 * 3 - 48 * 8

    # --valid-type once --best-metric accuracy re-scores the promoted state identically
    again = evaluate_cli.main(["--train-dir", str(tmp_path), "--synthetic", "--device", "cpu",
                               "--valid-type", "once", "--best-metric", "accuracy"])
    assert again["num_samples"] == 128
    for k in ("accuracy", "loss", "mAP_macro"):
        assert again[k] == recorded[step][k]
        assert float(row[k]) == pytest.approx(again[k], abs=5e-6)  # scores.tsv keeps 5 places
    assert watcher.evaluate_once(2) is None  # a vanished step is skipped, not fatal


def test_checkpoint_iterator_stops_on_timeout_and_sentinel(tmp_path):
    ckpt = CheckpointManager(tmp_path / "ckpt")
    assert list(checkpoint_iterator(ckpt, poll_interval=0.01, timeout=0.03)) == []
    assert list(checkpoint_iterator(ckpt, poll_interval=0.01, should_stop=lambda: True)) == []


def test_train_and_evaluate_clis(tmp_path):
    """tools.train with --cfg (conv_backend reaches the model and config.json)
    then tools.evaluate in loop mode over the run."""
    run = tmp_path / "run"
    argv = ["--synthetic", "--synthetic-samples", "48", "--device", "cpu", "--max-step", "2",
            "--batch-size", "8", "--step-save-checkpoint", "1", "--train-dir", str(run),
            "--cfg", "model.conv_backend=pallas", "--cfg", "audio.clip_duration_ms=200",
            "--cfg", "audio.num_mfccs=20", "--cfg", "audio.num_mel_bins=32",
            "--cfg", "optim.lr_list=[0.05]", "--cfg", "optim.boundaries=[]"]
    trainer = train_cli.main(argv)
    assert trainer.cfg.model.conv_backend == "pallas"
    assert isinstance(trainer.model.conv0_conv, layers.PallasTemporalConv)
    saved = train_cli.load_run_config(run)
    assert saved.model.conv_backend == "pallas" and saved.optim.lr_list == (0.05,)
    scores = evaluate_cli.main(["--train-dir", str(run), "--synthetic", "--device", "cpu",
                                "--valid-type", "loop", "--batch-size", "50"])
    assert scores["num_samples"] == 128  # max(48 // 8, 128) rows, seed 1
    assert CheckpointManager(run / "best" / "valid" / "loss").latest_step() in (1, 2)
    with pytest.raises(SystemExit, match="Unknown config field"):
        train_cli.main(argv[:-2] + ["--cfg", "model.no_such_field=1"])
    with pytest.raises(SystemExit, match="number"):
        train_cli.build_config(train_cli.parse_args(["--cfg", "train.max_step=many"]))
    with pytest.raises(SystemExit, match="bool"):
        train_cli.build_config(train_cli.parse_args(["--cfg", "optim.use_ema=1"]))
    with pytest.raises(SystemExit, match="synthetic"):
        evaluate_cli.main(["--train-dir", str(tmp_path / "none"), "--device", "cpu"])
