"""Checkpoints and resume of the port's trainer (CPU, small geometry)."""

import dataclasses
import json

import pytest
import torch

from tcresnet_tpu_torch.config import AudioConfig, AugmentConfig, ExperimentConfig, ModelConfig
from tcresnet_tpu_torch.config import OptimConfig, TrainConfig
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset
from tcresnet_tpu_torch.train.checkpoint import CheckpointManager
from tcresnet_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)


def _cfg(tmp_path, **train):
    return ExperimentConfig(
        audio=AudioConfig(clip_duration_ms=160, num_mfccs=20, num_mel_bins=32),
        augment=AugmentConfig(background_frequency=0.5, background_max_volume=0.1,
                              backend="pallas"),
        model=ModelConfig(name="TCResNet8", num_classes=4),
        optim=OptimConfig(optimizer="mom", lr_list=(0.1, 0.05), boundaries=(3,),
                          use_ema=True),
        train=TrainConfig(**{**dict(
            batch_size=16, max_step=6, step_save_checkpoint=2, step_evaluation=4,
            summary_step_verbose=4, class_sampling_factor=2, train_dir=str(tmp_path)),
            **train}),
    )


@pytest.fixture(scope="module")
def dataset():
    return DeviceDataset(make_synthetic_dataset(num_samples=48, num_classes=4,
                                                desired_samples=2560, seed=3), "cpu")


def _snapshot(state):
    return {k: v.detach().clone() for k, v in state.state_dict()["params"].items()}


def test_save_restore_round_trip_and_max_to_keep(tmp_path, dataset):
    trainer = Trainer(_cfg(tmp_path / "a"), dataset)
    trainer.train_steps(2, start=0)
    mgr = CheckpointManager(tmp_path / "ck", max_to_keep=2)
    for step in (2, 4, 6):
        mgr.save(step, trainer.state)
    assert mgr.all_steps() == [4, 6] and mgr.latest_step() == 6
    saved = trainer.state.state_dict()
    fresh = Trainer(_cfg(tmp_path / "b"), dataset)
    assert not torch.equal(fresh.state.params["fc.weight"], trainer.state.params["fc.weight"])
    mgr.restore(fresh.state)
    got = fresh.state.state_dict()
    assert int(got["step"]) == 2
    for field in ("params", "batch_stats", "opt_state", "ema_params"):
        for k, v in saved[field].items():
            assert torch.equal(got[field][k], v), (field, k)
    # the model computes with the restored tensors
    assert fresh.model.fc.weight.data_ptr() == fresh.state.params["fc.weight"].data_ptr()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(fresh.state)


def test_resume_equals_an_uninterrupted_run(tmp_path, dataset):
    """Train 6 steps in one go, and 4 then a fresh Trainer restoring step 4
    and training to 6: the same parameters, bit for bit."""
    whole = Trainer(_cfg(tmp_path / "whole"), dataset, steps_per_call=2)
    whole.train(6)
    first = Trainer(_cfg(tmp_path / "split"), dataset, steps_per_call=2)
    first.train(4)
    assert (tmp_path / "split" / "ckpt" / "TRAIN_DONE").read_text() == "4"
    second = Trainer(_cfg(tmp_path / "split"), dataset, steps_per_call=2)
    assert second.maybe_restore() == 4
    second.train(6)
    assert int(second.state.step) == 6
    a, b = _snapshot(whole.state), _snapshot(second.state)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert CheckpointManager(tmp_path / "split" / "ckpt").all_steps() == [2, 4, 6]
    # a finished run returns at once and leaves its sentinel
    again = Trainer(_cfg(tmp_path / "split"), dataset)
    again.train(6)
    assert (tmp_path / "split" / "ckpt" / "TRAIN_DONE").read_text() == "6"
    records = [json.loads(line) for line in
               (tmp_path / "whole" / "train_metrics.jsonl").read_text().splitlines()]
    assert any("train_stream/accuracy" in r for r in records)
    assert [r["step"] for r in records if "total_loss" in r] == [2, 4, 6]


def test_budgets_and_unported_options(tmp_path, dataset):
    trainer = Trainer(_cfg(tmp_path / "c", max_epoch=1), dataset)
    trainer.train(100)  # 48 samples // 16 = 3 steps per epoch
    assert int(trainer.state.step) == 3
    with pytest.raises(ValueError, match="unbounded"):
        Trainer(_cfg(tmp_path / "d", max_step=0), dataset).train(-1)
    cfg = _cfg(tmp_path / "e")
    # relative_schedule: a resume at step 3 shifts the boundary (3,) to (6,)
    relative = Trainer(cfg.replace(
        train=trainer.cfg.train,
        optim=dataclasses.replace(cfg.optim, relative_schedule=True)),
        dataset)
    assert relative.maybe_restore() == 3
    assert [relative.lr_schedule(s) for s in (3, 6, 7)] == [0.1, 0.1, 0.05]
    with pytest.raises(ValueError, match="classes"):
        Trainer(cfg.replace(model=ModelConfig(name="TCResNet8", num_classes=5)), dataset)


def test_train_cli_on_cpu(tmp_path):
    from tcresnet_tpu_torch.tools import train as cli

    trainer = cli.main(["--preset", "TCResNet8-1.0", "--synthetic", "--synthetic-samples",
                        "40", "--batch-size", "4", "--max-step", "2", "--steps-per-call", "1",
                        "--train-dir", str(tmp_path / "run"), "--device", "cpu"])
    assert int(trainer.state.step) == 2
    assert trainer.feature_shape == (98, 40, 1)
    assert CheckpointManager(tmp_path / "run" / "ckpt").latest_step() == 2
    with pytest.raises(SystemExit):
        cli.main(["--max-step", "1", "--device", "cpu"])
