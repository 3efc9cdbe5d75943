"""The port's own config (tcresnet_tpu_torch.config) against the JAX package's.

The port keeps a copy of tcresnet_tpu/config.py so that it imports
nothing of the JAX package. These tests hold the copy equal to the
original: every preset, every default, and the JSON round trip. The
other port tests build port configs for the port and hand the JAX side
the equal JAX config through `to_jax_config`.
"""

import dataclasses
import json

import pytest

from tcresnet_tpu import config as jconfig
from tcresnet_tpu_torch import config as tconfig
from tcresnet_tpu_torch import const as tconst
from tcresnet_tpu_torch.metrics import writers as twriters


def to_jax_config(cfg):
    """The JAX package's config (any section or a whole ExperimentConfig)
    with the same fields as the port's `cfg`."""
    fields = {}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        fields[f.name] = to_jax_config(value) if dataclasses.is_dataclass(value) else value
    return getattr(jconfig, type(cfg).__name__)(**fields)


def test_presets_equal_the_jax_packages():
    assert sorted(tconfig.PRESETS) == sorted(jconfig.PRESETS)
    assert len(tconfig.PRESETS) == 15
    for name in jconfig.PRESETS:
        port, jax_cfg = tconfig.get_preset(name), jconfig.get_preset(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg), name
        assert to_jax_config(port) == jax_cfg, name
    with pytest.raises(KeyError, match="Unknown preset"):
        tconfig.get_preset("NoSuchPreset")


@pytest.mark.parametrize("section", ["AudioConfig", "AugmentConfig", "ModelConfig", "OptimConfig",
                                     "TrainConfig", "DataConfig", "MeshConfig", "ExperimentConfig"])
def test_defaults_equal_the_jax_packages(section):
    port, jax_cfg = getattr(tconfig, section)(), getattr(jconfig, section)()
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(jax_cfg)]


def test_properties_equal_the_jax_packages():
    for name in jconfig.PRESETS:
        port, jax_cfg = tconfig.get_preset(name).audio, jconfig.get_preset(name).audio
        for prop in ("desired_samples", "window_size_samples", "window_stride_samples"):
            assert getattr(port, prop) == getattr(jax_cfg, prop)


@pytest.mark.parametrize("name", ["TCResNet8-1.0", "Res15", "DSCNNL", "KWSfpool3"])
def test_json_round_trip(name):
    cfg = tconfig.get_preset(name)
    again = tconfig.ExperimentConfig.from_json(cfg.to_json())
    assert again == cfg
    assert cfg.to_json() == jconfig.get_preset(name).to_json()
    assert jconfig.ExperimentConfig.from_json(cfg.to_json()) == jconfig.get_preset(name)


def test_const_and_writers_equal_the_jax_packages(tmp_path):
    from tcresnet_tpu import const as jconst
    from tcresnet_tpu.metrics import writers as jwriters

    for key in ("NULL_CLASS_LABEL", "BACKGROUND_NOISE_DIR_NAME", "GSC_V1_LABELS"):
        assert getattr(tconst, key) == getattr(jconst, key)
    for step in (0, 1, 9, 10, 30, 31, 2000, 2001):
        for args in ((10, 2000, 30), (5, 100, 0)):
            assert twriters.should_write_summary(step, *args) == jwriters.should_write_summary(
                step, *args)
    for prev, step in ((9, 10), (10, 19), (0, 500), (499, 1000)):
        assert twriters.crossed_boundary(prev, step, 10) == jwriters.crossed_boundary(prev, step, 10)
    records = []
    for mod, sub in ((twriters, "port"), (jwriters, "jax")):
        writer = mod.MetricWriter(tmp_path / sub, use_tensorboard=False)
        writer.write(3, {"loss": 0.5, "acc": float("nan"), "name": "x"}, prefix="train/")
        writer.close()
        record = json.loads((tmp_path / sub / "train_metrics.jsonl").read_text())
        record.pop("time")
        records.append(record)
    assert records[0] == records[1] == {"step": 3, "train/loss": 0.5, "train/acc": None}
