"""The preset sweep of the port (`python -m tcresnet_tpu_torch.tools.benchmark`)
on the CPU: every field of a row, the recorded failure and its exit code."""

import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch

from tcresnet_tpu_torch.config import get_preset
from tcresnet_tpu_torch.tools import benchmark
from tcresnet_tpu_torch.utils.profiling import step_flops

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

SMALL = ["--device", "cpu", "--batch", "4", "--steps-per-call", "1", "--num-samples", "64"]
LATENCY_KEYS = {"first", "curr", "min", "max", "avg", "median", "std"}


def _rows(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_sweep_on_the_cpu(tmp_path, capsys):
    report = tmp_path / "report.json"
    rc = benchmark.main(SMALL + ["--presets", "TCResNet8-1.0", "DSCNNS", "--dtype", "float32",
                                 "--out", str(report)])
    assert rc == 0
    rows = _rows(capsys.readouterr().out)
    assert [r["preset"] for r in rows] == ["TCResNet8-1.0", "DSCNNS"]
    assert json.loads(report.read_text()) == rows
    for r in rows:
        assert r["batch"] == 4 and r["compute_dtype"] == "float32" and r["device"] == "cpu"
        for key in ("train_utt_per_sec", "train_ms_per_step", "train_tflops_per_sec"):
            assert math.isfinite(r[key]) and r[key] > 0, key
        assert r["flops_per_step"] == step_flops(get_preset(r["preset"]), 4)
        assert r["train_utt_per_sec"] == pytest.approx(4e3 / r["train_ms_per_step"])
        assert r["train_tflops_per_sec"] == pytest.approx(
            r["flops_per_step"] / r["train_ms_per_step"] / 1e9)
        assert set(r["host_e2e_us"]) == LATENCY_KEYS
        assert all(math.isfinite(v) and v > 0 for v in r["host_e2e_us"].values() if v)
        assert r["host_e2e_us"]["min"] <= r["host_e2e_us"]["median"] <= r["host_e2e_us"]["max"]
        assert r["device_us"] is None and r["card"] is None
        assert "error" not in r and "infer_latency_us" not in r


def test_a_failed_preset_is_recorded_and_fails_the_sweep(capsys):
    rc = benchmark.main(SMALL + ["--presets", "NoSuchPreset"])
    rows = _rows(capsys.readouterr().out)
    assert rc == 1
    assert rows == [{"preset": "NoSuchPreset", "error": rows[0]["error"]}]
    assert "Unknown preset" in rows[0]["error"]


def test_im2col_is_refused():
    with pytest.raises(NotImplementedError, match="Not carried over"):
        benchmark.main(SMALL + ["--presets", "Res8", "--conv-backend", "im2col"])


def test_defaults_are_the_jax_tools():
    spec = importlib.util.spec_from_file_location("jax_benchmark_tool",
                                                  REPO / "tools" / "benchmark.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    args = benchmark.parse_args([])
    assert benchmark.DEFAULT_PRESETS == jax_tool.DEFAULT_PRESETS
    assert (args.batch, args.steps_per_call, args.dtype, args.num_samples, args.device) == (
        1024, 10, "bfloat16", 8192, "auto")
