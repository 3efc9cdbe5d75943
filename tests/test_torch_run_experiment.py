"""The port's orchestrator (tcresnet_tpu_torch.tools.run_experiment): the
same child command lines as the JAX package's tools/run_experiment.py, and
trainer, loop evaluator and final test evaluation as three OS processes
that meet in the checkpoint directory, on the CPU at the JAX test's size
(tests/test_run_experiment.py)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tcresnet_tpu_torch.tools import run_experiment as trun
from tools import run_experiment as jrun

REPO = Path(__file__).resolve().parent.parent

ARGV = [
    ["--train-dir", "/tmp/x", "--synthetic"],
    ["--train-dir", "/tmp/x", "--synthetic", "--synthetic-samples", "192",
     "--clip-duration-ms", "250", "--batch-size", "16", "--max-step", "8",
     "--step-save-checkpoint", "4", "--steps-per-call", "2", "--train-device", "cpu",
     "--eval-device", "cpu", "--eval-poll-timeout", "120", "--seed", "3",
     "--compute-dtype", "bfloat16", "--num-silent", "12", "--num-silent-valid", "5",
     "--best-metric", "loss", "--final-split", "valid", "--cfg", "model.conv_backend=pallas",
     "--cfg", "audio.frontend_fuse=on"],
    ["--train-dir", "/tmp/x", "--preset", "DSCNNL", "--dataset-root", "/data/gsc",
     "--cache-dir", "/data/cache", "--num-silent-test", "7"],
    ["--train-dir", "/tmp/x", "--synthetic", "--cfg", "mesh.data=2", "--cfg", "mesh.model=2"],
]


@pytest.mark.parametrize("argv", ARGV, ids=["defaults", "every-flag", "tree", "mesh"])
def test_commands_match_jax(argv):
    """Each child gets the JAX orchestrator's flags, in its order; only the
    program (`python -m` the port's tool) and --eval-device's default, the
    card, differ."""
    jcmds = jrun.build_commands(jrun.parse_args(argv), "/tmp/x")
    targs = trun.parse_args(argv)
    tcmds = trun.build_commands(targs, "/tmp/x")
    for i, (jcmd, tcmd, tool) in enumerate(zip(jcmds, tcmds, ("train", "evaluate", "evaluate"))):
        assert jcmd[0] == tcmd[0] == sys.executable
        assert Path(jcmd[1]).name == f"{tool}.py"
        assert tcmd[1:3] == ["-m", f"tcresnet_tpu_torch.tools.{tool}"]
        want = jcmd[2:]
        if i == 1 and "--eval-device" not in argv:  # the loop evaluator: the card
            at = want.index("--device") + 1
            assert want[at] == "cpu" and targs.eval_device == "auto"
            want[at] = "auto"
        assert tcmd[3:] == want


def test_evaluate_takes_the_flags_the_orchestrator_forwards():
    """--seed, --compute-dtype, --num-silent and --clip-duration-ms set the
    same config fields in the evaluator as in the trainer (JAX's
    tools/evaluate.py takes all four)."""
    from tcresnet_tpu_torch.tools import evaluate as teval
    from tcresnet_tpu_torch.tools import train as ttrain

    flags = ["--seed", "7", "--compute-dtype", "bfloat16", "--num-silent", "3",
             "--clip-duration-ms", "250", "--synthetic"]
    cfgs = [ttrain.build_config(mod.parse_args(["--train-dir", "/tmp/x", *flags]))
            for mod in (teval, ttrain)]
    for cfg in cfgs:
        assert (cfg.train.seed, cfg.train.compute_dtype, cfg.augment.num_silent,
                cfg.audio.clip_duration_ms) == (7, "bfloat16", 3, 250)


def test_per_split_silence_counts():
    """Each child gets its own --num-silent, and an unset per-split flag
    forwards none (the loader's per-split auto), as in JAX."""
    def silent_of(cmd):
        return cmd[cmd.index("--num-silent") + 1] if "--num-silent" in cmd else None

    args = trun.parse_args(["--train-dir", "/tmp/x", "--synthetic", "--num-silent", "1854",
                            "--num-silent-valid", "258", "--num-silent-test", "257"])
    assert [silent_of(c) for c in trun.build_commands(args, "/tmp/x")] == ["1854", "258", "257"]
    args = trun.parse_args(["--train-dir", "/tmp/x", "--synthetic", "--num-silent", "1854"])
    assert [silent_of(c) for c in trun.build_commands(args, "/tmp/x")] == ["1854", None, None]


def test_two_process_train_eval_promote(tmp_path):
    """Trainer and loop evaluator as two processes on the CPU: the
    evaluator scores the trainer's checkpoints as they land and promotes a
    best, and the final test evaluation reads that best."""
    train_dir = tmp_path / "exp"
    cmd = [
        sys.executable, "-m", "tcresnet_tpu_torch.tools.run_experiment",
        "--preset", "TCResNet8-1.0",
        "--synthetic", "--synthetic-samples", "192",
        "--clip-duration-ms", "250",
        "--batch-size", "16",
        "--max-step", "8",
        "--step-save-checkpoint", "4",
        "--steps-per-call", "2",
        "--train-device", "cpu",
        "--eval-device", "cpu",
        "--eval-poll-timeout", "120",
        "--train-dir", str(train_dir),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=tmp_path,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]

    best = train_dir / "best" / "valid" / "accuracy"
    assert list(best.glob("ckpt_*.pt")), f"no promoted best under {best}"
    assert (best / "scores.tsv").exists()
    records = [json.loads(line)
               for line in (train_dir / "valid_metrics.jsonl").read_text().splitlines()]
    assert 8 in {r["step"] for r in records}
    assert (train_dir / "test_metrics.jsonl").exists()
    assert "loading best-valid/accuracy" in proc.stderr
