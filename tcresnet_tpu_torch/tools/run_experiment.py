"""Per-experiment orchestrator of the port: trainer + loop evaluator + final
test eval (counterpart of tools/run_experiment.py).

    python -m tcresnet_tpu_torch.tools.run_experiment --preset TCResNet8-1.0 \
        --dataset-root <tree> --train-dir runs/%DATE%_tcresnet8
    python -m tcresnet_tpu_torch.tools.run_experiment --preset TCResNet8-1.0 \
        --synthetic --max-step 60 --train-dir /tmp/exp --cfg model.conv_backend=pallas

The reference's per-experiment scripts, as three OS processes:

  1. the trainer (`python -m tcresnet_tpu_torch.tools.train`) writing
     checkpoints under the train dir;
  2. the loop evaluator (`python -m tcresnet_tpu_torch.tools.evaluate
     --valid-type loop`) watching the same dir, scoring every checkpoint
     and promoting bests;
  3. after both finish, a final evaluation of `--final-split` from the
     promoted `valid/<best-metric>` best.

The two children meet only in the checkpoint directory; the orchestrator
never leaves one behind (it terminates them in `finally`). One deliberate
difference from the JAX orchestrator: `--eval-device` defaults to `auto`,
the card, not to the CPU. Two CUDA processes share one H100, and the
port runs on the card unless asked for the CPU; `--eval-device cpu` keeps
the evaluator off the card, through the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

from tcresnet_tpu_torch.tools.train import build_config

_ROOT = Path(__file__).resolve().parents[2]  # the directory that holds the package
_TRAIN = ["-m", "tcresnet_tpu_torch.tools.train"]
_EVALUATE = ["-m", "tcresnet_tpu_torch.tools.evaluate"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="TCResNet8-1.0")
    p.add_argument("--dataset-root", nargs="+", default=None,
                   help="one <root>/<split>/<label>/*.wav tree, or several with the same "
                        "labels")
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--train-dir", required=True)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-samples", type=int, default=4096)
    p.add_argument("--max-step", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--num-silent", type=int, default=None,
                   help="silent rows of the TRAIN split (default: the loader's per-split "
                        "auto, samples // labels)")
    p.add_argument("--num-silent-valid", type=int, default=None,
                   help="silent rows for the loop evaluator's split (default: per-split auto)")
    p.add_argument("--num-silent-test", type=int, default=None,
                   help="silent rows for the final evaluation (default: per-split auto)")
    p.add_argument("--steps-per-call", type=int, default=None)
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default=None)
    p.add_argument("--step-save-checkpoint", type=int, default=None)
    p.add_argument("--clip-duration-ms", type=int, default=None)
    p.add_argument("--train-device", choices=["auto", "cpu"], default="auto",
                   help="the trainer's and the final evaluation's device (auto: the card)")
    p.add_argument("--eval-device", choices=["auto", "cpu"], default="auto",
                   help="the loop evaluator's device (auto: the card, shared with the "
                        "trainer; cpu: the host)")
    p.add_argument("--best-metric", default="accuracy",
                   help="valid metric whose promoted best the final evaluation loads")
    p.add_argument("--final-split", default="test",
                   help="split for the final evaluation ('' to skip)")
    p.add_argument("--eval-poll-timeout", type=float, default=600.0,
                   help="the loop evaluator stops after this many idle seconds without a "
                        "new checkpoint (should the trainer die)")
    p.add_argument("--cfg", action="append", default=[], metavar="SECTION.FIELD=VALUE",
                   help="config override, forwarded to the trainer and both evaluations")
    return p.parse_args(argv)


def _passthrough(args, *names):
    out = []
    for name in names:
        v = getattr(args, name.replace("-", "_"))
        if v is True:
            out.append(f"--{name}")
        elif isinstance(v, list):
            out += [f"--{name}", *map(str, v)]
        elif v is not None and v is not False:
            out += [f"--{name}", str(v)]
    return out


def _silent(flag_value):
    """Per-split silence counts: the reference passes its own --num_silent
    to each process. An unset per-split flag leaves the loader's per-split
    auto (split_size // num_labels), not the train split's count."""
    return [] if flag_value is None else ["--num-silent", str(flag_value)]


def build_commands(args, train_dir):
    """The three child command lines (trainer, loop evaluator, final
    evaluation), so that tests can check each process's flags without
    starting it."""
    common = _passthrough(
        args, "preset", "dataset-root", "cache-dir", "synthetic",
        "synthetic-samples", "compute-dtype", "clip-duration-ms",
    )
    for item in args.cfg:
        common += ["--cfg", item]
    train_cmd = (
        [sys.executable, *_TRAIN]
        + common
        + _silent(args.num_silent)
        + ["--train-dir", train_dir, "--eval-split", "", "--device", args.train_device]
        + _passthrough(
            args, "max-step", "batch-size", "seed", "steps-per-call",
            "step-save-checkpoint",
        )
    )
    eval_cmd = (
        [sys.executable, *_EVALUATE]
        + common
        + _silent(args.num_silent_valid)
        + ["--train-dir", train_dir, "--split", "valid", "--valid-type", "loop",
           "--device", args.eval_device,
           "--timeout", str(args.eval_poll_timeout)]
        + _passthrough(args, "max-step")
    )
    final_cmd = (
        [sys.executable, *_EVALUATE]
        + common
        + _silent(args.num_silent_test)
        + ["--train-dir", train_dir, "--split", args.final_split,
           "--valid-type", "once", "--best-metric", args.best_metric,
           "--device", args.train_device]
    )
    return train_cmd, eval_cmd, final_cmd


def _child_env() -> dict:
    """The environment with the package's directory first on PYTHONPATH, so
    that `python -m` finds it from any working directory."""
    path = os.environ.get("PYTHONPATH")
    return {**os.environ,
            "PYTHONPATH": str(_ROOT) + (os.pathsep + path if path else "")}


def main(argv=None) -> int:
    args = parse_args(argv)
    # %DATE% / %USER% / %FIELD% expanded once, so that both children share
    # one directory
    train_dir = build_config(args).train.train_dir
    Path(train_dir).mkdir(parents=True, exist_ok=True)
    print(f"[run_experiment] train_dir: {train_dir}", flush=True)

    train_cmd, eval_cmd, final_cmd = build_commands(args, train_dir)
    env = _child_env()
    procs = []
    try:
        trainer = subprocess.Popen(train_cmd, env=env)
        procs.append(("trainer", trainer))
        evaluator = subprocess.Popen(eval_cmd, env=env)
        procs.append(("evaluator", evaluator))

        rc_train = trainer.wait()
        if rc_train != 0:
            print(f"[run_experiment] trainer failed rc={rc_train}", flush=True)
            return rc_train
        # the evaluator stops once it has scored max_step, on the trainer's
        # TRAIN_DONE, or after the idle timeout
        rc_eval = evaluator.wait()
        if rc_eval != 0:
            print(f"[run_experiment] evaluator failed rc={rc_eval}", flush=True)
            return rc_eval
    finally:
        # the reference's trap 'pkill -P $$': never leave a child behind
        for name, proc in procs:
            if proc.poll() is None:
                print(f"[run_experiment] stopping {name}", flush=True)
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()

    if not args.final_split:
        return 0
    # the held-out evaluation of the promoted best valid checkpoint
    return subprocess.call(final_cmd, env=env)


if __name__ == "__main__":
    raise SystemExit(main())
