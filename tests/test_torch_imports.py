"""The PyTorch port imports no JAX, and imports nothing CUDA-only at import."""

import os
import subprocess
import sys
from pathlib import Path


REPO = Path(__file__).resolve().parent.parent

PORT_MODULES = [
    "tcresnet_tpu_torch",
    "tcresnet_tpu_torch.utils.device",
    "tcresnet_tpu_torch.ops.dsp",
    "tcresnet_tpu_torch.ops.kernels",
    "tcresnet_tpu_torch.ops.kernels._build",
    "tcresnet_tpu_torch.ops.kernels.infer",
    "tcresnet_tpu_torch.ops.kernels.mfcc",
    "tcresnet_tpu_torch.ops.kernels.augment",
    "tcresnet_tpu_torch.ops.kernels.frontend",
    "tcresnet_tpu_torch.ops.kernels.tconv",
    "tcresnet_tpu_torch.ops.augment",
    "tcresnet_tpu_torch.data",
    "tcresnet_tpu_torch.data.speech_commands",
    "tcresnet_tpu_torch.data.synthetic",
    "tcresnet_tpu_torch.data.device_data",
    "tcresnet_tpu_torch.train",
    "tcresnet_tpu_torch.train.loss",
    "tcresnet_tpu_torch.train.optim",
    "tcresnet_tpu_torch.train.state",
    "tcresnet_tpu_torch.train.checkpoint",
    "tcresnet_tpu_torch.train.trainer",
    "tcresnet_tpu_torch.tools.train",
    "tcresnet_tpu_torch.tools.evaluate",
    "tcresnet_tpu_torch.metrics",
    "tcresnet_tpu_torch.metrics.host_metrics",
    "tcresnet_tpu_torch.evaluation",
    "tcresnet_tpu_torch.evaluation.best_keeper",
    "tcresnet_tpu_torch.evaluation.evaluator",
    "tcresnet_tpu_torch.evaluation.watcher",
    "tcresnet_tpu_torch.models",
    "tcresnet_tpu_torch.models.layers",
    "tcresnet_tpu_torch.models.tc_resnet",
    "tcresnet_tpu_torch.models.convert",
    "tcresnet_tpu_torch.serve.export",
    "tcresnet_tpu_torch.serve.benchmark",
    "tcresnet_tpu_torch.tools.latency_bench",
]


def _run(code: str) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_without_jax():
    """With jax, flax, optax, orbax and triton blocked, every port module
    imports."""
    blocked = ["jax", "jaxlib", "flax", "optax", "orbax", "triton"]
    code = (
        "import sys\n"
        f"for name in {blocked!r}: sys.modules[name] = None\n"
        f"for mod in {PORT_MODULES!r}: __import__(mod)\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_takes_only_stdlib_modules_of_the_jax_package():
    """The port may use tcresnet_tpu.config, tcresnet_tpu.const and the
    metric writers (stdlib and numpy only) and nothing else of the JAX
    package."""
    code = (
        "import sys\n"
        f"for mod in {PORT_MODULES!r}: __import__(mod)\n"
        "print(','.join(sorted(m for m in sys.modules if m.startswith('tcresnet_tpu.'))))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    used = set(filter(None, proc.stdout.strip().split(",")))
    assert used <= {"tcresnet_tpu.config", "tcresnet_tpu.const", "tcresnet_tpu.metrics",
                    "tcresnet_tpu.metrics.host_metrics", "tcresnet_tpu.metrics.writers"}, used
