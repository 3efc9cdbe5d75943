"""The PyTorch port imports no JAX, and imports nothing CUDA-only at import."""

import os
import subprocess
import sys
from pathlib import Path


REPO = Path(__file__).resolve().parent.parent

PORT_MODULES = [
    "tcresnet_tpu_torch",
    "tcresnet_tpu_torch.config",
    "tcresnet_tpu_torch.const",
    "tcresnet_tpu_torch.utils.device",
    "tcresnet_tpu_torch.ops.dsp",
    "tcresnet_tpu_torch.ops.kernels",
    "tcresnet_tpu_torch.ops.kernels._build",
    "tcresnet_tpu_torch.ops.kernels.infer",
    "tcresnet_tpu_torch.ops.kernels.infer2d",
    "tcresnet_tpu_torch.ops.kernels.mfcc",
    "tcresnet_tpu_torch.ops.kernels.augment",
    "tcresnet_tpu_torch.ops.kernels.frontend",
    "tcresnet_tpu_torch.ops.kernels.tconv",
    "tcresnet_tpu_torch.ops.augment",
    "tcresnet_tpu_torch.data",
    "tcresnet_tpu_torch.data.speech_commands",
    "tcresnet_tpu_torch.data.wav",
    "tcresnet_tpu_torch.data.native_loader",
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
    "tcresnet_tpu_torch.tools.prepare_dataset",
    "tcresnet_tpu_torch.metrics",
    "tcresnet_tpu_torch.metrics.host_metrics",
    "tcresnet_tpu_torch.metrics.writers",
    "tcresnet_tpu_torch.evaluation",
    "tcresnet_tpu_torch.evaluation.best_keeper",
    "tcresnet_tpu_torch.evaluation.evaluator",
    "tcresnet_tpu_torch.evaluation.watcher",
    "tcresnet_tpu_torch.models",
    "tcresnet_tpu_torch.models.layers",
    "tcresnet_tpu_torch.models.tc_resnet",
    "tcresnet_tpu_torch.models.res",
    "tcresnet_tpu_torch.models.ds_cnn",
    "tcresnet_tpu_torch.models.kws",
    "tcresnet_tpu_torch.models.convert",
    "tcresnet_tpu_torch.serve.export",
    "tcresnet_tpu_torch.serve.benchmark",
    "tcresnet_tpu_torch.serve.streaming",
    "tcresnet_tpu_torch.tools.latency_bench",
    "tcresnet_tpu_torch.tools.export",
    "tcresnet_tpu_torch.tools.run_experiment",
    "tcresnet_tpu_torch.parallel",
    "tcresnet_tpu_torch.parallel.mesh",
    "tcresnet_tpu_torch.graft_entry",
    "tcresnet_tpu_torch.utils.profiling",
    "tcresnet_tpu_torch.utils.timing",
    "tcresnet_tpu_torch.tools.benchmark",
    "tcresnet_tpu_torch.tools.profile_scaling",
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


def test_port_imports_no_module_of_the_jax_package():
    """Every port module, and every module chip_smoke.py imports (at the top
    and inside its functions, read from its source; the script itself is
    imported without running main), import with jax, flax, optax and orbax
    blocked, and pull in no module of the JAX package: the port keeps its
    own copies of the config, the constants and the metric writers."""
    blocked = ["jax", "jaxlib", "flax", "optax", "orbax"]
    code = (
        "import ast, importlib.util, sys\n"
        f"for name in {blocked!r}: sys.modules[name] = None\n"
        f"for mod in {PORT_MODULES!r}: __import__(mod)\n"
        "src = open('chip_smoke.py').read()\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke_under_test', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "for node in ast.walk(ast.parse(src)):\n"
        "    if isinstance(node, ast.Import):\n"
        "        for alias in node.names: __import__(alias.name)\n"
        "    elif isinstance(node, ast.ImportFrom) and node.module:\n"
        "        __import__(node.module)\n"
        "loaded = [m for m, mod in sys.modules.items() if mod is not None]\n"
        "print(','.join(sorted(m for m in loaded if m == 'tcresnet_tpu'\n"
        "                      or m.startswith(('tcresnet_tpu.', 'jax', 'flax')))))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""
