"""The committed JAX golden for the PyTorch port's card check.

tcresnet_tpu_torch/testdata/tcresnet8_golden.npz holds the JAX package's
softmax for seeded wavs at full TCResNet8-1.0 geometry, with weights from
`seeded_variables`. It stores only the seeds and the outputs: the wavs
and the weights are made again from the seeds with numpy, here and on a
machine without JAX (tests/test_torch_cuda.py::test_k4_meets_the_jax_golden).
This test recomputes it
with the JAX XLA path at precision="highest".

Regenerate with:  JAX_PLATFORMS=cpu python tests/test_torch_golden.py
"""

from pathlib import Path

import jax
import numpy as np
import torch

from tcresnet_tpu import config as jconfig
from tcresnet_tpu.serve.export import build_inference_fn as jax_build_inference_fn
from tcresnet_tpu_torch.config import get_preset
from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
from tcresnet_tpu_torch.ops import dsp as tdsp
from tcresnet_tpu_torch.serve.export import build_inference_fn

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent.parent / (
    "tcresnet_tpu_torch/testdata/tcresnet8_golden.npz"
)
PRESET, PARAM_SEED, WAV_SEED, BATCH = "TCResNet8-1.0", 0, 1, 4


def _inputs():
    cfg = get_preset(PRESET)
    variables = seeded_variables(cfg.model, tdsp.feature_shape(cfg.audio), PARAM_SEED)
    wavs = np.random.default_rng(WAV_SEED).uniform(
        -1, 1, (BATCH, cfg.audio.desired_samples)).astype(np.float32)
    return cfg, variables, wavs


def compute_golden() -> dict:
    cfg, variables, wavs = _inputs()
    fn = jax_build_inference_fn(jconfig.get_preset(PRESET), variables, backend="xla",
                                precision="highest")
    softmax = np.asarray(jax.device_get(fn(wavs)), np.float32)
    return dict(preset=np.array(PRESET), param_seed=np.array(PARAM_SEED),
                wav_seed=np.array(WAV_SEED), batch=np.array(BATCH), softmax=softmax)


def test_golden_file_matches_jax():
    """Recomputed JAX softmax equals the committed one. The 1e-6 bound is
    ten times under the 1e-5 gate the golden is used for, and leaves room
    for last-bit differences between CPU instruction sets."""
    want = np.load(GOLDEN)
    got = compute_golden()
    assert str(want["preset"]) == PRESET
    for key in ("param_seed", "wav_seed", "batch"):
        assert int(want[key]) == int(got[key])
    assert want["softmax"].shape == (BATCH, 12)
    np.testing.assert_allclose(got["softmax"], want["softmax"], rtol=0, atol=1e-6)


def test_port_plain_paths_match_golden():
    """The port's plain path and the kernel's plain version, on the CPU,
    meet the golden within the 1e-5 gate that the card's kernel must."""
    cfg, variables, wavs = _inputs()
    golden = np.load(GOLDEN)["softmax"]
    v = variables_from_jax(cfg.model, **variables)
    x = torch.tensor(wavs)
    for backend in ("xla", "fused"):
        fn = build_inference_fn(cfg, v, backend=backend, device="cpu")
        np.testing.assert_allclose(fn(x).numpy(), golden, rtol=0, atol=1e-5)


if __name__ == "__main__":
    np.savez(GOLDEN, **compute_golden())
    print(f"wrote {GOLDEN}")
