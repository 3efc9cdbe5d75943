"""The committed JAX golden for K5, the 2D families' kernel.

tcresnet_tpu_torch/testdata/infer2d_golden.npz holds the JAX package's
softmax ("xla" path, precision="highest", on the CPU) for seeded wavs at
full preset geometry, batch 2, weights from `seeded_variables`: one
preset per family. It stores only the seeds and the outputs: the wavs and
the weights are made again from the seeds with numpy, here and on a
machine without JAX (chip_smoke.py phase 18).

Regenerate with:  JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_golden2d.py
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tcresnet_tpu import config as jconfig
from tcresnet_tpu.serve.export import build_inference_fn as jax_build_inference_fn
from tcresnet_tpu_torch.config import get_preset
from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
from tcresnet_tpu_torch.ops import dsp as tdsp
from tcresnet_tpu_torch.serve.export import build_inference_fn

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent.parent / (
    "tcresnet_tpu_torch/testdata/infer2d_golden.npz"
)
PRESETS = ("TCResNet2D8-1.0", "Res15Narrow", "DSCNNS", "KWSfpool3")
PARAM_SEED, WAV_SEED, BATCH = 0, 1, 2


def _inputs(preset):
    cfg = get_preset(preset)
    variables = seeded_variables(cfg.model, tdsp.feature_shape(cfg.audio), PARAM_SEED)
    wavs = np.random.default_rng(WAV_SEED).uniform(
        -1, 1, (BATCH, cfg.audio.desired_samples)).astype(np.float32)
    return cfg, variables, wavs


def compute_golden() -> dict:
    softmax = []
    for preset in PRESETS:
        _, variables, wavs = _inputs(preset)
        fn = jax_build_inference_fn(jconfig.get_preset(preset), variables, backend="xla",
                                    precision="highest")
        softmax.append(np.asarray(jax.device_get(fn(wavs)), np.float32))
    return dict(presets=np.array(PRESETS), param_seed=np.array(PARAM_SEED),
                wav_seed=np.array(WAV_SEED), batch=np.array(BATCH), softmax=np.stack(softmax))


def test_golden_file_matches_jax():
    """Recomputed JAX softmax equals the committed one within 1e-6, ten
    times under the 1e-5 gate the golden is used for."""
    want = np.load(GOLDEN)
    got = compute_golden()
    assert [str(p) for p in want["presets"]] == list(PRESETS)
    for key in ("param_seed", "wav_seed", "batch"):
        assert int(want[key]) == int(got[key])
    assert want["softmax"].shape == (len(PRESETS), BATCH, 12)
    np.testing.assert_allclose(got["softmax"], want["softmax"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("preset", PRESETS)
def test_port_plain_paths_match_golden(preset):
    """The port's plain path and K5's plain version (behind K2's), on the
    CPU, meet the golden within the 1e-5 gate that the card's kernel must."""
    cfg, variables, wavs = _inputs(preset)
    golden = np.load(GOLDEN)["softmax"][PRESETS.index(preset)]
    v = variables_from_jax(cfg.model, **variables)
    x = torch.tensor(wavs)
    for backend in ("xla", "fused"):
        fn = build_inference_fn(cfg, v, backend=backend, device="cpu")
        with torch.no_grad():
            np.testing.assert_allclose(fn(x).numpy(), golden, rtol=0, atol=1e-5)


if __name__ == "__main__":
    np.savez(GOLDEN, **compute_golden())
    print(f"wrote {GOLDEN}")
