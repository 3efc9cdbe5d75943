"""The port's entry points (tcresnet_tpu_torch/graft_entry.py) on
the CPU: entry()'s serving function against the JAX package's, and the
multi-chip dry run on two gloo ranks."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tcresnet_tpu.serve.export import build_inference_fn as jax_build_inference_fn
from tcresnet_tpu_torch import graft_entry
from tcresnet_tpu_torch.config import get_preset
from tcresnet_tpu_torch.models.convert import seeded_variables
from tcresnet_tpu_torch.ops import dsp
from tests.test_torch_config import to_jax_config

torch.set_num_threads(1)


def test_entry_serves_tcresnet8_as_the_jax_package_does():
    """entry("cpu"): 8 wavs in [-1, 1) from default_rng(0) and the "auto"
    serving function (the plain path on the CPU), softmax within 1e-5 of
    the JAX package's build_inference_fn on the same seeded weights."""
    forward, (wavs,) = graft_entry.entry("cpu")
    assert wavs.shape == (8, 16000) and wavs.device.type == "cpu"
    want_wavs = np.random.default_rng(0).uniform(-1, 1, (8, 16000)).astype(np.float32)
    np.testing.assert_array_equal(wavs.numpy(), want_wavs)
    probs = forward(wavs)
    assert probs.shape == (8, 12)
    np.testing.assert_allclose(probs.sum(-1).numpy(), np.ones(8), atol=1e-5)

    cfg = get_preset("TCResNet8-1.0")
    seeded = seeded_variables(cfg.model, dsp.feature_shape(cfg.audio), 0)
    jfn = jax_build_inference_fn(to_jax_config(cfg), jax.tree_util.tree_map(jnp.asarray, seeded),
                                 include_preprocess=True, backend="xla", precision="highest")
    np.testing.assert_allclose(probs.numpy(), np.asarray(jfn(jnp.asarray(want_wavs))),
                               rtol=0, atol=1e-5)


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    """dryrun_multichip(2, device="cpu"): two gloo CPU ranks run a DP
    step with EMA, a step on the {data 1, model 2} mesh, DP steps through
    K3 (its plain version here) on both meshes, and K3 per rank equal to
    one call bit for bit."""
    res = graft_entry.dryrun_multichip(2, device="cpu", timeout=120)
    assert res["backend"] == "gloo" and res["devices"] == ["cpu", "cpu"]
    assert res["tp_mesh"] == {"data": 1, "model": 2}
    for key in ("dp_loss", "tp_loss", "k3_loss", "k3_tp_loss"):
        assert np.isfinite(res[key]), key
    assert res["k3_batch"] == 16 and res["kernel_batch"] == 32
    out = capsys.readouterr().out
    assert out.count("dryrun_multichip(2)") == 4 and "bit for bit" in out
