"""Streaming SVDF of the port (tcresnet_tpu_torch.serve.streaming) against
the batch model and against the JAX package's streaming_step, on the KWS
geometry of tests/test_streaming.py (49 frames x 40 MFCCs, 2,560 filters).

Tolerances: 1e-5 on softmax where both sides compute the same sums (the
JAX step, the batch model over a full window, as tests/test_streaming.py
holds JAX's); 1e-4 for a window fed in chunks against one fed at once, as
JAX's own test (the frequency filter's sums split across calls)."""

import numpy as np
import pytest
import torch

from tcresnet_tpu.serve import streaming as jstreaming
from tcresnet_tpu_torch.config import ModelConfig
from tcresnet_tpu_torch.models import build_model
from tcresnet_tpu_torch.models.convert import seeded_variables, variables_from_jax
from tcresnet_tpu_torch.serve import streaming

torch.set_num_threads(1)

SHAPE = (49, 40, 1)
SOFTMAX_ATOL = 1e-5
CHUNK_ATOL = 1e-4


def _setup(seed=0):
    cfg = ModelConfig(name="KWS", kws_architecture="low_latency_svdf", num_classes=12)
    seeded = seeded_variables(cfg, SHAPE, seed)
    v = variables_from_jax(cfg, **seeded)
    model = build_model(cfg, SHAPE, device="cpu")
    model.load_state_dict({**v["params"], **v["batch_stats"]})
    return model, v["params"], seeded["params"]


def _frames(seed, t=SHAPE[0]):
    return np.random.default_rng(seed).normal(size=(t, SHAPE[1])).astype(np.float32)


def test_full_window_matches_batch_path():
    model, params, jparams = _setup()
    frames = _frames(0)
    with torch.no_grad():
        batch = torch.softmax(model(torch.tensor(frames)[None, :, :, None])[0], -1).numpy()
    probs, mem = streaming.streaming_step(params, streaming.init_state(SHAPE[0], device="cpu"),
                                          torch.tensor(frames))
    np.testing.assert_allclose(probs.numpy(), batch, rtol=0, atol=SOFTMAX_ATOL)
    jprobs, jmem = jstreaming.streaming_step(jparams, jstreaming.init_state(SHAPE[0]), frames)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0, atol=SOFTMAX_ATOL)
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), rtol=0, atol=SOFTMAX_ATOL)


@pytest.mark.parametrize("chunk", [1, 7])
def test_incremental_chunks_match_full_window(chunk):
    """49 frames fed in chunks equal them fed at once, once a full window
    has streamed; every step equals JAX's step from the same memory."""
    _, params, jparams = _setup()
    frames = _frames(1)
    full, _ = streaming.streaming_step(params, streaming.init_state(SHAPE[0], device="cpu"),
                                       torch.tensor(frames))
    mem = streaming.init_state(SHAPE[0], device="cpu")
    for i in range(0, SHAPE[0], chunk):
        jprobs, jmem = jstreaming.streaming_step(jparams, mem.numpy(),
                                                 frames[i:i + chunk])
        probs, mem = streaming.streaming_step(params, mem, torch.tensor(frames[i:i + chunk]))
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0, atol=SOFTMAX_ATOL)
        np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), rtol=0, atol=SOFTMAX_ATOL)
    np.testing.assert_allclose(probs.numpy(), full.numpy(), rtol=0, atol=CHUNK_ATOL)


def test_step_shapes_and_state():
    """The step keeps the memory's shape, returns a distribution, and
    leaves the caller's memory as it was; the state's device is explicit."""
    _, params, _ = _setup()
    mem = streaming.init_state(SHAPE[0], device="cpu")
    assert mem.shape == (2560, SHAPE[0]) and mem.dtype == torch.float32 and not mem.any()
    probs, mem2 = streaming.streaming_step(params, mem, torch.ones(7, SHAPE[1]))
    assert probs.shape == (12,) and mem2.shape == mem.shape
    np.testing.assert_allclose(float(probs.sum()), 1.0, atol=1e-5)
    assert not mem.any() and mem2[:, -7:].any() and not mem2[:, :-7].any()
    with pytest.raises(ValueError, match="device"):
        streaming.init_state(SHAPE[0], device=None)
