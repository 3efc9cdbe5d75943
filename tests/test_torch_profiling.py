"""The port's FLOP count (`tcresnet_tpu_torch/utils/profiling.py`) against
the JAX package's `compiled_flops` (XLA's cost analysis) and against hand
counts from the layer shapes.

The convention is XLA's: a conv counts 2 x (Ci / groups) x Co for every
(sample, output position, tap) whose tap lands on the input, never on the
padding; a matmul 2 x M x K x N. Single convs and dots must equal JAX's
count exactly. A whole model counts less than JAX's, which also counts the
elementwise work (batch norm, ReLU, bias adds).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tcresnet_tpu.models import build_model as jax_build_model
from tcresnet_tpu.utils.profiling import compiled_flops as jax_compiled_flops
from tcresnet_tpu_torch.config import get_preset
from tcresnet_tpu_torch.models import build_model, layers
from tcresnet_tpu_torch.ops import dsp
from tcresnet_tpu_torch.utils import profiling
from tcresnet_tpu_torch.utils.profiling import compiled_flops, inference_flops, step_flops
from tests.test_torch_config import to_jax_config

META = torch.device("meta")

# JAX's whole forward at batch 1 (features -> logits, eval mode) exceeds the
# port's count by its elementwise operations: measured 1.44% (TCResNet8-1.0),
# 1.19% (Res15) and 2.22% (DSCNNL) of JAX's count
WHOLE_MODEL_MARGIN = 0.03


# ---------------------------------------------------------------------------
# hand counts, independent of the module under test
# ---------------------------------------------------------------------------


def same_geometry(n, k, stride, dilation=1):
    """TF-SAME: (out rows, left pad) of a k-tap conv over n rows."""
    span = (k - 1) * dilation + 1
    out = -(-n // stride)
    return out, max((out - 1) * stride + span - n, 0) // 2


def taps_on_input(n, k, stride=1, dilation=1):
    """(output row, tap) pairs of a TF-SAME conv whose tap reads an input
    row: per tap, the output rows o with 0 <= o * stride + j * dilation - lo < n."""
    out, lo = same_geometry(n, k, stride, dilation)
    total = 0
    for j in range(k):
        first = max(0, -(-(lo - j * dilation) // stride))
        last = min(out - 1, (n - 1 + lo - j * dilation) // stride)
        total += max(0, last - first + 1)
    return total


def conv2(taps_t, taps_f, ci, co):
    return 2 * taps_t * taps_f * ci * co


def tcresnet8_hand(coeffs=40, frames=98, channels=(16, 24, 32, 48), classes=12):
    """{layer: FLOPs} of TCResNet8's temporal convs and its fc, batch 1."""
    flops = {"conv0": 2 * taps_on_input(frames, 3) * coeffs * channels[0]}
    t, prev = frames, channels[0]
    for i, c in enumerate(channels[1:]):
        stride = 2 if c != prev else 1
        if c != prev:
            flops[f"block{i}_down"] = 2 * taps_on_input(t, 1, stride) * prev * c
        flops[f"block{i}_conv0"] = 2 * taps_on_input(t, 9, stride) * prev * c
        t = same_geometry(t, 9, stride)[0]
        flops[f"block{i}_conv1"] = 2 * taps_on_input(t, 9) * c * c
        prev = c
    flops["fc"] = 2 * prev * classes
    return flops


def res15_hand(frames=98, coeffs=40, channels=45, classes=12):
    flops = {"f_conv": conv2(taps_on_input(frames, 3), taps_on_input(coeffs, 3), 1, channels)}
    for idx in range(13):
        d = 2 ** (idx // 3)
        flops[f"conv{idx}"] = conv2(taps_on_input(frames, 3, 1, d),
                                    taps_on_input(coeffs, 3, 1, d), channels, channels)
    flops["fc"] = 2 * channels * classes
    return flops


def dscnnl_hand(frames=49, coeffs=10, c=276, classes=12):
    flops = {"conv_1": conv2(taps_on_input(frames, 10, 2), taps_on_input(coeffs, 4, 1), 1, c)}
    t, f = same_geometry(frames, 10, 2)[0], same_geometry(coeffs, 4, 1)[0]
    for i in range(1, 6):
        stride = 2 if i == 1 else 1
        flops[f"conv_ds_{i}_dw"] = conv2(taps_on_input(t, 3, stride),
                                         taps_on_input(f, 3, stride), 1, c)
        t, f = same_geometry(t, 3, stride)[0], same_geometry(f, 3, stride)[0]
        flops[f"conv_ds_{i}_pw"] = conv2(t, f, c, c)
    flops["fc1"] = 2 * c * classes
    return flops


HAND = {"TCResNet8-1.0": tcresnet8_hand, "Res15": res15_hand, "DSCNNL": dscnnl_hand}


# ---------------------------------------------------------------------------
# single convs and dots against XLA
# ---------------------------------------------------------------------------


def _jax_conv(x, w, stride, dilation, groups=1):
    return jax.lax.conv_general_dilated(x, w, stride, "SAME", rhs_dilation=dilation,
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        feature_group_count=groups)


def _xla_count(hw, kernel, stride, dilation, ci, co, groups=1):
    x = jnp.zeros((1,) + hw + (ci,), jnp.float32)
    w = jnp.zeros(kernel + (ci // groups, co), jnp.float32)
    return jax_compiled_flops(lambda x, w: _jax_conv(x, w, stride, dilation, groups), x, w)


@pytest.mark.parametrize("stride", [1, 2], ids=["same", "strided"])
def test_temporal_conv_equals_xla(stride):
    """A 9x1 TF-SAME conv over 98 rows, 16 -> 24 channels, through the
    port's layer (explicit F.pad, then the conv): XLA's count exactly;
    stride 1 is 2 (98 x 9 - 20) 16 x 24 = 662,016."""
    conv = layers.slim_conv(16, 24, (9, 1), (stride, 1), device=META)
    got = compiled_flops(conv, torch.empty(1, 16, 98, device=META))
    want = _xla_count((98, 1), (9, 1), (stride, 1), (1, 1), 16, 24)
    assert got == want
    if stride == 1:
        assert got == 662_016 == 2 * (98 * 9 - 20) * 16 * 24
    # PyTorch's own formula counts every tap, the padding included
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as plain:
        conv(torch.empty(1, 16, 98, device=META))
    assert plain.get_total_flops() > got


@pytest.mark.parametrize("dilation", [2, 16])
def test_dilated_conv_equals_xla(dilation):
    """Res15's 3x3 45 -> 45 conv over 98 x 40 at its dilations 2 and 16."""
    conv = layers.Conv2d(45, 45, (3, 3), dilation=dilation, device=META)
    got = compiled_flops(conv, torch.empty(1, 45, 98, 40, device=META))
    assert got == _xla_count((98, 40), (3, 3), (1, 1), (dilation, dilation), 45, 45)
    assert got == conv2(taps_on_input(98, 3, 1, dilation), taps_on_input(40, 3, 1, dilation),
                        45, 45)


def test_strided_depthwise_conv_equals_xla():
    """DSCNNL's depthwise 3x3 stride-2 conv (groups = channels), bias off."""
    conv = layers.Conv2d(276, 276, (3, 3), (2, 2), groups=276, device=META)
    got = compiled_flops(conv, torch.empty(1, 276, 25, 10, device=META))
    assert got == _xla_count((25, 10), (3, 3), (2, 2), (1, 1), 276, 276, groups=276)


def test_dense_layer_equals_xla_dot():
    """XLA counts a dot as 2 x M x K x N; so does the port."""
    a, b = np.zeros((3, 48), np.float32), np.zeros((48, 12), np.float32)
    want = jax_compiled_flops(lambda a, b: a @ b, jnp.asarray(a), jnp.asarray(b))
    assert want == 2 * 3 * 48 * 12
    fc = torch.nn.Linear(48, 12, bias=False, device=META)
    assert compiled_flops(fc, torch.empty(3, 48, device=META)) == want


def test_valid_taps_matches_the_hand_count():
    for n, k, s, d in [(98, 9, 1, 1), (98, 9, 2, 1), (49, 1, 2, 1), (40, 3, 1, 16), (25, 3, 2, 1)]:
        out, lo = same_geometry(n, k, s, d)
        assert profiling.valid_taps(n, k, s, d, lo, out) == taps_on_input(n, k, s, d)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


def _jax_forward_count(cfg, shape):
    jmodel = jax_build_model(to_jax_config(cfg.model), shape)
    x = jnp.zeros((1,) + shape, jnp.float32)
    variables = jmodel.init({"params": jax.random.key(0), "dropout": jax.random.key(1)}, x,
                            training=False)
    return jax_compiled_flops(lambda v, x: jmodel.apply(v, x, training=False), variables, x)


@pytest.mark.parametrize("name", sorted(HAND))
def test_forward_equals_the_hand_count_and_is_at_most_jax(name):
    """Eval-mode features -> logits at batch 1: exactly the hand count from
    the layer shapes; at most JAX's whole-forward count, within the
    elementwise margin."""
    cfg = get_preset(name)
    shape = dsp.feature_shape(cfg.audio)
    model = build_model(cfg.model, shape, device=META)
    got = compiled_flops(model, torch.empty((1,) + shape, device=META))
    assert got == sum(HAND[name]().values())
    jax_count = _jax_forward_count(cfg, shape)
    assert jax_count * (1 - WHOLE_MODEL_MARGIN) <= got <= jax_count


def test_counts_are_linear_in_batch():
    for name in ("TCResNet8-1.0", "DSCNNS", "KWSfpool3"):
        cfg = get_preset(name)
        assert inference_flops(cfg, 3) == 3 * inference_flops(cfg, 1)
        assert step_flops(cfg, 6) == 3 * step_flops(cfg, 2)


def test_front_end_equals_its_matmuls():
    """wav -> softmax less the model is the plain MFCC: the windowed DFT,
    the mel and the DCT as three matmuls over the frames."""
    cfg = get_preset("TCResNet8-1.0")
    a = cfg.audio
    frames = dsp.num_frames_for(a.desired_samples, a.window_size_samples,
                                a.window_stride_samples)
    bins = dsp.fft_length_for(a.window_size_samples) // 2 + 1
    front = 2 * frames * (a.window_size_samples * 2 * bins + bins * a.num_mel_bins
                          + a.num_mel_bins * a.num_mfccs)
    assert inference_flops(cfg, 1) == front + sum(tcresnet8_hand().values())


def test_step_count_is_the_same_for_every_backend():
    """The kernel config counts its plain path: the count cannot change
    with the backend a run uses."""
    cfg = get_preset("TCResNet8-1.0")
    kernels = cfg.replace(
        model=dataclasses.replace(cfg.model, conv_backend="pallas"),
        audio=dataclasses.replace(cfg.audio, dsp_backend="pallas", frontend_fuse="on"),
        augment=dataclasses.replace(cfg.augment, backend="pallas"),
        train=dataclasses.replace(cfg.train, compute_dtype="bfloat16"))
    assert step_flops(kernels, 1536) == step_flops(cfg, 1536)
    assert inference_flops(kernels, 8) == inference_flops(cfg, 8)


@pytest.mark.parametrize("name,dtype", [("TCResNet8-1.0", "bfloat16"), ("DSCNNS", "float32"),
                                        ("Res8", "float32")])
def test_step_count_equals_the_trainers_plain_step(name, dtype, tmp_path):
    """The meta-device count is the count of the step the Trainer runs: one
    `train_steps(1)` on the plain path (draws, augmentation, optimizer
    and EMA included), counted as it runs."""
    from tcresnet_tpu_torch.config import plain_config
    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset
    from tcresnet_tpu_torch.train.trainer import Trainer

    cfg = get_preset(name)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=4, max_step=10**9,
                                                compute_dtype=dtype))
    host = make_synthetic_dataset(num_samples=32, num_classes=12, desired_samples=16000)
    trainer = Trainer(plain_config(cfg), DeviceDataset(host, "cpu"), workdir=tmp_path)
    assert compiled_flops(trainer.train_steps, 1) == step_flops(cfg, 4)


def test_step_exceeds_the_forward_by_the_backward_convs():
    """A TCResNet8-1.0 step: the forward (front end included) plus each
    conv's dw and dx (none into the features: conv0 takes no dx) and the
    fc's two gradient matmuls."""
    cfg = get_preset("TCResNet8-1.0")
    hand = tcresnet8_hand()
    convs = sum(v for k, v in hand.items() if k != "fc")
    backward = 2 * convs - hand["conv0"] + 2 * hand["fc"]
    for batch in (1, 4):
        assert step_flops(cfg, batch) - inference_flops(cfg, batch) == batch * backward


def test_a_kernel_launch_inside_the_count_raises(monkeypatch):
    """A hand-written kernel is invisible to the count: a launch during it
    fails the count instead of leaving its work out."""
    from tcresnet_tpu_torch.ops.kernels import tconv

    def launches(x):
        tconv.fwd_launches += 1
        return x * 2

    monkeypatch.setattr(tconv, "fwd_launches", tconv.fwd_launches)
    with pytest.raises(RuntimeError, match="k7_fwd"):
        compiled_flops(launches, torch.empty(2, device=META))


def test_a_batch_norm_launch_inside_the_count_raises(monkeypatch):
    """Batch norm's kernels are no exception: a training step on a card
    launches them, so its count runs on the meta device (`step_flops`),
    where batch norm takes its plain version."""
    from tcresnet_tpu_torch.ops.kernels import batchnorm

    def launches(x):
        batchnorm.launches += 6
        return x.sum(0)

    monkeypatch.setattr(batchnorm, "launches", batchnorm.launches)
    with pytest.raises(RuntimeError, match="'bn': 6"):
        compiled_flops(launches, torch.empty(2, 3, device=META))


def test_failures_raise_instead_of_returning_none():
    def broken(x):
        raise ValueError("no such shape")

    with pytest.raises(ValueError, match="no such shape"):
        compiled_flops(broken, torch.empty(1, device=META))
    assert math.isfinite(compiled_flops(lambda x: x @ x, torch.empty(4, 4, device=META)))
