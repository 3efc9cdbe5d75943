"""Batch norm in training mode, with an optional ReLU, as one autograd
Function (`tcresnet_tpu_torch/ops/kernels/batchnorm.py`, kernels in
`csrc/batchnorm.cu`).

On the CPU: the plain version's hand-written gradient against autograd's
numerical one in float64, its forward and running statistics bit-equal to
the op-by-op composition `SlimBatchNorm` ran before, the kernels' grid plan
and the layouts they take. Its gradient against Flax's is in
tests/test_torch_train2d.py (a dead channel, every 2D family) and
tests/test_torch_parallel.py (over ranks).

On the card (`cuda` marker; skipped without one): the kernels against the
plain version at DS-CNN L's and TC-ResNet's layer shapes at a small batch,
float32 and bfloat16, with a channel of zeros; their launch count; that a
CUDA tensor never reaches the plain version; two calls bit-equal. This file
imports no JAX.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tcresnet_tpu_torch.models.layers import SlimBatchNorm
from tcresnet_tpu_torch.ops.kernels import batchnorm as kb
from tcresnet_tpu_torch.ops.kernels import launch_counts, launches_since

torch.set_num_threads(1)

# (center, scale): Res's batch norm has neither, DS-CNN's a shift, TC-ResNet's both
AFFINE = [(False, False), (True, False), (True, True)]
H100_SMS = 132


def _composition(x, weight, bias, running_mean, running_var, momentum, relu, dtype):
    """SlimBatchNorm's training branch as it was composed op by op, then F.relu."""
    axes = [0] + list(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    xf = x.to(torch.float32)
    mean, mean_sq = xf.mean(axes), (xf * xf).mean(axes)
    var = torch.maximum(mean_sq - mean * mean, torch.zeros_like(mean))
    with torch.no_grad():
        running_mean.copy_(momentum * running_mean + (1.0 - momentum) * mean)
        running_var.copy_(momentum * running_var + (1.0 - momentum) * var)
    mul = torch.rsqrt(var + kb.EPS)
    if weight is not None:
        mul = mul * weight
    y = (xf - mean.view(shape)) * mul.view(shape)
    if bias is not None:
        y = y + bias.view(shape)
    y = y.to(dtype)
    return F.relu(y) if relu else y


def _inputs(shape, dtype, seed, device="cpu", zero_channel=1):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal(shape).astype(np.float32) * 2 + 0.5)
    x[:, zero_channel] = 0.0
    c = shape[1]
    weight = torch.tensor(rng.uniform(0.5, 1.5, c).astype(np.float32))
    bias = torch.tensor(rng.standard_normal(c).astype(np.float32))
    dy = torch.tensor(rng.standard_normal(shape).astype(np.float32))
    return (x.to(dtype).to(device), weight.to(device), bias.to(device), dy.to(dtype).to(device))


# ---------------------------------------------------------------------------
# the plain version (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("center,scale", AFFINE)
@pytest.mark.parametrize("shape", [(5, 3, 4), (3, 2, 4, 3)])
def test_plain_gradient_matches_the_numerical_one(shape, center, scale, relu):
    """The hand-written backward of x, scale and shift against
    `torch.autograd.gradcheck`'s finite differences, in float64."""
    gen = torch.Generator().manual_seed(len(shape) * 10 + 2 * center + scale)
    c = shape[1]
    x = torch.randn(shape, dtype=torch.float64, generator=gen).requires_grad_(True)
    weight = (torch.rand(c, dtype=torch.float64, generator=gen) + 0.5).requires_grad_(scale)
    bias = torch.randn(c, dtype=torch.float64, generator=gen).requires_grad_(center)
    running = (torch.zeros(c, dtype=torch.float64), torch.ones(c, dtype=torch.float64))
    args = (x,) + ((weight,) if scale else ()) + ((bias,) if center else ())

    def fn(*a):
        return kb.batch_norm_train(a[0], a[1] if scale else None, a[-1] if center else None,
                                   *running, 0.9, relu, torch.float64)

    assert torch.autograd.gradcheck(fn, args)


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("center,scale", AFFINE)
def test_plain_forward_and_running_statistics_equal_the_composition(center, scale, dtype,
                                                                    layout):
    """y and both running statistics bit-equal to the composition the
    Function replaced (the same operations on the tensor's own layout), in
    a 2D model's two layouts, with a channel of zeros."""
    x, weight, bias, _ = _inputs((4, 6, 5, 3), dtype, seed=3)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    weight = weight if scale else None
    bias = bias if center else None
    for relu in (False, True):
        want_stats = (torch.full((6,), 0.25), torch.full((6,), 2.0))
        got_stats = tuple(t.clone() for t in want_stats)
        want = _composition(x, weight, bias, *want_stats, 0.96, relu, dtype)
        got = kb.batch_norm_train(x, weight, bias, *got_stats, 0.96, relu, dtype)
        assert got.dtype == dtype
        assert torch.equal(got, want)
        for g, w in zip(got_stats, want_stats):
            assert torch.equal(g, w)


def test_slim_batch_norm_routes_training_through_the_function_and_keeps_eval():
    """Training mode takes the Function (its span, its relu); eval mode the
    running statistics, then F.relu where asked."""
    from tcresnet_tpu_torch.utils.profiling import drain, tracing

    x, _, _, _ = _inputs((4, 6, 7), torch.float32, seed=4)
    bn = SlimBatchNorm(6, momentum=0.9).train()
    with tracing():
        y = bn(x, relu=True)
        spans = [(r["name"], r["attrs"]) for r in drain()]
    assert spans == [("model.batch_norm", {"phase": "forward", "channels": 6})]
    assert (y >= 0).all() and (y == 0).any()
    bn.eval()
    plain = bn(x)
    assert torch.equal(bn(x, relu=True), F.relu(plain))
    assert not torch.equal(plain, F.relu(plain))


def test_a_meta_tensor_takes_the_plain_version():
    """The FLOP counts run the model on the meta device: no kernel launch."""
    before = launch_counts()
    x = torch.empty(8, 6, 5, 3, device="meta", requires_grad=True)
    running = (torch.zeros(6, device="meta"), torch.ones(6, device="meta"))
    y = kb.batch_norm_train(x, None, torch.zeros(6, device="meta"), *running, 0.9, True)
    y.sum().backward()
    assert x.grad.shape == x.shape
    assert launches_since(before) == {}


@pytest.mark.parametrize("shape,last", [((4096, 276, 13, 5), False), ((4096, 276, 25, 10), False),
                                        ((4096, 276, 25, 10), True), ((8192, 16, 98), False),
                                        ((8192, 48, 13), False), ((3, 45, 98, 40), False),
                                        ((1, 5, 7), False), ((2, 64, 3, 3), True),
                                        ((0, 16, 98), False)])
def test_plan_covers_every_unit_once_and_fills_the_card(shape, last):
    """The reductions' chunks cover each sample (rows, channels-last) once,
    none empty; the grid fits CUDA's limits and, at the card shapes, fills
    a wave of the H100's 132 x 8 block slots at least; the elementwise grid
    is one wave at most and has a block of 4-element vectors for each."""
    b, c = shape[:2]
    inner = int(np.prod(shape[2:]))
    p = kb.plan(b, c, inner, H100_SMS, last)
    units = b * inner if last else b
    assert p.groups == (-(-c // 32) if last else c)
    assert 1 <= p.chunks <= 65535 and p.groups <= 65535
    if units:
        assert (p.chunks - 1) * p.per < units <= p.chunks * p.per
    else:
        assert p.chunks == 1
    assert 1 <= p.grid <= 8 * H100_SMS
    assert p.grid * kb.THREADS * 4 >= min(b * c * inner, 8 * H100_SMS * kb.THREADS * 4)
    if b >= 4096:
        assert p.groups * p.chunks >= 8 * H100_SMS


def test_kernel_layout_keeps_the_two_layouts_and_copies_any_other():
    x = torch.randn(2, 3, 4, 5)
    last = x.contiguous(memory_format=torch.channels_last)
    assert kb.kernel_layout(x) is x
    assert kb.kernel_layout(last) is last
    strided = x[:, :, ::2]
    got = kb.kernel_layout(strided)
    assert got.is_contiguous() and torch.equal(got, strided)
    three = torch.randn(2, 4, 3).transpose(1, 2)
    assert kb.kernel_layout(three).is_contiguous()


# ---------------------------------------------------------------------------
# the kernels (card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the batch-norm kernels have no CPU mode")
    return torch.device("cuda", 0)


# DS-CNN L's layers (its first conv returns a channels-last map) and
# TC-ResNet8's narrowest and widest, at a small batch; and TC-ResNet8's
# first layer at 1,024 samples, which plans 24 sample chunks of 43, the
# last one of 35 (a contiguous map of one chunk at 16-64 samples)
CARD_CASES = [((16, 276, 13, 5), "contiguous", (True, False)),
              ((16, 276, 25, 10), "channels_last", (True, False)),
              ((16, 276, 25, 10), "contiguous", (True, False)),
              ((64, 16, 98), "contiguous", (True, True)),
              ((64, 48, 13), "contiguous", (True, True)),
              ((8, 45, 23, 20), "contiguous", (False, False)),
              ((1024, 16, 98), "contiguous", (True, True))]
CARD_IDS = ["dscnn_pw", "dscnn_first_nhwc", "dscnn_first", "tc_first", "tc_last", "res",
            "tc_first_chunks"]
# float32: the kernels sum in float64 where the plain version sums in float32
# (torch's order), so mean and rstd differ in their last bits and y by a few
# ulps of its magnitude; dx also comes from sums over 8-1,024 samples, within
# 1e-5 of max|dx|. bfloat16: y is rounded to 8 bits, so those ulps can move
# it by one bfloat16 step (2^-8 relative); dx by one step of max|dx|.
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2 ** -7, atol=2 ** -7)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,layout,affine", CARD_CASES, ids=CARD_IDS)
def test_kernels_match_the_plain_version(cuda_device, shape, layout, affine, dtype):
    """y, the saved statistics and both running statistics against the
    plain version on the card; then dx, dscale and dshift against the plain
    backward from the kernels' own statistics (so both mask the same y);
    the zero channel's variance is exactly 0 on both (the clip's tie)."""
    center, scale = affine
    x, weight, bias, dy = _inputs(shape, dtype, seed=sum(shape), device=cuda_device)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
        dy = dy.contiguous(memory_format=torch.channels_last)
    weight = weight if scale else None
    bias = bias if center else None
    c = shape[1]
    tol = TOL[dtype]
    for relu in (False, True):
        run_k = (torch.full((c,), 0.25, device=cuda_device), torch.ones(c, device=cuda_device))
        run_p = tuple(t.clone() for t in run_k)
        y_k, stats_k = kb.kernel_forward(kb.kernel_layout(x), weight, bias, *run_k, 0.96, relu,
                                         dtype, None)
        y_p, stats_p = kb.plain_forward(x, weight, bias, *run_p, 0.96, relu, dtype, None)
        torch.cuda.synchronize()
        assert y_k.dtype == dtype and y_k.stride() == x.stride()
        torch.testing.assert_close(y_k.float(), y_p.float(), **tol)
        torch.testing.assert_close(stats_k, stats_p, rtol=1e-5, atol=1e-6)
        assert stats_k[2 * c + 1] == 0.5 and stats_k[3 * c] == x.numel() // c
        for k, p in zip(run_k, run_p):
            torch.testing.assert_close(k, p, rtol=1e-6, atol=1e-6)
        dx_k, dw_k, db_k = kb.kernel_backward(dy, kb.kernel_layout(x), weight, bias, stats_k,
                                              relu, None)
        dx_p, dw_p, db_p = kb.plain_backward(dy, x, weight, bias, stats_k, relu, None)
        torch.cuda.synchronize()
        scale_dx = float(dx_p.float().abs().max())
        torch.testing.assert_close(dx_k.float(), dx_p.float(), rtol=tol["rtol"],
                                   atol=tol["atol"] * scale_dx)
        for k, p in ((dw_k, dw_p), (db_k, db_p)):
            assert (k is None) == (p is None)
            if k is not None:  # float32 sums over the batch of terms of both signs: they
                # cancel to ~1% of their size, so their last bits reach 1e-4 of the largest
                torch.testing.assert_close(k, p, rtol=1e-4, atol=1e-4 * float(p.abs().max()))


@pytest.mark.cuda
def test_function_launches_six_kernels_bit_reproducibly(cuda_device, monkeypatch):
    """One forward and backward through SlimBatchNorm launches 6 kernels
    (counted under `bn`), never the plain version, and a second call gives
    the same bits."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(kb, "plain_forward", refuse)
    monkeypatch.setattr(kb, "plain_backward", refuse)
    x0, _, _, dy = _inputs((64, 276, 13, 5), torch.float32, seed=5, device=cuda_device)
    outs = []
    for _ in range(2):
        bn = SlimBatchNorm(276, momentum=0.96, scale=False, device=cuda_device).train()
        x = x0.clone().requires_grad_(True)
        before = launch_counts()
        y = bn(x, relu=True)
        y.backward(dy)
        torch.cuda.synchronize()
        assert launches_since(before) == {"bn": 6}
        outs.append((y, x.grad, bn.bias.grad, bn.running_mean, bn.running_var))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
