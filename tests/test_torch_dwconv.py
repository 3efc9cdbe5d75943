"""The depthwise 3x3 conv for training as one autograd Function
(`tcresnet_tpu_torch/ops/kernels/dwconv.py`, kernels in `csrc/dwconv.cu`),
which `models/layers.py::Conv2d` runs on a card in place of F.pad,
F.conv2d over the channels and a bias (the composition it keeps
elsewhere).

On the CPU: which convs `Conv2d` picks (and that the CPU keeps them on
the composition); the FLOPs the kernels' operators count equal to the
composition's, which the meta device counts; the tile and grid plan, its
work items and the ctypes mirror.

On the card (`cuda` marker; skipped without one): the kernels against the
composition in float64 at the benchmarked step's shapes, at batches 1 and
7 and at DS-CNN S's and M's shapes, float32 and bfloat16; only the wanted
gradients; dW and db the same bits twice; three launches a forward and
backward; a map the kernels cannot hold refused; and a DSCNNL training
step launching 15 of them and none of the library's depthwise kernels.
This file imports no JAX.
"""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from tcresnet_tpu_torch.models import ds_cnn
from tcresnet_tpu_torch.models.layers import Conv2d, same_padding_2d
from tcresnet_tpu_torch.ops.kernels import dwconv as kd
from tcresnet_tpu_torch.ops.kernels import launch_counts, launches_since
from tcresnet_tpu_torch.utils.profiling import _ConvCount

torch.set_num_threads(1)

H100_SMS = 132


def _depthwise_shapes(net_def, hw):
    """(C, (H, W), stride) of each depthwise conv of a DS-CNN over an
    MFCC map of `hw` frames x coefficients."""
    h, w = hw
    out, c = [], 1
    for b in net_def:
        if b.type == "separable":
            out.append((c, (h, w), b.stride))
        h, w = -(-h // b.stride[0]), -(-w // b.stride[1])
        c = b.depth
    return out


# every depthwise conv of DS-CNN S, M and L on 1 s clips at 40/20 ms (49 x 10
# MFCC-10): S's at 25x5 stride 1, M's first at 25x10 stride 2 (an asymmetric
# pad along F: 0 low, 1 high) then 13x5, L's the same at 276 channels
DS_SHAPES = sorted(set(s for net in (ds_cnn.S_NET_DEF, ds_cnn.M_NET_DEF, ds_cnn.L_NET_DEF)
                       for s in _depthwise_shapes(net, (49, 10))))


def _inputs(c, hw, stride, batch, dtype=torch.float32, seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed + c + hw[0] * 7 + stride[0])
    pads = same_padding_2d(hw, (3, 3), stride)
    oh, ow = (-(-n // s) for n, s in zip(hw, stride))
    x = torch.randn(batch, c, *hw, generator=gen)
    w = torch.randn(c, 1, 3, 3, generator=gen) * 0.3
    b = torch.randn(c, generator=gen)
    dy = torch.randn(batch, c, oh, ow, generator=gen)
    return (x.to(dtype).to(device), w.to(dtype).to(device), b.to(dtype).to(device),
            dy.to(dtype).to(device), pads)


def _composition(x, w, b, stride, pads, dy):
    """Conv2d's depthwise conv as it was composed: F.pad, F.conv2d with the
    bias, and autograd's gradients."""
    x, w = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    b = None if b is None else b.detach().requires_grad_(True)
    y = F.conv2d(F.pad(x, pads), w, b, stride=stride, groups=x.shape[1])
    grads = torch.autograd.grad(y, [t for t in (x, w, b) if t is not None], dy)
    return (y,) + tuple(grads) + ((None,) if b is None else ())


def _count(fn, *args) -> int:
    with FlopCounterMode(display=False, custom_mapping=_ConvCount().mapping()) as fc:
        fn(*args)
    return int(fc.get_total_flops())


@pytest.mark.parametrize("c,hw,stride", DS_SHAPES, ids=[f"{c}x{h}x{w}_s{s[0]}"
                                                        for c, (h, w), s in DS_SHAPES])
def test_meta_route_and_kernel_operators_count_the_compositions_flops(c, hw, stride):
    """On the meta device (the FLOP count's) `Conv2d` keeps the
    composition and counts, forward and backward, its FLOPs at
    `aten.convolution`; the kernels' operators' formulas (what a count on
    the card reads) count the same for the forward, and for dx and dW."""
    pads = same_padding_2d(hw, (3, 3), stride)
    oh, ow = (-(-n // s) for n, s in zip(hw, stride))

    def step(fn):
        def run():
            x = torch.empty(4, c, *hw, device="meta", requires_grad=True)
            w = torch.empty(c, 1, 3, 3, device="meta", requires_grad=True)
            b = torch.empty(c, device="meta", requires_grad=True)
            y = fn(x, w, b)
            torch.autograd.grad(y, [x, w, b], torch.empty_like(y))
        return run

    composed = _count(step(lambda x, w, b: F.conv2d(F.pad(x, pads), w, b, stride=stride,
                                                    groups=c)))

    def routed():
        m = Conv2d(c, c, (3, 3), stride, groups=c, bias=True, device="meta")
        x = torch.empty(4, c, *hw, device="meta", requires_grad=True)
        y = m(x)
        y.backward(torch.empty_like(y))  # autograd.grad refuses FlopCounterMode's module hooks

    assert _count(routed) == composed > 0
    formulas = _ConvCount().mapping()
    x = torch.empty(4, c, *hw, device="meta")
    w = torch.empty(c, 1, 3, 3, device="meta")
    y = torch.empty(4, c, oh, ow, device="meta")
    fwd = formulas[kd.forward_op](x, w, None, list(stride), list(pads), out_val=y)
    bwd = formulas[kd.backward_op](y, x, w, list(stride), list(pads), [True, True, True],
                                   out_val=None)
    assert fwd + bwd == composed and bwd == 2 * fwd
    assert formulas[kd.backward_op](y, x, w, list(stride), list(pads), [False, True, True],
                                    out_val=None) == fwd


def _conv_nodes(model, x):
    """Each Conv2d of `model` by name: whether it picks the kernels'
    conv (`_depthwise_3x3`) and its output's grad_fn, for input x."""
    seen = {}
    for name, m in model.named_modules():
        if isinstance(m, Conv2d):
            m.register_forward_hook(lambda mod, inp, out, name=name: seen.__setitem__(
                name, (mod._depthwise_3x3(inp[0]), type(out.grad_fn).__name__)))
    model(x)
    return seen


NETS = [(ds_cnn.S_NET_DEF, (49, 10)), (ds_cnn.L_NET_DEF, (49, 10)), (ds_cnn.M_NET_DEF, (7, 10))]


@pytest.mark.parametrize("net_def,hw", NETS)
def test_conv2d_routes_every_ds_cnn_depthwise_conv_to_the_function(net_def, hw):
    """`Conv2d` picks each DS-CNN's depthwise convs, and not its first conv
    or its 1x1 convs; on the CPU every one keeps the composition
    (autograd's convolution node)."""
    seen = _conv_nodes(ds_cnn.DSCNN(4, net_def).train(), torch.randn(2, *hw, 1))
    for name, (picked, node) in seen.items():
        assert picked == name.endswith("_dw") and node == "ConvolutionBackward0", name
    assert sum(n.endswith("_dw") for n in seen) == sum(b.type == "separable" for b in net_def)


@pytest.mark.parametrize("conv", [
    dict(ci=45, co=45, kernel=(3, 3), dilation=2),  # Res15's dilated 3x3
    dict(ci=45, co=45, kernel=(3, 3)),  # a full 3x3
    dict(ci=8, co=8, kernel=(1, 1), groups=8),  # a depthwise 1x1
    dict(ci=8, co=16, kernel=(1, 1)),  # a pointwise conv
    dict(ci=8, co=8, kernel=(3, 3), groups=8, padding="VALID"),
    dict(ci=8, co=8, kernel=(3, 3), groups=8, stride=(3, 3)),
    dict(ci=8, co=8, kernel=(3, 3), groups=8, dilation=2),
    dict(ci=8, co=16, kernel=(3, 3), groups=8),  # a channel multiplier of 2
    dict(ci=1, co=1, kernel=(3, 3), groups=1),
])
def test_conv2d_keeps_every_other_conv_on_autograds_composition(conv):
    ci, co, kernel = conv.pop("ci"), conv.pop("co"), conv.pop("kernel")
    m = Conv2d(ci, co, kernel, **conv)
    x = torch.randn(2, ci, 9, 8)
    assert not m._depthwise_3x3(x)
    assert type(m(x).grad_fn).__name__ == "ConvolutionBackward0"


def test_conv2d_keeps_maps_the_kernels_cannot_hold_on_the_composition():
    """A depthwise conv over maps too large for the kernels' shared memory
    is still picked: on a card the kernels refuse it (the card test
    below), on the CPU it keeps the composition."""
    m = Conv2d(4, 4, (3, 3), groups=4)
    x = torch.randn(1, 4, 200, 100)
    assert m._depthwise_3x3(x)
    with pytest.raises(ValueError, match="does not fit the kernel's shared memory"):
        kd.tile(True, 1, 4, (200, 100), (200, 100), 4, 1)
    kd.tile(True, 1, 4, (25, 10), (25, 10), 4, 1)
    assert type(m(x).grad_fn).__name__ == "ConvolutionBackward0"


CARD_SHAPES = [(276, (25, 10), (2, 2)), (276, (13, 5), (1, 1)), (172, (25, 10), (2, 2)),
               (64, (25, 5), (1, 1)), (6, (7, 10), (2, 2)), (3, (5, 4), (1, 1)),
               (276, (1, 1), (1, 1))]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("batch", [1, 7, 4096])
@pytest.mark.parametrize("c,hw,stride", CARD_SHAPES)
def test_tile_and_plan_cover_the_tensor_within_the_card(c, hw, stride, batch, backward, itemsize):
    """The slices cover the channels once (the last at most partly past C),
    a block stays within the threads and the shared memory, holds a stage
    twice and, in the backward, its rows' sums; the chunks cover every
    sample group once, none empty, and make one wave of the resident
    blocks at most."""
    out_hw = tuple(-(-n // s) for n, s in zip(hw, stride))
    t = kd.tile(backward, batch, c, hw, out_hw, itemsize, stride[0])
    assert t.slice % 4 == 0 and (t.slices - 1) * t.slice < c <= t.slices * t.slice
    threads = t.slice // 4 * t.rows
    assert 1 <= threads <= kd.MAX_THREADS and 1 <= t.group <= batch
    assert 1 <= t.band <= out_hw[0] and 1 <= t.in_band <= out_hw[0]
    positions = hw[0] * hw[1] + (out_hw[0] * out_hw[1] if backward else 0)
    stage = t.group * positions * t.slice * itemsize
    assert t.smem >= kd.TERMS * t.slice * 4 + 2 * stage
    if backward:
        assert t.smem >= kd.TERMS * t.slice * 4 + t.rows * kd.TERMS * t.slice * 4
    assert t.smem <= kd.MAX_SMEM
    for resident in (1, 3, 8):
        p = kd.plan(t, batch, H100_SMS, resident)
        groups = -(-batch // t.group)
        assert (p.chunks - 1) * p.per_chunk < groups <= p.chunks * p.per_chunk
        assert p.chunks * t.slices <= max(t.slices, H100_SMS * resident)


def _items(nb, cols, band, n_rows):
    """The kernel's work items of a pass (csrc/dwconv.cu `items`,
    `item_of`): (sample, column, first row, end row)."""
    per_sample = cols * -(-n_rows // band)
    out = []
    for j in range(nb * per_sample):
        n, rem = divmod(j, per_sample)
        b, col = divmod(rem, cols)
        out.append((n, col, b * band, min(n_rows, b * band + band)))
    return out


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("batch", [1, 3, 4096])
@pytest.mark.parametrize("c,hw,stride", CARD_SHAPES)
def test_work_items_cover_each_row_of_each_column_once(c, hw, stride, batch, backward):
    """The forward's and dW's items cover each (sample, output row, output
    column) of a group once, dx's each (sample, row it walks, input
    column); at stride 2 dx's dy rows q give input rows 2q - top and
    2q - top + 1, which under TF-SAME cover each input row once."""
    out_hw = tuple(-(-n // s) for n, s in zip(hw, stride))
    t = kd.tile(backward, batch, c, hw, out_hw, 4, stride[0])
    nb = t.group
    passes = [(out_hw[1], t.band)] + ([(hw[1], t.in_band)] if backward else [])
    for cols, band in passes:
        cells = [(n, col, r) for n, col, r0, r1 in _items(nb, cols, band, out_hw[0])
                 for r in range(r0, r1)]
        assert sorted(cells) == [(n, col, r) for n in range(nb) for col in range(cols)
                                 for r in range(out_hw[0])]
    top = same_padding_2d(hw, (3, 3), stride)[2]
    if stride[0] == 2:
        rows = [ih for q in range(out_hw[0]) for ih in (2 * q - top, 2 * q - top + 1)
                if 0 <= ih < hw[0]]
        assert rows == list(range(hw[0]))
    else:
        assert out_hw[0] == hw[0]


def test_the_benchmarked_step_takes_the_measured_tiles():
    """DS-CNN L at 4096, float32 (the tiles PERF.md measured): the forward
    stages 92 channels of the 25x10 map and all 276 of the 13x5 maps, one
    thread row a column; the backward 48 channels of the 25x10 map and dy,
    each column in bands (4 output rows, 7 dy rows for dx), and 92 of the
    13x5 maps unbanded."""
    assert kd.tile(False, 4096, 276, (25, 10), (13, 5), 4, 2)[:6] == (92, 3, 1, 5, 13, 13)
    assert kd.tile(False, 4096, 276, (13, 5), (13, 5), 4, 1)[:6] == (276, 1, 1, 3, 13, 13)
    assert kd.tile(True, 4096, 276, (25, 10), (13, 5), 4, 2)[:6] == (48, 6, 1, 20, 4, 7)
    assert kd.tile(True, 4096, 276, (13, 5), (13, 5), 4, 1)[:6] == (92, 3, 1, 5, 13, 13)


def test_the_ctypes_mirror_lists_the_c_struct_in_its_order():
    src = (kd._build.CSRC_DIR / "dwconv.cu").read_text()
    body = src[src.index("struct DwArgs {"):src.index("};", src.index("struct DwArgs {"))]
    names = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            names += [n.strip() for n in re.sub(r"^(const\s+)?[\w ]+?\**\s+(?=\w+(,|$))", "",
                                                decl).split(",")]
    assert names == [f for f, _ in kd._DwArgs._fields_]


# ---------------------------------------------------------------------------
# the kernels (card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the depthwise conv kernels have no CPU mode")
    return torch.device("cuda", 0)


# The benchmarked step's two shapes at 4096 and at batches 1 and 7 (a
# partial last chunk), DS-CNN M's and S's, and two channel counts off a
# multiple of 4 (the element-wise staging and stores)
CARD_CASES = ([(4096, 276, (25, 10), (2, 2)), (4096, 276, (13, 5), (1, 1))]
              + [(b, 276, hw, s) for b in (1, 7) for hw, s in (((25, 10), (2, 2)),
                                                               ((13, 5), (1, 1)))]
              + [(64, 172, (25, 10), (2, 2)), (64, 172, (13, 5), (1, 1)),
                 (64, 64, (25, 5), (1, 1)), (5, 6, (7, 10), (2, 2)), (5, 7, (13, 5), (1, 1))])
CARD_IDS = ["b4096_276x25x10_s2", "b4096_276x13x5", "b1_276x25x10_s2", "b1_276x13x5",
            "b7_276x25x10_s2", "b7_276x13x5", "m_172x25x10_s2", "m_172x13x5", "s_64x25x5",
            "c6_7x10_s2", "c7_13x5"]
# Against the composition in float64 on the same inputs (the exact answer
# to float32's last bits). float32: y and dx are sums of 9-10 products, the
# kernel's order against the exact sum, within 1e-5 of max|y| and max|dx|;
# dW and db sum B x 65 products, in float32 within each block and float64
# over the blocks: 1e-5 of max|dW|, max|db|. bfloat16: inputs rounded to
# 8 bits on both sides, the kernel's outputs rounded once more: one
# bfloat16 step, 2^-7 of the max (dW and db: of sums over up to 266,240
# products, which the float64 reference also takes from the rounded inputs).
CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _rel(got, want) -> float:
    want = want.detach()
    return float((got.double() - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch,c,hw,stride", CARD_CASES, ids=CARD_IDS)
def test_kernels_match_the_plain_version(cuda_device, batch, c, hw, stride, dtype):
    """y, dx, dW and db of the kernels against the composition under
    autograd in float64 (CARD_TOL), channels-last as in the step; 3
    launches a forward and backward; y and dx channels-last."""
    x, w, b, dy, pads = _inputs(c, hw, stride, batch, dtype, seed=batch, device=cuda_device)
    x = x.contiguous(memory_format=torch.channels_last)
    dy = dy.contiguous(memory_format=torch.channels_last)
    before = launch_counts()
    y = kd.kernel_forward(x, w, b, stride, pads)
    dx, dw, db = kd.kernel_backward(dy, x, w, stride, pads, (True, True, True), True)
    torch.cuda.synchronize()
    assert launches_since(before) == {"dw_conv": 3}
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert dx.is_contiguous(memory_format=torch.channels_last)
    assert dw.dtype == db.dtype == y.dtype == dx.dtype == dtype
    want = _composition(*(t.double() for t in (x, w, b)), stride, pads, dy.double())
    errs = {k: _rel(g, v) for k, g, v in zip(("y", "dx", "dW", "db"), (y, dx, dw, db), want)}
    assert all(e <= CARD_TOL[dtype] for e in errs.values()), errs


@pytest.mark.cuda
def test_contiguous_input_and_partial_gradients(cuda_device):
    """A contiguous (NCHW) input is taken channels-last; with no bias and an
    input that needs no gradient only dW comes back, equal to the full call's."""
    x, w, _, dy, pads = _inputs(276, (13, 5), (1, 1), 9, device=cuda_device)
    y = kd.kernel_forward(x, w, None, (1, 1), pads)
    torch.testing.assert_close(y, F.conv2d(F.pad(x, pads), w, None, groups=276), rtol=0,
                               atol=1e-5 * float(y.abs().max()))
    dx, dw, db = kd.kernel_backward(dy, x, w, (1, 1), pads, (False, True, False), False)
    assert dx is None and db is None
    full = kd.kernel_backward(dy, x, w, (1, 1), pads, (True, True, False), False)
    assert torch.equal(dw, full[1])


@pytest.mark.cuda
def test_only_the_wanted_gradients_are_computed(cuda_device, monkeypatch):
    """Through the Function, the backward kernels are asked for the
    gradients autograd wants alone (a frozen weight gets no dW, an input
    that needs no gradient no dx); what comes back is the full call's, bit
    for bit."""
    x, w, b, dy, pads = _inputs(6, (13, 5), (1, 1), 2, device=cuda_device)
    masks, real = [], kd.kernel_backward

    def spy(dy, x, weight, stride, pads, mask, has_bias):
        masks.append(mask)
        return real(dy, x, weight, stride, pads, mask, has_bias)

    monkeypatch.setattr(kd, "kernel_backward", spy)

    def grads(want):
        ts = [t.clone().requires_grad_(r) for t, r in zip((x, w, b), want)]
        y = kd.depthwise_conv3x3(*ts, (1, 1), pads)
        assert type(y.grad_fn).__name__ == "DepthwiseConv3x3Backward"
        names = [n for n, t in zip("xwb", ts) if t.requires_grad]
        return dict(zip(names, torch.autograd.grad(y, [t for t in ts if t.requires_grad], dy)))

    full = grads((True, True, True))
    for want in ((True, False, False), (False, True, True), (False, True, False)):
        got = grads(want)
        assert masks[-1] == want and set(got) == {n for n, r in zip("xwb", want) if r}
        assert all(torch.equal(g, full[n]) for n, g in got.items())


@pytest.mark.cuda
def test_without_a_gradient_the_forward_runs_alone(cuda_device):
    """Under no_grad (serving) no Function node is made, one kernel
    launches, and y is the Function's."""
    x, w, b, _, pads = _inputs(6, (25, 10), (2, 2), 2, device=cuda_device)
    before = launch_counts()
    with torch.no_grad():
        y = kd.depthwise_conv3x3(x, w.clone().requires_grad_(True), b, (2, 2), pads)
    torch.cuda.synchronize()
    assert y.grad_fn is None and launches_since(before) == {"dw_conv": 1}
    assert torch.equal(y, kd.DepthwiseConv3x3.apply(x, w.clone().requires_grad_(True), b,
                                                    (2, 2), pads))


@pytest.mark.cuda
@pytest.mark.parametrize("c,hw,stride", [(276, (25, 10), (2, 2)), (276, (13, 5), (1, 1))])
def test_function_is_bit_reproducible_and_launches_three_kernels(cuda_device, c, hw, stride):
    """A forward and backward through Conv2d runs the Function and
    launches dw_conv 3 times; a second call gives the same y, dx, dW and db."""
    x0, _, _, dy, _ = _inputs(c, hw, stride, 512, device=cuda_device)
    m = Conv2d(c, c, (3, 3), stride, groups=c, bias=True, device=cuda_device)
    with torch.no_grad():
        m.bias.normal_()
    outs = []
    for _ in range(2):
        x = x0.clone().contiguous(memory_format=torch.channels_last).requires_grad_(True)
        m.zero_grad()
        before = launch_counts()
        y = m(x)
        assert type(y.grad_fn).__name__ == "DepthwiseConv3x3Backward"
        y.backward(dy)
        torch.cuda.synchronize()
        assert launches_since(before) == {"dw_conv": 3}
        outs.append((y, x.grad, m.weight.grad.clone(), m.bias.grad.clone()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("net_def,hw", NETS)
def test_conv2d_on_the_card_runs_each_ds_cnn_depthwise_conv_on_the_function(cuda_device,
                                                                           net_def, hw):
    """On a card each DS-CNN's depthwise conv's grad_fn is the Function's
    node; its first conv and its 1x1 convs keep autograd's convolution node."""
    model = ds_cnn.DSCNN(4, net_def, device=cuda_device).train()
    seen = _conv_nodes(model, torch.randn(2, *hw, 1, device=cuda_device))
    for name, (picked, node) in seen.items():
        assert node == ("DepthwiseConv3x3Backward" if picked else "ConvolutionBackward0"), name
    assert sum(picked for picked, _ in seen.values()) == sum(b.type == "separable"
                                                             for b in net_def)


@pytest.mark.cuda
def test_a_map_the_kernels_cannot_hold_raises_on_the_card(cuda_device):
    """A depthwise conv over maps too large for the kernels' shared memory
    raises on a card, where the kernels take every depthwise conv."""
    m = Conv2d(4, 4, (3, 3), groups=4, device=cuda_device)
    with pytest.raises(ValueError, match="does not fit the kernel's shared memory"):
        m(torch.randn(1, 4, 200, 100, device=cuda_device))


# kernels the library launches for a padded depthwise conv and not for a
# padded 1x1 conv: cuDNN's depthwise fprop, dgrad and wgrad, ATen's
# conv_depthwise2d_*; not ATen's fills, copies, elementwise and reduction
# kernels, which any step launches (whether the 1x1 conv's backward zero-fills too
# depends on the algorithm cuDNN picks under the TF32 flags of the moment)
GENERIC = re.compile(r"^(Memcpy|Memset)|at::native::\w*(elementwise|reduce)_kernel")


def _library_depthwise_kernels(dev):
    from torch.profiler import ProfilerActivity, profile

    def names(groups, kernel):
        x = torch.randn(64, 276, 13, 5, device=dev).contiguous(
            memory_format=torch.channels_last).requires_grad_(True)
        w = torch.randn(276, 276 // groups, *kernel, device=dev, requires_grad=True)
        b = torch.randn(276, device=dev, requires_grad=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # both pad, as Conv2d does
            y = F.conv2d(F.pad(x, (1, 1, 1, 1)), w, b, groups=groups)
            y.backward(torch.randn_like(y))
            torch.cuda.synchronize()
        return {e.key for e in prof.key_averages() if e.device_type.name == "CUDA"}

    return {k for k in names(276, (3, 3)) - names(1, (1, 1)) if not GENERIC.search(k)}


@pytest.mark.cuda
def test_a_dscnnl_step_launches_the_kernels_and_no_library_depthwise_kernel(cuda_device,
                                                                            tmp_path):
    """One DSCNNL training step on the card: 15 dw_conv launches (three for
    each of the five depthwise convs) and, by the profiler's kernel names,
    none of the kernels the library launches for a depthwise conv."""
    from torch.profiler import ProfilerActivity, profile

    from tcresnet_tpu_torch.config import (AudioConfig, ExperimentConfig, ModelConfig,
                                           OptimConfig, TrainConfig)
    from tcresnet_tpu_torch.data.device_data import DeviceDataset
    from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset
    from tcresnet_tpu_torch.train.trainer import Trainer

    library = _library_depthwise_kernels(cuda_device)
    assert library  # the library's depthwise kernels were seen
    cfg = ExperimentConfig(
        audio=AudioConfig(window_size_ms=40.0, window_stride_ms=20.0, num_mfccs=10),
        model=ModelConfig(name="DSCNNL", num_classes=12, weight_decay=0.0),
        optim=OptimConfig(optimizer="adam", lr_list=(5e-4,), boundaries=()),
        train=TrainConfig(batch_size=128, train_dir=str(tmp_path)))
    ds = DeviceDataset(make_synthetic_dataset(num_samples=256, num_classes=12, seed=3),
                       cuda_device)
    trainer = Trainer(cfg, ds, workdir=tmp_path)
    float(trainer.train_steps(1, start=0)["total_loss"])
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss = float(trainer.train_steps(1, start=1)["total_loss"])
        torch.cuda.synchronize()
    assert np.isfinite(loss)
    assert launches_since(before).get("dw_conv") == 15
    launched = {e.key for e in prof.key_averages() if e.device_type.name == "CUDA"}
    assert any(k.startswith(("void dw_forward", "dw_forward")) or "dw_forward_kernel" in k
               for k in launched)
    assert not launched & library, sorted(launched & library)
