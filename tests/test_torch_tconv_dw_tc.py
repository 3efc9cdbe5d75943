"""K7 dw's tensor-core design on the CPU (tcresnet_tpu_torch/csrc/tconv.cu,
`k7_dw_kernel`): its host plan `tconv._dw_plan` at the conv geometries of
K7_GEOMETRIES, a replay of the kernel's window staging and fragment indexing,
and an emulation of its 3xTF32 arithmetic in the kernel's order (k8 steps
split over two row warps, their sums, then the chunks' partials in
order), held to float64 and to the JAX Pallas kernel's dw (`jax.vjp` in
interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu.ops.pallas.tconv import pallas_temporal_conv as jax_tconv
from tcresnet_tpu_torch.models.layers import same_padding
from tcresnet_tpu_torch.ops.kernels import tconv
from tests.test_torch_tconv import DW_TOL
from tests.test_torch_tconv_tc import K7_GEOMETRIES, SMEM_LIMIT, _split, _toward_zero

torch.set_num_threads(1)
# the card's gate for K7 dw (tests/test_torch_cuda.py TCONV_DW_REL): relative to max|dw|
TCONV_DW_REL = 1e-5
WARPS = 4  # K7F_WARPS
SMS = 132  # the H100's


def _inv(d: int) -> int:
    """ceil(2^32 / d), the kernel's reciprocal for a quotient by d."""
    return -(-(1 << 32) // d)


def _windows(plan, batch: int, to: int):
    """(chunk, w0, live) of every window the kernel's blocks walk, in order."""
    for x in range(plan.grid[0]):
        r0, r1 = x * plan.chunk * to, min(batch, (x + 1) * plan.chunk) * to
        for w0 in range(r0, r1, tconv._DW_WINDOW):
            yield x, w0, min(tconv._DW_WINDOW, r1 - w0)


@pytest.mark.parametrize("batch", [1, 8, 1536])
@pytest.mark.parametrize("k,stride,ci,co,t", K7_GEOMETRIES)
def test_dw_plan_covers_every_row_and_output_once_and_fits(k, stride, ci, co, t, batch):
    """At every geometry of K7_GEOMETRIES: the chunks cover each (sample,
    position) row once; the column blocks and the store's decode of the
    warps' fragments cover each (co, ci, j) of dw once; the tile pair is one
    the kernel instantiates; the block fits in 227 KB with both window
    stages; partials stay within their share of the bytes of x and dy, and
    the grid reaches 132 blocks unless twice the chunks would break a
    chunk's row minimum or the share; the plan is a fixed function of the shapes."""
    plan = tconv._dw_plan(batch, ci, co, k, t, stride)
    assert plan == tconv._dw_plan.__wrapped__(batch, ci, co, k, t, stride)
    to, _, _ = same_padding(t, k, stride)
    gx, gy = plan.grid
    assert plan.mt == -(-co // 16) <= len(tconv._DW_MAX_NT)
    assert plan.nt <= tconv._DW_MAX_NT[plan.mt - 1]

    # rows: chunk x holds samples [x * chunk, (x + 1) * chunk)
    samples = np.zeros(batch, np.int64)
    for x in range(gx):
        samples[x * plan.chunk:min(batch, (x + 1) * plan.chunk)] += 1
    assert (samples == 1).all() and (gx - 1) * plan.chunk < batch

    # outputs: block y's fragments as the kernel's store decodes them, for
    # each of its wn column warps
    n8 = k * -(-ci // 8)
    cols = tconv._DW_WN * plan.nt  # n8 tiles a block
    written = np.zeros((co, ci, k), np.int64)
    i = np.arange(tconv._DW_WN * plan.mt * plan.nt * 128)
    w, r = i // (plan.mt * plan.nt * 128), i % (plan.mt * plan.nt * 128)
    lane, e, tile = r & 31, (r >> 5) & 3, r >> 7
    mi = tile // plan.nt
    out_co = mi * 16 + (lane >> 2) + 8 * (e >> 1)
    groups = 0
    for y in range(gy):
        u = y * cols + w * plan.nt + tile - mi * plan.nt
        c8, j = u // k, u % k
        out_ci = c8 * 8 + 2 * (lane & 3) + (e & 1)
        keep = (out_co < co) & (u < n8) & (out_ci < ci)
        np.add.at(written, (out_co[keep], out_ci[keep], j[keep]), 1)
        u_last = min(y * cols + cols, n8) - 1
        groups = max(groups, u_last // k - y * cols // k + 1)
    assert (written == 1).all() and groups == plan.groups

    phases = min(stride, k)
    assert plan.xrow % 8 == 4 and tconv._DW_DROW % 8 == 4
    assert plan.xrow >= phases * plan.slot_len and tconv._DW_DROW >= tconv._DW_WINDOW
    stage = 16 * plan.mt * tconv._DW_DROW + 8 * plan.groups * plan.xrow
    assert plan.smem_bytes == 4 * max(2 * stage, WARPS * plan.mt * plan.nt * 128) <= SMEM_LIMIT

    inputs = 4 * batch * (ci * t + co * to)
    partial = 4 * gx * co * ci * k if gx > 1 else 0
    assert partial <= tconv._DW_PARTIAL_SHARE * inputs
    if gx > 1:
        assert plan.chunk * to >= tconv._DW_MIN_ROWS
    # twice the chunks would break the row minimum or the share
    halved = plan.chunk * to < 2 * tconv._DW_MIN_ROWS
    doubled = 4 * 2 * gx * co * ci * k > tconv._DW_PARTIAL_SHARE * inputs
    assert gx * gy >= SMS or halved or doubled


@pytest.mark.parametrize("batch", [1, 8, 1536])
@pytest.mark.parametrize("k,stride,ci,co,t", K7_GEOMETRIES)
def test_dw_replay_reads_each_rows_own_taps(k, stride, ci, co, t, batch):
    """A replay of the kernel's windows: dy row v of a window decodes back
    to its own (sample, position); the x slot a fragment row reads at tap
    j (row v + halo * its sample in the window, that sample a product with
    ceil(2^32 / To), + j // stride, of phase j % stride) lies within the
    slots the window stages and its row stride, and the staging loop's
    decode of that slot is the row's sample at position o * stride + j -
    lo; column tiles read staged channel groups. At batch 1 and 8 each
    window's stage, filled from x as the staging loop fills it, holds
    x[n, ci, o * stride + j - lo] (zero outside [0, T)) at every slot a
    row reads."""
    plan = tconv._dw_plan(batch, ci, co, k, t, stride)
    to, lo, _ = same_padding(t, k, stride)
    halo = (k - 1) // stride
    ql = to + halo
    n8 = k * -(-ci // 8)
    for y in range(plan.grid[1]):
        u0 = y * tconv._DW_WN * plan.nt
        u = np.minimum(u0 + np.arange(tconv._DW_WN * plan.nt), n8 - 1)
        assert (u // k - u0 // k < plan.groups).all()
    windows = list(_windows(plan, batch, to))
    w0 = np.array([w for _, w, _ in windows])
    live = np.array([n for _, _, n in windows])
    assert (live > 0).all()
    # every row of every window
    rows = np.arange(tconv._DW_WINDOW)
    w0_, v = np.meshgrid(w0, rows, indexing="ij")
    mask = v < live[:, None]
    w0_, v = w0_[mask], v[mask]
    r = w0_ + v
    n, o = r // to, r % to
    n0, o_first = w0_ // to, w0_ % to
    nl = ((v + o_first) * _inv(to)) >> 32
    assert (nl == (v + o_first) // to).all() and (n0 + nl == n).all()
    assert (v + o_first - nl * to == o).all()
    nl_last = (live - 1 + w0 % to) // to
    slots = (live + halo * (nl_last + 1))[np.repeat(np.arange(len(windows)),
                                                    np.minimum(live, tconv._DW_WINDOW))]
    assert slots.max() <= plan.slot_len
    for j in range(k):
        slot = v + halo * nl + j // stride
        assert slot.min() >= 0 and (slot < slots).all()
        assert (j % stride) * plan.slot_len + slot.max() < plan.xrow
        p = slot + o_first
        nl_x = p // ql
        assert (n0 + nl_x == n).all()
        q = p - nl_x * ql
        assert (q * stride + j % stride - lo == o * stride + j - lo).all()
    if batch > 8:
        return
    # what the slots hold: each window's stage built from x as the kernel's
    # staging loop fills it, then read at every row, tap and channel
    x = np.random.default_rng(k + ci).normal(size=(batch, ci, t)).astype(np.float32)
    want = _im2col(torch.from_numpy(x), k, stride).numpy().reshape(batch * to, ci, k)
    for _, w0, live in windows:
        n0, o_first = w0 // to, w0 % to
        u = np.arange(plan.slot_len)
        nl, q = (u + o_first) // ql, (u + o_first) % ql
        staged = np.zeros((ci, min(stride, k), plan.slot_len), np.float32)
        for ph in range(min(stride, k)):
            tin = q * stride + ph - lo
            ok = (n0 + nl < batch) & (tin >= 0) & (tin < t)
            staged[:, ph, ok] = x[(n0 + nl)[ok], :, tin[ok]].T
        v = np.arange(live)
        slot = v + halo * ((v + o_first) // to)
        for j in range(k):
            got = staged[:, j % stride, slot + j // stride]
            np.testing.assert_array_equal(got.T, want[w0 + v, :, j])


def _im2col(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """[B * To, Ci * k]: row (n, o), column ci * k + j holds x[n, ci, o * s
    + j - lo], zero outside [0, T)."""
    xpad, to, span = tconv._padded(x, k, stride)
    cols = torch.stack([xpad[:, :, j:j + span:stride] for j in range(k)], dim=-1)
    return cols.permute(0, 2, 1, 3).reshape(x.shape[0] * to, -1)


def emulate_dw(x: torch.Tensor, dy: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """k7_dw_kernel's arithmetic on the CPU: x [B, Ci, T], dy [B, Co, To]
    -> [Co, Ci, k], in the order of `tconv._dw_plan`'s blocks. In each
    chunk, windows of 128 rows; of the 4 / wn warps that split a block's
    rows, k8 step st of a window goes to warp st % (4 / wn); per step
    lo*hi, hi*lo, hi*hi of the split operands, each 8-term sum exact and
    each tensor-core add rounded toward zero, summed from zero and added
    to the warp's float32 sums (round to nearest); rows past the chunk's
    end have zero dy. The warps' sums are added in warp order, and the
    chunks' partials in chunk order from zero."""
    b, ci, t = x.shape
    co, to = dy.shape[1], dy.shape[2]
    plan = tconv._dw_plan(b, ci, co, k, t, stride)
    xcol = _im2col(x, k, stride)
    dyr = dy.permute(0, 2, 1).reshape(b * to, co)
    total = torch.zeros(co, ci * k)
    wk = WARPS // tconv._DW_WN
    for chunk in range(plan.grid[0]):
        warps = torch.zeros(wk, co, ci * k)
        for _, w0, live in (w for w in _windows(plan, b, to) if w[0] == chunk):
            steps = -(-live // 8)
            r = w0 + torch.arange(steps * 8)
            a = torch.where((r < w0 + live)[:, None], dyr[r.clamp(max=w0 + live - 1)], 0.0)
            bx = xcol[r.clamp(max=w0 + live - 1)]
            ahi, alo = _split(a.reshape(steps, 8, co).transpose(1, 2).contiguous())
            bhi, blo = _split(bx.reshape(steps, 8, ci * k))
            part = _toward_zero(alo @ bhi)
            part = _toward_zero(part.double() + ahi @ blo)
            part = _toward_zero(part.double() + ahi @ bhi)
            for st in range(steps):
                warps[st % wk] += part[st]
        block = warps[0]
        for q in range(1, wk):
            block = block + warps[q]
        total = block if plan.grid[0] == 1 else total + block
    return total.reshape(co, ci, k)


def _inputs(b, k, stride, ci, co, t, seed=0):
    rng = np.random.default_rng(seed)
    to = -(-t // stride)
    x = torch.tensor(rng.normal(size=(b, ci, t)), dtype=torch.float32)
    dy = torch.tensor(rng.normal(size=(b, co, to)), dtype=torch.float32)
    return x, dy


@pytest.mark.parametrize("b,k,stride,ci,co,t", [(160, 9, 1, 48, 48, 13), (200, 9, 1, 72, 72, 13),
                                                 (64, 3, 1, 40, 16, 98), (40, 9, 2, 16, 24, 98),
                                                 (24, 4, 3, 36, 36, 98)])
def test_emulated_dw_within_the_gate_of_float64(b, k, stride, ci, co, t):
    """432 and 648 columns (conv 9 of TCResNet8-1.0, TCResNet14-1.5's
    widest) over 2,080 and 2,600 rows in two chunks each, 6,272 rows of
    conv 0 in 22 chunks, a stride-2 k = 9 conv in 7 and an even k at
    stride 3 in 3: the kernel's order stays within 1e-5 of max|dw| of the
    float64 dw."""
    x, dy = _inputs(b, k, stride, ci, co, t, seed=ci + co)
    plan = tconv._dw_plan(b, ci, co, k, t, stride)
    assert plan.grid[0] > 1  # the partials' sum is exercised
    want = tconv.tconv_dw_reference(x.double(), dy.double(), k, stride)
    err = (emulate_dw(x, dy, k, stride).double() - want).abs().max().item()
    assert err <= TCONV_DW_REL * want.abs().max().item()


@pytest.mark.parametrize("b,k,stride,ci,co,t", [(3, 3, 1, 40, 16, 98), (3, 9, 1, 32, 32, 25),
                                                 (3, 9, 2, 16, 24, 98), (3, 1, 2, 24, 32, 49),
                                                 (2, 4, 3, 36, 36, 50)])
def test_emulated_dw_matches_the_jax_kernel(b, k, stride, ci, co, t):
    """The JAX package's dw (`_dw_kernel`, through the custom_vjp of
    `pallas_temporal_conv` in interpret mode) at conv 0's geometry, a
    stride-1 and a stride-2 k = 9 conv, a 1x1 stride-2 shortcut and an even
    k at stride 3 (36 channels, not a multiple of 8)."""
    x, dy = _inputs(b, k, stride, ci, co, t, seed=k + ci)
    xj = jnp.asarray(x.permute(0, 2, 1)[:, :, None].numpy())
    kernel = jnp.zeros((k, 1, ci, co), jnp.float32)
    _, vjp = jax.vjp(lambda w: jax_tconv(xj, w, stride, tb=4, interpret=True), kernel)
    (jdw,) = vjp(jnp.asarray(dy.permute(0, 2, 1)[:, :, None].numpy()))
    want = np.asarray(jdw)[:, 0].transpose(2, 1, 0)
    np.testing.assert_allclose(emulate_dw(x, dy, k, stride).numpy(), want, **DW_TOL)


def test_dw_plan_raises_where_the_kernel_does_not_serve():
    """More than 80 output channels (5 m16 tiles) is no tile the kernel
    instantiates: the plan raises, and no plain version stands in."""
    with pytest.raises(ValueError, match="output channels"):
        tconv._dw_plan(8, 32, 96, 9, 25, 1)
