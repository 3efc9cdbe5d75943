"""K7 dx's tensor-core design on the CPU (tcresnet_tpu_torch/csrc/tconv.cu,
`k7_dx_kernel`): its host plan `tconv._dx_plan` and the phases
`tconv.dx_phases` at every conv geometry the card runs, a replay of the
kernel's staging and fragment indexing per stride phase, and an emulation
of its 3xTF32 arithmetic in the kernel's order, held to float64 and to
the JAX Pallas kernel's dx (`jax.vjp` in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu.ops.pallas.tconv import pallas_temporal_conv as jax_tconv
from tcresnet_tpu_torch.models.layers import same_padding
from tcresnet_tpu_torch.ops.kernels import tconv
from tests.test_torch_cuda import K7_GEOMETRIES
from tests.test_torch_tconv_tc import SMEM_LIMIT, _split, _toward_zero

torch.set_num_threads(1)
# the card's gate for K7 dx (chip_smoke.py TCONV_DX_TOL, the JAX kernel test)
DX_TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("batch", [1, 8, 1536])
@pytest.mark.parametrize("k,stride,ci,co,t", K7_GEOMETRIES)
def test_dx_plan_covers_every_input_row_once_and_fits(k, stride, ci, co, t, batch):
    """At every geometry the card tests run: the phases' rows, stored at t =
    s (q0 + r) + p - lo, cover each (sample, t) exactly once, phases with
    no tap included, and the grid's blocks cover each phase's rows and
    each input channel; every slot a fragment row reads at every tap lies
    in the block's staged window (which fits the row stride), and the
    staging loop's decode of that slot (the product with ceil(2^32 / ql))
    gives back the row's sample and the dy position q0 + r - i; the block
    fits in 227 KB; the plan is a fixed function of the shapes."""
    plan = tconv._dx_plan(batch, ci, co, k, t, stride)
    assert plan == tconv._dx_plan(batch, ci, co, k, t, stride)
    to, lo, _ = same_padding(t, k, stride)
    rb = tconv._FWD_ROWS
    gx, gy, gz = plan.grid
    assert gz == stride and 1 <= plan.nt <= 9
    assert (gy - 1) * plan.nt * 8 < ci <= gy * plan.nt * 8
    phases = tconv.dx_phases(t, k, stride)
    taps_max = max(taps for _, _, taps in phases)
    assert plan.smem_bytes == 4 * (8 * plan.kslice * plan.xrow
                                   + taps_max * plan.kslice * plan.nt * 64) <= SMEM_LIMIT
    assert plan.xrow % 16 == 8 and plan.slices == -(-co // (8 * plan.kslice))

    covered = np.zeros((batch, t), np.int64)
    for p, (q0, prow, taps) in enumerate(phases):
        assert taps == len(range(p, k, stride))
        if prow == 0:
            continue
        m = np.arange(batch * prow)
        assert m.max() // rb < gx
        n, r = m // prow, m % prow
        ts = stride * (q0 + r) + p - lo
        assert ts.min() >= 0 and ts.max() < t and ((ts + lo) % stride == p).all()
        np.add.at(covered, (n, ts), 1)
        if taps == 0:  # zeros, stored by the kernel
            continue
        halo = taps - 1
        ql = prow + halo
        ql_inv = -(-(1 << 32) // ql)
        m0 = m // rb * rb
        n0 = m0 // prow
        r_first = m0 - n0 * prow
        m_last = np.minimum(m0 + rb, batch * prow) - 1
        window = m_last - m0 + 1 + (m_last // prow - n0 + 1) * halo
        assert window.max() <= plan.xrow
        for i in range(taps):
            slot = (n - n0) * ql + r - r_first + halo - i
            assert slot.min() >= 0 and (slot < window).all()
            v = slot + r_first
            nl = (v * ql_inv) >> 32
            assert (nl == v // ql).all() and (nl == n - n0).all()
            assert (q0 + (v - nl * ql) - halo == q0 + r - i).all()
    assert (covered == 1).all()


def emulate_dx(dy: torch.Tensor, w: torch.Tensor, t: int, stride: int):
    """k7_dx_kernel's arithmetic on the CPU: dy [B, Co, To], w [Co, Ci, k]
    -> [B, Ci, t]. Per phase (`tconv.dx_phases`), K steps of 8 output
    channels at one tap i, channel step outer, tap inner; per step lo*hi,
    hi*lo, hi*hi of the split operands, each 8-term sum exact and each
    tensor-core add rounded toward zero, summed from zero and added to the
    float32 sums (round to nearest). A phase with no tap is zero."""
    b, co, to = dy.shape
    _, ci, k = w.shape
    _, lo, _ = same_padding(t, k, stride)
    c8 = -(-co // 8)
    dy = torch.nn.functional.pad(dy, (0, 0, 0, 8 * c8 - co))
    w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, 8 * c8 - co))
    out = torch.zeros(b, ci, t)
    for p, (q0, prow, taps) in enumerate(tconv.dx_phases(t, k, stride)):
        acc = torch.zeros(b, prow, ci)
        for c in range(c8):
            for i in range(taps):
                q = q0 + torch.arange(prow) - i
                live = ((q >= 0) & (q < to)).float()
                a = dy[:, 8 * c:8 * c + 8, q.clamp(0, to - 1)] * live
                ahi, alo = _split(a.transpose(1, 2).contiguous())
                bhi, blo = _split(w[8 * c:8 * c + 8, :, p + stride * i].contiguous())
                part = _toward_zero(alo @ bhi)
                part = _toward_zero(part.double() + ahi @ blo)
                acc = acc + _toward_zero(part.double() + ahi @ bhi)
        out[:, :, stride * (q0 + torch.arange(prow)) + p - lo] = acc.transpose(1, 2)
    return out


def _inputs(b, k, stride, ci, co, t, seed=0):
    rng = np.random.default_rng(seed)
    to = -(-t // stride)
    dy = torch.tensor(rng.normal(size=(b, co, to)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(co, ci, k)) * 0.1, dtype=torch.float32)
    return dy, w


@pytest.mark.parametrize("k,stride,ci,co,t", [(9, 1, 48, 48, 13), (9, 1, 72, 72, 13),
                                               (9, 2, 48, 48, 25)])
def test_emulated_dx_within_the_gate_of_float64(k, stride, ci, co, t):
    """K = Co x taps = 432 and 648 at stride 1, and a stride-2 k = 9 conv:
    the kernel's order stays within the card's dx gate of the float64
    transposed conv."""
    dy, w = _inputs(6, k, stride, ci, co, t, seed=co)
    want = tconv.tconv_dx_reference(dy.double(), w.double(), t, stride)
    torch.testing.assert_close(emulate_dx(dy, w, t, stride).double(), want, **DX_TOL)


@pytest.mark.parametrize("b,k,stride,ci,co,t", [(3, 9, 1, 32, 32, 25), (3, 9, 2, 16, 24, 98),
                                                 (3, 1, 2, 24, 32, 49), (2, 4, 3, 36, 36, 50)])
def test_emulated_dx_matches_the_jax_kernel(b, k, stride, ci, co, t):
    """The JAX package's dx (`_dx_kernel`, through the custom_vjp of
    `pallas_temporal_conv` in interpret mode) at a stride-1 and a stride-2
    k = 9 conv, a 1x1 stride-2 shortcut (a phase with no tap) and an even
    k at stride 3."""
    dy, w = _inputs(b, k, stride, ci, co, t, seed=k + co)
    x = jnp.zeros((b, t, 1, ci), jnp.float32)
    kernel = jnp.asarray(w.permute(2, 1, 0)[:, None].numpy())
    _, vjp = jax.vjp(lambda v: jax_tconv(v, kernel, stride, tb=4, interpret=True), x)
    (jdx,) = vjp(jnp.asarray(dy.permute(0, 2, 1)[:, :, None].numpy()))
    want = np.asarray(jdx)[:, :, 0].transpose(0, 2, 1)
    np.testing.assert_allclose(emulate_dx(dy, w, t, stride).numpy(), want, **DX_TOL)
