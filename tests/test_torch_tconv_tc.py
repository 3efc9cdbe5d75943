"""K7 fwd's tensor-core design on the CPU (tcresnet_tpu_torch/csrc/tconv.cu,
`k7_fwd_kernel`): its host plan `tconv._fwd_plan` at TCResNet8-1.0's conv
geometries and three more, a replay of the kernel's staging and fragment indexing,
and an emulation of its 3xTF32 arithmetic in the kernel's order, held to
float64 and to the JAX Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu.ops.pallas.tconv import pallas_temporal_conv as jax_tconv
from tcresnet_tpu_torch.models.layers import same_padding
from tcresnet_tpu_torch.ops.kernels import tconv

torch.set_num_threads(1)
# (k, stride, Ci, Co, T) of every TCResNet8-1.0 conv, then two of TCResNet14-1.5,
# then an even tap count at stride 3 over 36 channels (not a multiple of 8)
K7_GEOMETRIES = [(3, 1, 40, 16, 98), (1, 2, 16, 24, 98), (9, 2, 16, 24, 98), (9, 1, 24, 24, 49),
                 (1, 2, 24, 32, 49), (9, 2, 24, 32, 49), (9, 1, 32, 32, 25), (1, 2, 32, 48, 25),
                 (9, 2, 32, 48, 25), (9, 1, 48, 48, 13), (9, 2, 36, 48, 25), (9, 1, 72, 72, 13),
                 (4, 3, 36, 36, 98)]
# shared memory one block may use on the H100 (227 KB)
SMEM_LIMIT = 232448
# the card's gate for K7 fwd (tests/test_torch_cuda.py TCONV_FWD_TOL, the JAX kernel test)
FWD_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("batch", [1, 8, 1536])
@pytest.mark.parametrize("k,stride,ci,co,t", K7_GEOMETRIES)
def test_fwd_plan_covers_every_output_once_and_fits(k, stride, ci, co, t, batch):
    """At every geometry of K7_GEOMETRIES (the card tests run them all): the
    grid covers each output row and channel exactly once; every slot a
    fragment row reads at every tap lies in the block's staged window, and
    the staging loop's decode of that slot (a product with ceil(2^32 / ql)
    in place of a division) gives back the row's (sample, position); the
    slice fits in 227 KB; the plan is a fixed function of the shapes."""
    plan = tconv._fwd_plan(batch, ci, co, k, t, stride)
    assert plan == tconv._fwd_plan(batch, ci, co, k, t, stride)
    to, _, _ = same_padding(t, k, stride)
    rows, rb = batch * to, tconv._FWD_ROWS
    gx, gy = plan.grid
    assert (gx - 1) * rb < rows <= gx * rb
    assert (gy - 1) * plan.nt * 8 < co <= gy * plan.nt * 8 and 1 <= plan.nt <= 9
    # the kernel's shared memory: a slice's input rows and weights
    phases = min(stride, k)
    assert plan.smem_bytes == 4 * (8 * plan.kslice * plan.xrow
                                   + k * plan.kslice * plan.nt * 64) <= SMEM_LIMIT
    assert plan.xrow >= phases * plan.slot_len and plan.xrow % 16 == 8
    assert plan.slices == -(-ci // (8 * plan.kslice))
    assert plan.ql == to + (k - 1) // stride

    # replay: the slot of (row m, tap j), and the staging loop's decode of
    # every slot of the window, exact for any block's first position
    ql_inv = -(-(1 << 32) // plan.ql)
    v = np.arange(plan.slot_len + to, dtype=np.int64)
    assert ((v * ql_inv) >> 32 == v // plan.ql).all()
    m = np.arange(rows)
    m0 = m // rb * rb
    n0 = m0 // to
    o_first = m0 - n0 * to
    nl, o = m // to - n0, m % to
    assert nl.max() < plan.nb
    for j in range(k):
        q = o + j // stride
        slot = nl * plan.ql + q - o_first
        assert slot.min() >= 0 and slot.max() < plan.slot_len
        assert ((slot + o_first) // plan.ql == nl).all() and (q < plan.ql).all()


def _tf32_rn(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value, ties away from zero (the bits
    plus half a TF32 ulp, then cleared): csrc/async_mma.cuh's split_tf32_rn."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def _split(v: torch.Tensor):
    """split_tf32_rn: (hi, lo) as float64, both TF32 values."""
    hi = _tf32_rn(v)
    return hi.double(), _tf32_rn(v - hi).double()


def _toward_zero(v: torch.Tensor) -> torch.Tensor:
    """float64 to float32, rounded toward zero: a tensor-core add."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def emulate_fwd(x: torch.Tensor, w: torch.Tensor, stride: int, chained: bool = False):
    """k7_fwd_kernel's arithmetic on the CPU: x [B, Ci, T], w [Co, Ci, k] ->
    [B, Co, To]. K steps of 8 input channels at one tap, channel step
    outer, tap inner (the order of every slice and of the slices); per step
    lo*hi, hi*lo, hi*hi of the split operands, each 8-term sum exact and
    each tensor-core add rounded toward zero, summed from zero and added to
    the float32 sums (round to nearest). `chained` instead adds every
    product onto one tensor-core accumulator across all steps."""
    b, ci, t = x.shape
    co, _, k = w.shape
    xpad, to, span = tconv._padded(x, k, stride)
    c8 = -(-ci // 8)
    xpad = torch.nn.functional.pad(xpad, (0, 0, 0, 8 * c8 - ci))
    w = torch.nn.functional.pad(w, (0, 0, 0, 8 * c8 - ci))
    acc = torch.zeros(b, to, co)
    for c in range(c8):
        for j in range(k):
            ahi, alo = _split(xpad[:, 8 * c:8 * c + 8, j:j + span:stride].transpose(1, 2))
            bhi, blo = _split(w[:, 8 * c:8 * c + 8, j].t().contiguous())
            if chained:
                for a_, b_ in ((alo, bhi), (ahi, blo), (ahi, bhi)):
                    acc = _toward_zero(acc.double() + a_ @ b_)
            else:
                p = _toward_zero(alo @ bhi)
                p = _toward_zero(p.double() + ahi @ blo)
                acc = acc + _toward_zero(p.double() + ahi @ bhi)
    return acc.transpose(1, 2)


def _inputs(b, k, ci, co, t, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(b, ci, t)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(co, ci, k)) * 0.1, dtype=torch.float32)
    return x, w


@pytest.mark.parametrize("k,stride,ci,co,t", [(9, 1, 48, 48, 13), (9, 1, 72, 72, 13),
                                               (9, 2, 48, 48, 25)])
def test_emulated_kernel_within_the_gate_of_float64(k, stride, ci, co, t):
    """K = 432 and 648: the kernel's order stays within the card's fwd gate
    of the float64 conv."""
    x, w = _inputs(6, k, ci, co, t, seed=ci)
    want = tconv.tconv_fwd_reference(x.double(), w.double(), stride)
    got = emulate_fwd(x, w, stride)
    torch.testing.assert_close(got.double(), want, **FWD_TOL)


def test_chained_accumulator_drifts_farther_from_float64():
    """Why each k8 step is summed from zero: at K = 648 one tensor-core
    accumulator chained over every step rounds toward zero at the scale of
    the whole sum, and drifts farther from float64 than the kernel's order,
    by more than its own error."""
    x, w = _inputs(6, 9, 72, 72, 13, seed=5)
    want = tconv.tconv_fwd_reference(x.double(), w.double(), 1)
    chosen = (emulate_fwd(x, w, 1).double() - want).abs()
    chained = (emulate_fwd(x, w, 1, chained=True).double() - want).abs()
    assert chained.mean() > 2 * chosen.mean()
    assert chained.max() > chosen.max()


@pytest.mark.parametrize("b,k,stride,ci,co,t", [(3, 3, 1, 40, 16, 98), (3, 9, 2, 16, 24, 98),
                                                 (5, 9, 1, 32, 32, 25), (2, 4, 3, 36, 36, 50)])
def test_emulated_kernel_matches_the_jax_kernel(b, k, stride, ci, co, t):
    x, w = _inputs(b, k, ci, co, t, seed=k + ci)
    jy = jax_tconv(jnp.asarray(x.permute(0, 2, 1)[:, :, None].numpy()),
                   jnp.asarray(w.permute(2, 1, 0)[:, None].numpy()), stride, tb=4,
                   interpret=True)
    want = np.asarray(jy)[:, :, 0].transpose(0, 2, 1)
    np.testing.assert_allclose(emulate_fwd(x, w, stride).numpy(), want, **FWD_TOL)
