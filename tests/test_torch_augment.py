"""Augmentation (tcresnet_tpu_torch.ops.augment and the plain version of
kernels K1 / K6) against the JAX kernels in interpret mode, given the
per-row scalars JAX's own draw produced."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu_torch.config import AugmentConfig
from tcresnet_tpu.ops.pallas.augment import (
    _draw_scalars,
    _fused_augment_impl,
    _fused_gather_augment_impl,
)
from tcresnet_tpu_torch.ops import augment as aug
from tcresnet_tpu_torch.ops.kernels import augment as kernels
from tcresnet_tpu_torch.ops.kernels.augment import AugmentScalars
from tests.test_torch_config import to_jax_config

torch.set_num_threads(1)

N, P, ROWS, BATCH = 2048, 2048, 24, 16  # a_rows = 16: the JAX gather kernel's tiling


def _case(seed, naive=True, shift=True):
    rng = np.random.default_rng(seed)
    data = rng.integers(-32768, 32768, (ROWS, P)).astype(np.int16)
    idx = rng.integers(0, ROWS, BATCH).astype(np.int32)
    silent = rng.integers(0, 4, BATCH) == 0
    noise = (rng.normal(size=(3, 3 * N)) * 0.4).astype(np.float32)
    cfg = AugmentConfig(
        method="anchored_slice_or_pad_with_shift" if shift else "anchored_slice_or_pad",
        background_frequency=0.8, background_max_volume=0.5, naive_background_mix=naive)
    scalars = tuple(np.asarray(a) for a in _draw_scalars(
        jax.random.key(seed), jnp.asarray(silent), to_jax_config(cfg), jnp.asarray(noise), N, True))
    return data, idx, silent, noise, cfg, scalars


def _torch_scalars(scalars):
    shifts, clips, offs, vols, keeps = scalars
    return AugmentScalars(torch.tensor(shifts, dtype=torch.int32),
                          torch.tensor(clips, dtype=torch.int32),
                          torch.tensor(offs, dtype=torch.int32),
                          torch.tensor(vols, dtype=torch.float32),
                          torch.tensor(keeps, dtype=torch.float32))


def _jax_gather(data, idx, scalars, noise, quantize):
    wavs3d = jnp.asarray(data.reshape(ROWS, P // 128, 128))
    return np.asarray(_fused_gather_augment_impl(
        wavs3d, jnp.asarray(idx), tuple(jnp.asarray(a) for a in scalars),
        jnp.asarray(noise), N, True, quantize))


@pytest.mark.parametrize("naive,shift", [(True, True), (False, True), (True, False)])
def test_plain_k1_k6_bit_exact_vs_jax_kernels(naive, shift):
    """Exact crop offsets: the plain apply equals the JAX gather kernel
    (K1) and augment kernel (K6) bit for bit, silence rows and both
    background-mix versions included."""
    data, idx, silent, noise, cfg, scalars = _case(7, naive, shift)
    assert silent.any() and (scalars[3] > 0).any()
    want = _jax_gather(data, idx, scalars, noise, False)
    got = kernels.fused_gather_augment(torch.tensor(data), torch.tensor(idx),
                                       _torch_scalars(scalars), torch.tensor(noise), N)
    np.testing.assert_array_equal(got.numpy(), want)
    decoded = data[idx, :N].astype(np.float32) / 32768.0
    want6 = np.asarray(_fused_augment_impl(
        jnp.asarray(decoded), tuple(jnp.asarray(a) for a in scalars), jnp.asarray(noise),
        N, True))
    got6 = kernels.fused_augment(torch.tensor(decoded), _torch_scalars(scalars),
                                 torch.tensor(noise))
    np.testing.assert_array_equal(got6.numpy(), want6)
    shifts, clips, offs, vols, keeps = scalars
    for b in np.flatnonzero(silent):  # silence rows: the noise crop alone
        crop = noise[clips[b], offs[b]:offs[b] + N]
        np.testing.assert_array_equal(got[b].numpy(), np.clip(vols[b] * crop, -1, 1))


def test_plain_quantized_crops_vs_jax():
    """noise_crop_quantize: the crop starts at the offset rounded down to
    1024. Bit-exact with the JAX kernel's exact path at those offsets.
    The JAX quantized path run in interpret mode contracts vol * crop +
    shifted into one FMA (XLA:CPU), so it differs from both by the one
    rounding of the product, at most 2^-24 for |vol * crop| < 1
    (ROADMAP.md Queue 3)."""
    data, idx, silent, noise, cfg, scalars = _case(11)
    shifts, clips, offs, vols, keeps = scalars
    aligned = (shifts, clips, (offs // 1024) * 1024, vols, keeps)
    got = kernels.fused_gather_augment(torch.tensor(data), torch.tensor(idx),
                                       _torch_scalars(scalars), torch.tensor(noise), N,
                                       quantize=True).numpy()
    np.testing.assert_array_equal(got, _jax_gather(data, idx, aligned, noise, False))
    np.testing.assert_allclose(got, _jax_gather(data, idx, scalars, noise, True),
                               rtol=0, atol=2.0 ** -24)
    # the plain version's own quantization of the offsets
    np.testing.assert_array_equal(
        kernels.crop_offsets(torch.tensor([0, 1023, 1024, 5000]), True).numpy(),
        [0, 0, 1024, 4096])


def test_torch_draw_distribution():
    cfg = AugmentConfig(background_frequency=0.7, background_max_volume=0.2, shift_ratio=0.1)
    batch, n, clip_len = 20000, 1000, 3000
    silent = torch.zeros(batch, dtype=torch.bool)
    silent[:5000] = True
    noise = torch.zeros(3, clip_len)
    gen = torch.Generator().manual_seed(0)
    s = aug.draw_scalars(gen, silent, cfg, noise, n, is_training=True)
    assert [t.dtype for t in s] == [torch.int32] * 3 + [torch.float32] * 2
    assert int(s.shifts.min()) == -100 and int(s.shifts.max()) == 99  # [-T, T)
    assert int(s.offs.min()) >= 0 and int(s.offs.max()) <= clip_len - n
    assert set(s.clips.tolist()) == {0, 1, 2}
    assert abs(float((s.vols > 0).float().mean()) - 0.7) < 0.02
    assert float(s.vols.max()) < 0.2
    np.testing.assert_array_equal(s.keeps.numpy(), np.where(silent.numpy(), 0.0, 1.0))
    # eval: no noise; v2: silence rows get U[0, 1) volumes, training and eval
    assert float(aug.draw_scalars(gen, silent, cfg, noise, n, False).vols.abs().max()) == 0
    v2 = dataclasses.replace(cfg, naive_background_mix=False)
    for training in (True, False):
        vols = aug.draw_scalars(gen, silent, v2, noise, n, training).vols
        assert 0.45 < float(vols[:5000].mean()) < 0.55 and float(vols[:5000].max()) < 1.0
    # no shift for the anchored-only method
    plain = dataclasses.replace(cfg, method="anchored_slice_or_pad")
    assert int(aug.draw_scalars(gen, silent, plain, noise, n, True).shifts.abs().max()) == 0
    with pytest.raises(ValueError, match="shorter"):
        aug.draw_scalars(gen, silent, cfg, torch.zeros(3, n - 1), n, True)


def test_dispatch_semantics():
    """Unknown methods raise everywhere; no_augmentation_audio only zeroes
    silence; without a noise bank only the shift and the zeroing remain."""
    rng = np.random.default_rng(3)
    wavs = torch.tensor(rng.uniform(-0.5, 0.5, (4, 256)).astype(np.float32))
    silent = torch.tensor([True, False, False, False])
    noise = torch.ones(2, 600)
    gen = torch.Generator().manual_seed(0)
    bad = AugmentConfig(method="anchored_slice_or_pad_shift")  # a typo
    for backend in ("xla", "pallas"):
        with pytest.raises(ValueError, match="Unknown augmentation method"):
            aug.augment(wavs, silent, gen, dataclasses.replace(bad, backend=backend),
                        noise, True)
    dataset = torch.zeros(4, 256, dtype=torch.int16)
    assert not aug.gather_fusable(dataset, bad, noise, 256)
    with pytest.raises(ValueError, match="Unknown augmentation method"):
        aug.augment_gathered(dataset, torch.arange(4, dtype=torch.int32), silent, gen, bad,
                             noise, True, 256)
    with pytest.raises(ValueError, match="backend"):
        aug.augment(wavs, silent, gen, AugmentConfig(backend="tpu"), noise, True)

    out = aug.augment(wavs, silent, gen, AugmentConfig(method="no_augmentation_audio"),
                      noise, True)
    assert (out[0] == 0).all() and torch.equal(out[1:], wavs[1:])
    cfg = AugmentConfig(shift_ratio=0.1)
    out = aug.augment(wavs, silent, gen.manual_seed(5), cfg, None, True)
    shifts = aug.draw_shifts(gen.manual_seed(5), 4, 256, cfg, "cpu")
    assert torch.equal(out, aug.zero_silence(aug.time_shift(wavs, shifts), silent))


def test_backends_give_the_same_batch():
    """One draw feeds the kernels' path and the plain path: with the same
    generator state, augment_gathered (K1), augment (K6) and the plain
    augment_batch agree exactly."""
    data, idx, silent, noise, cfg, _ = _case(13)
    dataset, tidx = torch.tensor(data), torch.tensor(idx)
    tsilent, tnoise = torch.tensor(silent), torch.tensor(noise)
    gen = torch.Generator()
    outs = []
    for backend in ("pallas", "xla"):
        c = dataclasses.replace(cfg, backend=backend)
        assert aug.gather_fusable(dataset, c, tnoise, N)
        outs.append(aug.augment_gathered(dataset, tidx, tsilent, gen.manual_seed(9), c,
                                         tnoise, True, N))
    decoded = dataset[tidx.long(), :N].float() / 32768.0
    outs.append(aug.augment_batch(decoded, tsilent, gen.manual_seed(9), cfg, tnoise, True))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    assert not torch.equal(outs[0], decoded)


def test_kernel_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="no K1 kernel"):
        kernels.fused_gather_augment(torch.zeros(2, 8, dtype=torch.int16, device="meta"),
                                     torch.zeros(2, dtype=torch.int32), None, None, 8)
    with pytest.raises(ValueError, match="no K6 kernel"):
        kernels.fused_augment(torch.zeros(2, 8, device="meta"), None, None)
