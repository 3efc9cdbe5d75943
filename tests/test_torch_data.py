"""The port's data layer (tcresnet_tpu_torch.data) against the JAX one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcresnet_tpu.data.device_data import DeviceDataset as JaxDeviceDataset
from tcresnet_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.data.speech_commands import HostDataset
from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset

torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [
    dict(num_samples=40, num_classes=12, desired_samples=2048, seed=5),
    dict(num_samples=33, num_classes=4, desired_samples=3200, seed=9, noise_clips=2),
    dict(num_samples=20, num_classes=6, desired_samples=1000, seed=1, silence_class=None),
])
def test_synthetic_dataset_is_bit_equal_to_jax(kw):
    want, got = jax_synthetic(**kw), make_synthetic_dataset(**kw)
    for field in ("wavs", "labels", "is_silent", "noise_bank"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.label_names == want.label_names
    assert (got.num_samples, got.num_logical_samples, got.num_classes) == (
        want.num_samples, want.num_logical_samples, want.num_classes)


def test_synthetic_dataset_rejects_a_tone_silence_class():
    with pytest.raises(ValueError, match="silence_class"):
        make_synthetic_dataset(num_samples=4, silence_class=3)


@pytest.mark.parametrize("n", [2048, 2176, 2003])
def test_decode_rows_equal_jax(n):
    """Same idx -> the same f32 rows, whatever the two layouts pad to."""
    host = make_synthetic_dataset(num_samples=24, num_classes=5, desired_samples=n, seed=2)
    jds, tds = JaxDeviceDataset(jax_synthetic(num_samples=24, num_classes=5,
                                              desired_samples=n, seed=2)), DeviceDataset(host, "cpu")
    assert tds.wavs.shape[1] % 8 == 0 and tds.wavs.dtype == torch.int16
    idx = np.random.default_rng(n).integers(0, 24, 10).astype(np.int32)
    want = np.asarray(JaxDeviceDataset.decode_rows(jds.wavs, jnp.asarray(idx), n))
    got = DeviceDataset.decode_rows(tds.wavs, torch.tensor(idx), n).numpy()
    np.testing.assert_array_equal(got, want)
    jw, jl, js = JaxDeviceDataset.gather_batch(jds.arrays, jnp.asarray(idx), clip_len=n)
    tw, tl, ts = DeviceDataset.gather_batch(tds.arrays, torch.tensor(idx), clip_len=n)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert list(tds.eval_index_batches(7)) != []
    for (a, ma), (b, mb) in zip(tds.eval_index_batches(7), jds.eval_index_batches(7)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ma, mb)


def test_sample_indices_distribution():
    host = make_synthetic_dataset(num_samples=50, num_classes=4, desired_samples=256, seed=0)
    ds = DeviceDataset(host, "cpu")
    gen = torch.Generator().manual_seed(0)
    idx, labels, silent = DeviceDataset.sample_indices(ds.arrays, gen, 20000)
    assert idx.dtype == torch.int32 and idx.shape == (20000,)
    assert int(idx.min()) >= 0 and int(idx.max()) < 50
    np.testing.assert_array_equal(labels.numpy(), host.labels[idx.numpy()])
    np.testing.assert_array_equal(silent.numpy(), host.is_silent[idx.numpy()])
    counts = np.bincount(idx.numpy(), minlength=50)
    assert counts.min() > 0.6 * 400 and counts.max() < 1.4 * 400  # uniform
    # the same seed draws the same batch
    again, _, _ = DeviceDataset.sample_indices(ds.arrays, gen.manual_seed(0), 20000)
    assert torch.equal(idx, again)
    wavs, lab, sil = DeviceDataset.sample_batch(ds.arrays, gen, 6, clip_len=256)
    assert wavs.shape == (6, 256) and wavs.dtype == torch.float32


def test_sample_row_maps_the_logical_draw():
    """Oversampling: uniform over the logical axis, mapped to physical rows."""
    host = make_synthetic_dataset(num_samples=10, num_classes=3, desired_samples=128, seed=4)
    host = HostDataset(host.wavs, host.labels, host.is_silent, host.label_names,
                       host.noise_bank, sample_row=np.array([0, 0, 0, 7, 9], np.int32))
    ds = DeviceDataset(host, "cpu")
    assert ds.num_logical_samples == 5 and ds.num_samples == 10
    gen = torch.Generator().manual_seed(1)
    idx, labels, _ = DeviceDataset.sample_indices(ds.arrays, gen, 10000, ds.sample_row)
    assert set(idx.tolist()) == {0, 7, 9}
    assert abs(float((idx == 0).float().mean()) - 0.6) < 0.03
    np.testing.assert_array_equal(labels.numpy(), host.labels[idx.numpy()])
