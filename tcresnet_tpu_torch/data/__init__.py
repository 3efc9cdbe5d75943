"""Datasets of the port (counterpart of tcresnet_tpu/data).

`tcresnet_tpu/data/__init__.py` imports the JAX modules, so the port
keeps its own: the Speech Commands loader (`speech_commands`, with the
wav decoders `wav` and `native_loader`), the synthetic fixture
(`synthetic.make_synthetic_dataset`, bit-equal to the JAX one) and the
device-resident split (`device_data.DeviceDataset`).
"""

from tcresnet_tpu_torch.data.device_data import DeviceDataset
from tcresnet_tpu_torch.data.speech_commands import (
    HostDataset,
    discover_labels,
    list_files,
    load_noise_bank,
    load_speech_commands,
    oversample,
)
from tcresnet_tpu_torch.data.synthetic import make_synthetic_dataset

__all__ = ["DeviceDataset", "HostDataset", "discover_labels", "list_files", "load_noise_bank",
           "load_speech_commands", "make_synthetic_dataset", "oversample"]
