"""Datasets of the port (counterpart of tcresnet_tpu/data).

`tcresnet_tpu/data/__init__.py` imports the JAX modules, so the port
re-implements what it needs in numpy and torch: the host split
(`speech_commands.HostDataset`), the synthetic fixture
(`synthetic.make_synthetic_dataset`, bit-equal to the JAX one) and the
device-resident split (`device_data.DeviceDataset`).
"""
