"""Training of the port (counterpart of tcresnet_tpu/train)."""
