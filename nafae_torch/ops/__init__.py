"""Tensor ops of the port (counterparts of `nafae_tpu/ops`)."""
