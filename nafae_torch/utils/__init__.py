"""Utilities of the port (counterparts of `nafae_tpu/utils`)."""
