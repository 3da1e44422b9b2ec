"""Models of the port (counterparts of `nafae_tpu/models`)."""
