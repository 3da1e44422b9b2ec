"""nafae_torch: the PyTorch/CUDA port of nafae_tpu for NVIDIA Hopper GPUs.

A package of its own beside `nafae_tpu` (the JAX reference, which it never
imports). Plain tensor code is PyTorch; every Pallas kernel of the JAX
package on a ported path becomes a hand-written CUDA kernel under `csrc/`,
built with nvcc at first use (`ops/kernels/_build.py`). Entry points run on
`cuda` unless the caller passes `device="cpu"` (`device.resolve_device`).
"""
