"""Hand-written CUDA kernels, each beside its plain PyTorch version.

Each module here binds its `csrc/*.cu` sources (built by `_build.py`),
checks its inputs, counts launches in a module-level dict `launches` (one
count per kernel), and sends CPU tensors to the plain version.
"""

import torch

# The C entry points' dtype argument, one table for every source: the
# operands' type (float*, __nv_bfloat16* or __half*); each source's kernels
# are templates on it, one instantiation each
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def check_tensor(name: str, x: torch.Tensor, shape: tuple, dtype, device,
                 vector: bool = False) -> None:
    """Raises unless x has this shape, dtype and device and is contiguous.
    vector: the kernel reads or writes x 16 bytes at a time, so x must be
    16-byte aligned."""
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, not {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if vector and x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
