"""Device selection for the port's entry points, and the training step's
matmul precision.

Entry points run on the GPU unless the caller asks for the CPU. Without a
CUDA device and without an explicit CPU request they raise: a serving or
measuring path never carries on quietly on the CPU.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None or "cuda" -> the current CUDA device (raises without one);
    "cpu" -> the CPU. Also turns TF32 off for f32 products and
    convolutions: the JAX reference runs f32 at Precision.HIGHEST, and
    TF32 keeps about three decimal digits."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


@contextlib.contextmanager
def matmul_precision(precision: str):
    """The reference's `ops.grounding.matmul_precision` on the card, for
    the block it wraps (the training step's losses and their gradient):
    "default" lets cuBLAS run f32 products in TF32 (one reduced-precision
    tensor-core pass with f32 sums, the counterpart of the reference's
    bf16 MXU passes), "highest" keeps them exact. Only
    `torch.backends.cuda.matmul.allow_tf32` changes: cuDNN convolutions
    stay exact under both, as the reference's knob does not reach its
    convolutions. The flag is process-wide, as the reference's PRECISION
    is module-wide; its previous value comes back on exit. A CUDA graph
    captured inside the block keeps the cuBLAS kernels picked there."""
    if precision not in ("highest", "default"):
        raise ValueError(f"unknown matmul precision {precision!r}; "
                         "choose highest | default")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "default"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
