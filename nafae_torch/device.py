"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. Without a
CUDA device and without an explicit CPU request they raise: a serving or
measuring path never carries on quietly on the CPU.
"""

from __future__ import annotations

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
