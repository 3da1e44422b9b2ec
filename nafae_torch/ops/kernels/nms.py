"""Batched greedy NMS: the CUDA kernel `csrc/nms.cu` (K2), its wrapper and
its plain PyTorch version.

Replaces the TPU kernel `nafae_tpu/ops/pallas/nms.py::_kernel` (:36),
reached through `nms_pallas_planes` (:98) and `nms_pallas` (:149): the
`detector.nms_impl=pallas` route, and `auto` on CUDA tensors. Same survivors
as `ops/nms.py` exactly: first-index ties, (idx, valid = max > -1e9), the
winner and every box with IoU > thresh killed, an exhausted row emitting
(idx 0, valid 0).

On this card the TPU's row-parallel VPU loop becomes one block per row
that walks the boxes in (score descending, index ascending) order in tiers
of at most `TIER_BOXES`: it selects a tier from the scores' order-preserving
keys (kept in registers) with a few block-wide counts, gathers only the
tier's coordinates, and runs the rounds on them; a tier whose candidates
all die early continues the walk in the next one, exactly. The source says
why this gives the reference's survivors and what bounds it. There is no
VMEM budget: the TPU's ValueError above N ~ 100k becomes the kernel's own
limit, N < 2^31.

`nms_planes` sends CPU tensors to the plain version (`ops/nms.nms_planes`);
on CUDA tensors it launches the kernel or raises. `launches` counts
launches; `launch(..., tiers=t)` also reports how many tiers each row took
(rows past the first are the walk's continuation).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nafae_torch.ops import nms as plain
from nafae_torch.ops.kernels import _build
from nafae_torch.ops.kernels import check_tensor as _check

launches = {"nms": 0}
TIER_BOXES = 1024     # the kernel's largest tier (nafae_nms_tier_boxes)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("nms")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.nafae_nms.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i, i, i,
                              ctypes.c_float, vp]
    lib.nafae_nms.restype = i
    lib.nafae_nms_tier_boxes.argtypes = []
    lib.nafae_nms_tier_boxes.restype = i
    if lib.nafae_nms_tier_boxes() != TIER_BOXES:
        raise RuntimeError("csrc/nms.cu's tier differs from TIER_BOXES")
    return lib


def launch(x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor,
           y2: torch.Tensor, scores: torch.Tensor, num_keep: int,
           iou_thresh: float = 0.7, tiers: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel alone on CUDA tensors: checks what it takes, allocates
    idx [B,num_keep] int32 and valid [B,num_keep] f32, launches on the
    current stream. tiers: an int32 [B] tensor on the same device that
    receives the number of tiers each row took, or None."""
    if scores.dim() != 2:
        raise ValueError(f"scores must be [B,N], got {tuple(scores.shape)}")
    b, n = scores.shape
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"nms kernel takes 1 <= N < 2^31 boxes a row, got "
                         f"N={n}")
    if num_keep < 0:
        raise ValueError(f"num_keep must be >= 0, got {num_keep}")
    dev = scores.device
    for name, x in (("x1", x1), ("y1", y1), ("x2", x2), ("y2", y2),
                    ("scores", scores)):
        _check(name, x, (b, n), torch.float32, dev)
    if tiers is not None:
        _check("tiers", tiers, (b,), torch.int32, dev)
    lib = _lib()
    idx = torch.empty((b, num_keep), dtype=torch.int32, device=dev)
    valid = torch.empty((b, num_keep), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.nafae_nms(
            x1.data_ptr(), y1.data_ptr(), x2.data_ptr(), y2.data_ptr(),
            scores.data_ptr(), idx.data_ptr(), valid.data_ptr(),
            tiers.data_ptr() if tiers is not None else None, b, n, num_keep,
            float(iou_thresh), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: cudaError_t {err}")
    if b * num_keep > 0:
        launches["nms"] += 1
    return idx, valid


def nms_planes(x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor,
               y2: torch.Tensor, scores: torch.Tensor, num_keep: int,
               iou_thresh: float = 0.7) -> tuple[torch.Tensor, torch.Tensor]:
    """Coordinate-plane form (the kernel's layout): x1/y1/x2/y2/scores each
    [B,N] -> (keep_idx [B,num_keep] int32, keep_valid [B,num_keep] f32)."""
    if scores.device.type == "cpu":
        return plain.nms_planes(x1, y1, x2, y2, scores, num_keep, iou_thresh)
    if scores.device.type != "cuda":
        raise ValueError(f"nms runs on cuda or cpu, not {scores.device}")
    planes = [p.float().contiguous() for p in (x1, y1, x2, y2, scores)]
    return launch(*planes, num_keep, iou_thresh)


def nms_boxes(boxes: torch.Tensor, scores: torch.Tensor, num_keep: int,
              iou_thresh: float = 0.7) -> tuple[torch.Tensor, torch.Tensor]:
    """boxes [B,N,4], scores [B,N] -> (keep_idx, keep_valid), each
    [B,num_keep] (the reference's `nms_pallas`)."""
    return nms_planes(boxes[..., 0], boxes[..., 1], boxes[..., 2],
                      boxes[..., 3], scores, num_keep, iou_thresh)
