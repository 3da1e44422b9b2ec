"""Batched greedy NMS: the CUDA kernel `csrc/nms.cu` (K2), its wrapper and
its plain PyTorch version.

Replaces the TPU kernel `nafae_tpu/ops/pallas/nms.py::_kernel` (:36),
reached through `nms_pallas_planes` (:98) and `nms_pallas` (:149): the
`detector.nms_impl=pallas` route, and `auto` on CUDA tensors. Same survivors
as `ops/nms.py` exactly: first-index ties, (idx, valid = max > -1e9), the
winner and every box with IoU > thresh killed, an exhausted row emitting
(idx 0, valid 0).

On this card the TPU's row-parallel VPU loop becomes one block per row: the
row's masked scores sit in shared memory, each of the num_keep steps is a
block-wide (max, first index) reduction and a pass over the live boxes'
coordinates, re-read from device memory (a row of 24,000 boxes is 480 KB in
five planes, more than one SM's shared memory). There is no VMEM budget:
the TPU's ValueError above N ~ 100k becomes the kernel's own limit,
N < 2^31; a row longer than `nafae_nms_smem_boxes()` keeps its masked
scores in a scratch row in device memory.

`nms_planes` sends CPU tensors to the plain version (`ops/nms.nms_planes`);
on CUDA tensors it launches the kernel or raises. `launches` counts
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nafae_torch.ops import nms as plain
from nafae_torch.ops.kernels import _build
from nafae_torch.ops.kernels import check_tensor as _check

launches = {"nms": 0}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("nms")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.nafae_nms.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i, i, i,
                              ctypes.c_float, vp]
    lib.nafae_nms.restype = i
    lib.nafae_nms_smem_boxes.argtypes = []
    lib.nafae_nms_smem_boxes.restype = i
    return lib


def launch(x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor,
           y2: torch.Tensor, scores: torch.Tensor, num_keep: int,
           iou_thresh: float = 0.7) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel alone on CUDA tensors: checks what it takes, allocates
    idx [B,num_keep] int32 and valid [B,num_keep] f32 (and a [B,N] scratch
    for rows too long for shared memory), launches on the current stream."""
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
    lib = _lib()
    idx = torch.empty((b, num_keep), dtype=torch.int32, device=dev)
    valid = torch.empty((b, num_keep), dtype=torch.float32, device=dev)
    scratch = (torch.empty((b, n), dtype=torch.float32, device=dev)
               if n > lib.nafae_nms_smem_boxes() else None)
    with torch.cuda.device(dev):
        err = lib.nafae_nms(
            x1.data_ptr(), y1.data_ptr(), x2.data_ptr(), y2.data_ptr(),
            scores.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            idx.data_ptr(), valid.data_ptr(), b, n, num_keep,
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
