"""Separable bilinear RoIAlign: the CUDA kernel `csrc/roi_align.cu` (K5),
its wrapper and its plain PyTorch version.

Replaces the TPU kernel `nafae_tpu/ops/pallas/roi_align.py::_kernel` (:43),
reached through `roi_align_pallas` (:74): the `detector.roi_impl=pallas`
route. It computes out[p,q,c] = Σ_h Σ_w wy[p,h]·wx[q,w]·feat[h,w,c] with
the reference's `_weights` (rounded to the feature's dtype in bf16 and
f16) and f32 sums, and returns f32 in every dtype.

The TPU kernel makes two dense MXU contractions over the whole map, one
box per grid step. On this card each output cell has at most 2·sr non-zero
rows and columns, so the kernel sums over that support only, and a frame's
boxes share one copy of the frame's features: a block takes one frame and
32 channels, stages the part of the map that some box touches in shared
memory once (cp.async) and computes all R boxes from it, a team of 8 lanes
for each output column (box, q), in the reference's order of sums. Maps
whose touched part does not fit are staged in bands of rows. One launch
takes the whole step, feat [F,H,W,C] with boxes [F,R,4] -> [F·R,P,P,C],
laid out so that the C5 head reads it as channels_last with no copy. It is
bound by the bytes it writes (the output) and the feature cells it reads;
the source note of `csrc/roi_align.cu` has the design, PERF.md the times.

`roi_align` sends CPU tensors to the plain version `roi_align_plain`; on
CUDA tensors it launches the kernel or raises. `launches` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nafae_torch.ops.kernels import DTYPE_CODES, _build
from nafae_torch.ops.kernels import check_tensor as _check
from nafae_torch.ops.roi_align import _by_frames, _weights

OUT_SIZE = 7          # the kernel's output grid (the detector's)
MAX_SIZE = 2048       # largest feature map side the kernel takes

launches = {"roi_align": 0}


def roi_align_plain(feat: torch.Tensor, boxes: torch.Tensor,
                    out_size: int = OUT_SIZE, spatial_scale: float = 1.0,
                    sampling_ratio: int = 2) -> torch.Tensor:
    """Plain version of the kernel, the TPU kernel's separable form: feat
    [F,H,W,C] (f32, bf16 or f16), boxes [F,R,4] -> [F·R,P,P,C] f32; weights
    rounded to feat's dtype, stage 1 over w then stage 2 over h, f32 sums,
    in the separable form's frame chunks (its [F,R,H,P,C] f32 intermediate
    about 0.7 GB at config 5)."""
    h, w, c = feat.shape[1:]

    def run(fe, bx):
        b = bx.float() * spatial_scale
        wy = _weights(b[..., 1], b[..., 3], h, out_size, sampling_ratio)
        wx = _weights(b[..., 0], b[..., 2], w, out_size, sampling_ratio)
        wy = wy.to(feat.dtype).float()
        wx = wx.to(feat.dtype).float()
        st = torch.einsum("frqw,fhwc->frhqc", wx, fe.float())
        return torch.einsum("frph,frhqc->frpqc", wy, st)
    return _by_frames(run, feat, boxes).reshape(-1, out_size, out_size, c)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("roi_align")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.nafae_roi_align.argtypes = [vp, i, vp, vp, i, i, i, i, i,
                                    ctypes.c_float, i, vp]
    lib.nafae_roi_align.restype = i
    return lib


def launch(feat: torch.Tensor, boxes: torch.Tensor,
           spatial_scale: float = 1.0, sampling_ratio: int = 2
           ) -> torch.Tensor:
    """The kernel alone on CUDA tensors: checks what it takes, allocates the
    [F·R,7,7,C] f32 output and launches on the current stream."""
    if feat.dim() != 4 or boxes.dim() != 3:
        raise ValueError(f"need feat [F,H,W,C] and boxes [F,R,4], got "
                         f"{tuple(feat.shape)} and {tuple(boxes.shape)}")
    f, h, w, c = feat.shape
    r = boxes.shape[1]
    if feat.dtype not in DTYPE_CODES:
        raise TypeError(f"feat must be float32, bfloat16 or float16, got "
                        f"{feat.dtype}")
    if not (1 <= h <= MAX_SIZE and 1 <= w <= MAX_SIZE):
        raise ValueError(f"roi_align kernel takes 1 <= H, W <= {MAX_SIZE}, "
                         f"got H={h}, W={w}")
    if not 1 <= sampling_ratio <= 64:
        raise ValueError(f"roi_align kernel takes 1 <= sampling_ratio <= 64, "
                         f"got {sampling_ratio}")
    if f * r >= 2 ** 31 or c < 1:
        raise ValueError(f"roi_align kernel takes F·R < 2^31 boxes and C >= 1,"
                         f" got F·R={f * r}, C={c}")
    dev = feat.device
    _check("feat", feat, (f, h, w, c), feat.dtype, dev)
    _check("boxes", boxes, (f, r, 4), torch.float32, dev)
    lib = _lib()
    out = torch.empty((f * r, OUT_SIZE, OUT_SIZE, c), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        err = lib.nafae_roi_align(
            feat.data_ptr(), DTYPE_CODES[feat.dtype],
            boxes.data_ptr(), out.data_ptr(), f, r, h, w, c,
            float(spatial_scale), sampling_ratio,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"roi_align kernel launch failed: cudaError_t {err}")
    if f * r > 0:
        launches["roi_align"] += 1
    return out


def roi_align(feat: torch.Tensor, boxes: torch.Tensor,
              out_size: int = OUT_SIZE, spatial_scale: float = 1.0,
              sampling_ratio: int = 2) -> torch.Tensor:
    """The reference's `roi_align_pallas` over a whole step: feat [F,H,W,C],
    boxes [F,R,4] xyxy (image coords) -> [F·R,P,P,C] f32."""
    if feat.device.type == "cpu":
        return roi_align_plain(feat, boxes, out_size, spatial_scale,
                               sampling_ratio)
    if feat.device.type != "cuda":
        raise ValueError(f"roi_align runs on cuda or cpu, not {feat.device}")
    if out_size != OUT_SIZE:
        raise ValueError(f"roi_align kernel takes out_size {OUT_SIZE}, got "
                         f"{out_size}")
    return launch(feat.contiguous(), boxes.float().contiguous(),
                  spatial_scale, sampling_ratio)
