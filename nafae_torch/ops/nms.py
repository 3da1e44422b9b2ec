"""Greedy NMS as a fixed number of masked-suppression steps (the port of
`nafae_tpu/ops/nms.py`, the `detector.nms_impl=jnp` route).

At each of exactly `num_keep` steps: take the live box of highest score
(ties to the lowest index), emit it, and kill it and every live box whose
IoU with it exceeds the threshold. A row that runs out of live boxes emits
(idx 0, valid 0) for the rest of its slots. This loop is also the plain
version of the NMS kernel (`ops/kernels/nms.py`, K2), which must give the
same survivors exactly, so the IoU is written in the reference's order of
f32 operations: union = area_best + area - inter, then inter / max(union,
1e-12), and 0 where union <= 0; the threshold is compared in f32.
"""

from __future__ import annotations

import torch

NEG = -1e9


def nms_planes(x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor,
               y2: torch.Tensor, scores: torch.Tensor, num_keep: int,
               iou_thresh: float = 0.7, score_thresh: float = -float("inf")
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Coordinate planes x1/y1/x2/y2 and scores, each [B,N] f32 ->
    (keep_idx [B,num_keep] int32, keep_valid [B,num_keep] f32)."""
    b, n = scores.shape
    dev = scores.device
    areas = (torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0))
    live = scores > score_thresh
    # fills, not copies from the host, so that a CUDA graph can hold them
    thresh = torch.full((), iou_thresh, dtype=torch.float32, device=dev)
    eps = torch.full((), 1e-12, dtype=torch.float32, device=dev)
    neg = torch.full((), NEG, dtype=scores.dtype, device=dev)
    lanes = torch.arange(n, device=dev)
    rows = torch.arange(b, device=dev)
    idx_out = torch.zeros((b, num_keep), dtype=torch.int32, device=dev)
    val_out = torch.zeros((b, num_keep), dtype=torch.float32, device=dev)
    for it in range(num_keep):
        s = torch.where(live, scores, neg)
        best = torch.argmax(s, dim=1)                     # first max on ties
        valid = s[rows, best] > NEG
        bx1, by1 = x1[rows, best][:, None], y1[rows, best][:, None]
        bx2, by2 = x2[rows, best][:, None], y2[rows, best][:, None]
        iw = torch.clamp(torch.minimum(bx2, x2) - torch.maximum(bx1, x1),
                         min=0.0)
        ih = torch.clamp(torch.minimum(by2, y2) - torch.maximum(by1, y1),
                         min=0.0)
        inter = iw * ih
        union = areas[rows, best][:, None] + areas - inter
        iou = torch.where(union > 0, inter / torch.maximum(union, eps),
                          torch.zeros_like(inter))
        suppress = (iou > thresh) | (lanes[None, :] == best[:, None])
        live = live & ~suppress & valid[:, None]          # freeze when done
        idx_out[:, it] = best.to(torch.int32)
        val_out[:, it] = valid.to(torch.float32)
    return idx_out, val_out


def nms(boxes: torch.Tensor, scores: torch.Tensor, num_keep: int,
        iou_thresh: float = 0.7, score_thresh: float = -float("inf")
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """boxes [N,4] xyxy, scores [N] -> (keep_idx [num_keep] int32,
    keep_valid [num_keep] f32)."""
    idx, valid = batched_nms(boxes[None], scores[None], num_keep, iou_thresh,
                             score_thresh)
    return idx[0], valid[0]


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, num_keep: int,
                iou_thresh: float = 0.7, score_thresh: float = -float("inf")
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """boxes [B,N,4], scores [B,N] -> (keep_idx, keep_valid), each
    [B,num_keep]."""
    return nms_planes(boxes[..., 0], boxes[..., 1], boxes[..., 2],
                      boxes[..., 3], scores, num_keep, iou_thresh,
                      score_thresh)
