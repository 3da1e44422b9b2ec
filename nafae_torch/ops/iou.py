"""Box IoU, argmax-box selection and grounding hits (docs/MATH.md
§Evaluation): the port of `nafae_tpu/ops/iou.py`."""

from __future__ import annotations

import torch


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of xyxy boxes; a [..,4], b [..,4] (broadcastable) -> [..].

    Degenerate (zero-area) boxes yield IoU 0."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0.0) * torch.clamp(
        a[..., 3] - a[..., 1], min=0.0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0.0) * torch.clamp(
        b[..., 3] - b[..., 1], min=0.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12), 0.0)


def select_boxes(best: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """best [B,K,T] region indices, boxes [B,T,R,4] -> [B,K,T,4], the box of
    each chosen region. Non-finite coordinates read as 0 first, as the
    reference's one-hot contraction does (nan_to_num); the gather is exact."""
    boxes = torch.nan_to_num(boxes, posinf=0.0, neginf=0.0)
    b, k, t = best.shape
    src = boxes[:, None].expand(b, k, t, boxes.shape[2], 4)
    idx = best[..., None, None].expand(b, k, t, 1, 4)
    return torch.gather(src, 3, idx).squeeze(3)


def grounding_hits(s: torch.Tensor, boxes: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                   iou_thresh: float = 0.5
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched correctness bits for annotated (frame, word) pairs.

    s [B,K,T,R] similarity; boxes [B,T,R,4] proposal boxes (xyxy);
    gt_boxes [B,K,T,4]; gt_mask [B,K,T] (1 = annotated). The chosen region
    is the argmax of s (first index on ties). Returns (correct [B,K,T]
    float, gt_mask)."""
    pred = select_boxes(torch.argmax(s, dim=-1), boxes)
    iou = box_iou(pred, gt_boxes)
    return (iou > iou_thresh).float() * gt_mask, gt_mask
