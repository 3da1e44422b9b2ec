"""Second-stage Faster R-CNN heads: classification and box refinement (the
port of `nafae_tpu/models/detector/heads.py`)."""

from __future__ import annotations

import torch
from torch import nn

from nafae_torch.models.detector.anchors import decode_boxes


class DetectionHead(nn.Module):
    """RoI features [N,F] -> class logits [N,C+1] and per-class deltas
    [N,C+1,4] (class 0 is the background)."""

    def __init__(self, num_classes: int, in_features: int = 2048):
        super().__init__()
        c = num_classes + 1
        self.cls = nn.Linear(in_features, c)
        self.reg = nn.Linear(in_features, c * 4)

    def forward(self, roi_feats: torch.Tensor):
        logits = self.cls(roi_feats)
        deltas = self.reg(roi_feats)
        return logits, deltas.reshape(roi_feats.shape[0], -1, 4)


def decode_detections(boxes: torch.Tensor, logits: torch.Tensor,
                      deltas: torch.Tensor, image_size: int,
                      score_thresh: float = 0.05) -> dict:
    """Per-RoI best foreground class and its refined box: boxes [...,N,4]
    proposals, logits [...,N,C+1], deltas [...,N,C+1,4] -> {boxes, scores,
    classes}; classes are 1-based, 0 where the score is below the
    threshold."""
    probs = torch.softmax(logits, dim=-1)
    fg = probs[..., 1:]
    best = torch.argmax(fg, dim=-1)                                # [...,N]
    scores = torch.gather(fg, -1, best[..., None])[..., 0]
    idx = (best + 1)[..., None, None].expand(*best.shape, 1, 4)
    d = torch.gather(deltas, -2, idx)[..., 0, :]
    refined = decode_boxes(boxes, d, image_size)
    cls = torch.where(scores >= score_thresh, best + 1,
                      torch.zeros_like(best))
    return {"boxes": refined, "scores": scores, "classes": cls}
