"""Region proposal network: objectness and deltas -> proposals (the port of
`nafae_tpu/models/detector/rpn.py`).

Proposal selection has the reference's two routes:
- top-k by objectness (`topk_impl` exact, approx or window), decode, then
  NMS down to num_proposals;
- the full pool (`topk_impl="none"`): decode every anchor as coordinate
  planes and greedy-NMS the whole pool, no sort (config 5's preset).

NMS runs as `ops/nms` (`nms_impl="jnp"`) or through the NMS kernel
(`nms_impl="pallas"`: `ops/kernels/nms.py`, which takes its plain version
on CPU tensors).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from nafae_torch.models.detector.anchors import (decode_boxes,
                                                 decode_boxes_planes,
                                                 decode_delta_planes)
from nafae_torch.models.detector.resnet import Conv
from nafae_torch.ops import nms as plain_nms
from nafae_torch.ops.kernels import nms as kernel_nms


class RPNHead(nn.Module):
    """3x3 conv + relu, then 1x1 objectness [B,N] (f32) and 1x1 deltas in
    the compute dtype; N = H·W·A in the reference's cell-major, anchor-minor
    order. raw=True returns the deltas in grid layout [B,H,W,A·4], whose
    channel a·4+c is coordinate c of anchor a. in_channels: the backbone's
    (1024 for ResNet C4, 512 for VGG16)."""

    def __init__(self, num_anchors: int, channels: int, in_channels: int):
        super().__init__()
        self.num_anchors = num_anchors
        self.Conv_0 = Conv(in_channels, channels, 3, padding=1, bias=True)
        self.Conv_1 = Conv(channels, num_anchors, 1, bias=True)
        self.Conv_2 = Conv(channels, num_anchors * 4, 1, bias=True)

    def forward(self, feat: torch.Tensor, raw: bool = False):
        """feat [B,H,W,C] -> (obj [B,N] f32, deltas)."""
        y = F.relu(self.Conv_0(feat.permute(0, 3, 1, 2)))
        obj = self.Conv_1(y).permute(0, 2, 3, 1)             # [B,H,W,A]
        deltas = self.Conv_2(y).permute(0, 2, 3, 1)          # [B,H,W,A*4]
        b = feat.shape[0]
        obj = obj.reshape(b, -1).float()
        if raw:
            return obj, deltas
        return obj, deltas.reshape(b, -1, 4)


def stable_topk(scores: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """lax.top_k over the last axis: the k largest, descending, equal values
    in index order (torch.topk leaves that order open)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def windowed_topk(scores: torch.Tensor, k: int, window: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Partial top-k via per-window pre-reduction: [B,N] -> ([B,k], [B,k]).
    max + first argmax over contiguous windows of `window` entries, then an
    exact top-k over the window maxima; window=1 is exact top-k. At most
    one candidate survives per window."""
    if window <= 1:
        return stable_topk(scores, k)
    b, n = scores.shape
    pad = (-n) % window
    if pad:
        scores = F.pad(scores, (0, pad), value=-float("inf"))
    nw = scores.shape[1] // window
    s = scores.reshape(b, nw, window)
    vals, widx = stable_topk(s.amax(-1), min(k, nw))
    warg = torch.argmax(s, dim=-1)                          # [B,nw]
    idx = widx * window + torch.gather(warg, 1, widx)
    if k > nw:       # keep the contract shape; extra slots repeat the last
        vals = torch.cat([vals, vals[:, -1:].expand(b, k - nw)], dim=1)
        idx = torch.cat([idx, idx[:, -1:].expand(b, k - nw)], dim=1)
    return vals, idx


def _nms(nms_impl: str, planes, scores, num_keep, iou):
    mod = kernel_nms if nms_impl == "pallas" else plain_nms
    return mod.nms_planes(*planes, scores, num_keep, iou)


def select_proposals_batched(obj_logits: torch.Tensor,
                             deltas: torch.Tensor | None,
                             anchors: torch.Tensor, image_size: int,
                             pre_nms_topk: int, num_proposals: int,
                             nms_iou: float = 0.7, nms_impl: str = "jnp",
                             topk_impl: str = "exact", topk_window: int = 1,
                             deltas_raw: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """obj [B,N], deltas [B,N,4] (or grid-layout deltas_raw [B,H,W,A·4] on
    the full-pool route) -> (boxes [B,R,4], scores [B,R], keep_valid [B,R]);
    dead slots carry zero boxes and scores. topk_impl: "exact", "approx"
    (lax.approx_max_k; the port takes the exact top-k, a result of recall
    1), "window" (windowed_topk) or "none" (the full pool)."""
    if topk_impl not in ("exact", "approx", "window", "none"):
        raise ValueError(f"unknown topk_impl {topk_impl!r}; exact | approx "
                         "| window | none")
    if nms_impl not in ("jnp", "pallas"):
        raise ValueError(f"unknown nms_impl {nms_impl!r}; jnp | pallas")
    k = min(pre_nms_topk, obj_logits.shape[-1])
    if topk_impl == "none":
        scores = obj_logits                                    # [B,N]
        if deltas_raw is not None:
            b = deltas_raw.shape[0]
            d = [deltas_raw[..., c::4].reshape(b, -1) for c in range(4)]
            planes = decode_delta_planes(anchors, *d, image_size)
        else:
            planes = decode_boxes_planes(anchors, deltas, image_size)
        keep_idx, keep_valid = _nms(nms_impl, planes, scores, num_proposals,
                                    nms_iou)
        ki = keep_idx.long()
        out_boxes = torch.stack([torch.gather(p, 1, ki) for p in planes],
                                dim=-1)                        # [B,R,4]
        out_scores = torch.gather(scores, 1, ki) * keep_valid
        return out_boxes * keep_valid[..., None], out_scores, keep_valid
    if topk_impl == "window":
        scores, idx = windowed_topk(obj_logits, k, topk_window)
    else:
        scores, idx = stable_topk(obj_logits, k)               # [B,k]
    sel_anchors = anchors[idx]                                 # [B,k,4]
    sel_deltas = torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4))
    boxes = decode_boxes(sel_anchors, sel_deltas, image_size)  # [B,k,4]
    planes = [boxes[..., c].contiguous() for c in range(4)]
    keep_idx, keep_valid = _nms(nms_impl, planes, scores.contiguous(),
                                num_proposals, nms_iou)
    ki = keep_idx.long()
    out_boxes = torch.gather(boxes, 1, ki[..., None].expand(-1, -1, 4))
    out_scores = torch.gather(scores, 1, ki) * keep_valid
    return out_boxes * keep_valid[..., None], out_scores, keep_valid


def select_proposals(obj_logits: torch.Tensor, deltas: torch.Tensor,
                     anchors: torch.Tensor, image_size: int,
                     pre_nms_topk: int, num_proposals: int,
                     nms_iou: float = 0.7, nms_impl: str = "jnp",
                     topk_impl: str = "exact", topk_window: int = 1
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-image form of select_proposals_batched (no batch axis)."""
    boxes, scores, keep_valid = select_proposals_batched(
        obj_logits[None], deltas[None], anchors, image_size, pre_nms_topk,
        num_proposals, nms_iou, nms_impl=nms_impl, topk_impl=topk_impl,
        topk_window=topk_window)
    return boxes[0], scores[0], keep_valid[0]
