"""Anchor generation and box decoding (the port of
`nafae_tpu/models/detector/anchors.py`).

Faster R-CNN's parameterisation: (scale, ratio) anchors tiled over the
feature grid at the backbone stride, cell-major and anchor-minor; deltas
(dx, dy, dw, dh) in the usual normalised form, dw and dh clipped to ±4.
"""

from __future__ import annotations

import numpy as np
import torch


def generate_anchors(feat_h: int, feat_w: int, stride: int,
                     scales=(32, 64, 128, 256, 512),
                     ratios=(0.5, 1.0, 2.0)) -> np.ndarray:
    """-> [feat_h*feat_w*A, 4] xyxy anchors (numpy; static per config)."""
    base = []
    for s in scales:
        for r in ratios:
            w = s * np.sqrt(1.0 / r)
            h = s * np.sqrt(r)
            base.append([-w / 2, -h / 2, w / 2, h / 2])
    base = np.asarray(base, np.float32)                      # [A,4]
    ys = (np.arange(feat_h) + 0.5) * stride
    xs = (np.arange(feat_w) + 0.5) * stride
    cx, cy = np.meshgrid(xs, ys)                             # [H,W]
    centers = np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)
    return (centers + base[None]).reshape(-1, 4).astype(np.float32)


def decode_delta_planes(anchors: torch.Tensor, dx: torch.Tensor,
                        dy: torch.Tensor, dw: torch.Tensor, dh: torch.Tensor,
                        image_size: int
                        ) -> tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor, torch.Tensor]:
    """Per-coordinate delta planes ([B,N] each, any float dtype, upcast to
    f32 here) -> clipped coordinate planes (x1, y1, x2, y2), each [B,N]
    f32: the layout the NMS kernel takes. anchors [N,4], or [B,N,4] for
    anchors gathered per row."""
    anchors = anchors.float()
    aw = anchors[..., 2] - anchors[..., 0]                   # [N]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = anchors[..., 0] + 0.5 * aw
    acy = anchors[..., 1] + 0.5 * ah
    dx, dy = dx.float(), dy.float()
    dw = torch.clamp(dw.float(), -4.0, 4.0)
    dh = torch.clamp(dh.float(), -4.0, 4.0)
    cx = acx + dx * aw
    cy = acy + dy * ah
    w = aw * torch.exp(dw)
    h = ah * torch.exp(dh)
    hi = float(image_size)
    clip = lambda v: torch.clamp(v, 0.0, hi)                 # noqa: E731
    return (clip(cx - w / 2), clip(cy - h / 2),
            clip(cx + w / 2), clip(cy + h / 2))


def decode_boxes_planes(anchors: torch.Tensor, deltas: torch.Tensor,
                        image_size: int
                        ) -> tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor, torch.Tensor]:
    """anchors [N,4] + deltas [B,N,4] -> (x1, y1, x2, y2), each [B,N]."""
    return decode_delta_planes(anchors, deltas[..., 0], deltas[..., 1],
                               deltas[..., 2], deltas[..., 3], image_size)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 image_size: int) -> torch.Tensor:
    """Apply (dx,dy,dw,dh) deltas to anchors; clip to the image. [...,4]."""
    return torch.stack(
        decode_delta_planes(anchors, deltas[..., 0], deltas[..., 1],
                            deltas[..., 2], deltas[..., 3], image_size),
        dim=-1)
