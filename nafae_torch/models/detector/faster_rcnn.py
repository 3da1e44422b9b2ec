"""Faster R-CNN RoI feature extractor of config 5 (the port of
`nafae_tpu/models/detector/faster_rcnn.py`).

Frames [B,S,S,3] -> backbone features -> RPN proposals (full-pool or
top-k, then greedy NMS) -> RoIAlign -> RoI head -> R pooled features and
boxes per frame. `detector.backbone` picks ResNet-50/101 (C4 features with
1024 channels, the C5 head, 2048-d features) or VGG16 (conv5_3 with 512
channels, fc6/fc7, 4096-d features; `models/detector/vgg.py`). The
detector is frozen: it runs under no_grad.

Routing follows the reference:
- NMS through the kernel (`ops/kernels/nms.py`, K2) when use_pallas_nms,
  `detector.nms_impl=pallas`, or `auto` with the frames on CUDA; else
  `ops/nms`.
- RoIAlign through the kernel (`ops/kernels/roi_align.py`, K5) when
  use_pallas_roi_align or `detector.roi_impl=pallas`; else the separable
  (default) or combined products of `ops/roi_align`.

Weights are random from a seeded torch.Generator (`init_detector`), then
read from a torch checkpoint when `detector.weights` names one
(`utils/torch_convert.load_detector_weights`), or the JAX package's
(`detector_params_from_jax`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nafae_torch.config import DetectorConfig
from nafae_torch.device import resolve_device
from nafae_torch.models.detector.anchors import generate_anchors
from nafae_torch.models.detector.heads import DetectionHead, decode_detections
from nafae_torch.models.detector.resnet import (RESNET_BLOCKS, ResNetC4,
                                                ResNetC5Head, fold_frozen_bn)
from nafae_torch.models.detector.rpn import RPNHead, select_proposals_batched
from nafae_torch.models.detector.vgg import VGG16Features, VGG16RoIHead
from nafae_torch.ops import roi_align as RA
from nafae_torch.ops.kernels import roi_align as K5

STRIDE = 16
DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
# detector.dtype=float16, which the reference runs: not yet on any device
F16_REFUSAL = ("detector.dtype=float16 is not ported yet: ROADMAP Queue 1 "
               "item 17 (K5 at f16 and f16 convolutions over ResNet-50 and "
               "VGG16); use float32 or bfloat16")


class FasterRCNNExtractor(nn.Module):
    def __init__(self, cfg: DetectorConfig, use_pallas_roi_align: bool = False,
                 use_pallas_nms: bool = False, with_detections: bool = False,
                 num_classes: int = 67):
        super().__init__()
        if cfg.backbone not in (*RESNET_BLOCKS, "vgg16"):
            raise ValueError(f"unknown detector.backbone {cfg.backbone!r}; "
                             "resnet50 | resnet101 | vgg16")
        if cfg.dtype == "float16":
            raise NotImplementedError(F16_REFUSAL)
        if cfg.dtype not in DTYPES:
            raise ValueError(f"unknown detector.dtype {cfg.dtype!r}; "
                             f"{' | '.join(DTYPES)}")
        self.cfg = cfg
        self.use_pallas_roi_align = use_pallas_roi_align
        self.use_pallas_nms = use_pallas_nms
        self.with_detections = with_detections
        dt = DTYPES[cfg.dtype]
        if cfg.backbone == "vgg16":
            self.backbone = VGG16Features(dtype=dt)
            self.head = VGG16RoIHead(dtype=dt)
            channels, feat_dim = 512, 4096
        else:
            self.backbone = ResNetC4(RESNET_BLOCKS[cfg.backbone], dtype=dt,
                                     stem_s2d=cfg.stem_s2d,
                                     stem_pad_ch=cfg.stem_pad_ch,
                                     stem_im2col=cfg.stem_im2col,
                                     stem_nminor=cfg.stem_nminor)
            self.head = ResNetC5Head(dtype=dt)
            channels, feat_dim = 1024, 2048
        a = len(cfg.anchor_scales) * len(cfg.anchor_ratios)
        self.rpn = RPNHead(a, channels=cfg.rpn_channels,
                           in_channels=channels)
        if with_detections:
            self.det_head = DetectionHead(num_classes, in_features=feat_dim)
        self._anchors: dict = {}

    def anchors(self, fh: int, fw: int, device) -> torch.Tensor:
        key = (fh, fw, str(device))
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(generate_anchors(
                fh, fw, STRIDE, self.cfg.anchor_scales,
                self.cfg.anchor_ratios)).to(device)
        return self._anchors[key]

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> dict:
        """images [B,H,W,3] (float, 0..1, H = W = image_size) ->
        {boxes [B,R,4], scores [B,R], feats [B,R,2048 or 4096] f32,
        region_valid [B,R]} (+ det_boxes, det_scores, det_classes)."""
        cfg = self.cfg
        feat = self.backbone(images)                         # [B,h,w,C]
        b, fh, fw, _ = feat.shape
        anchors = self.anchors(fh, fw, feat.device)
        obj, deltas = self.rpn(feat, raw=cfg.full_pool_nms)
        deltas_raw = None
        if cfg.full_pool_nms:
            deltas, deltas_raw = None, deltas
        pallas_nms = (self.use_pallas_nms or cfg.nms_impl == "pallas"
                      or (cfg.nms_impl == "auto" and images.is_cuda))
        boxes, scores, keep_valid = select_proposals_batched(
            obj, deltas, anchors, cfg.image_size, cfg.rpn_pre_nms_topk,
            cfg.num_proposals, cfg.nms_iou_thresh,
            nms_impl="pallas" if pallas_nms else "jnp",
            topk_impl=("none" if cfg.full_pool_nms
                       else "window" if cfg.topk_window > 1
                       else "approx" if cfg.approx_topk else "exact"),
            topk_window=cfg.topk_window, deltas_raw=deltas_raw)

        r = cfg.num_proposals
        roi_impl = "pallas" if self.use_pallas_roi_align else cfg.roi_impl
        if roi_impl == "pallas":
            pooled = K5.roi_align(feat, boxes, 7, 1.0 / STRIDE)  # [B·R,7,7,C]
        else:
            fn = (RA.roi_align_combined if roi_impl == "combined"
                  else RA.roi_align_matmul)
            pooled = fn(feat, boxes, 7, 1.0 / STRIDE).reshape(
                b * r, 7, 7, feat.shape[-1])
        roi_feats = self.head(pooled)                        # [B·R,D]
        out = {"boxes": boxes, "scores": scores,
               "feats": roi_feats.reshape(b, r, -1),
               "region_valid": keep_valid}
        if self.with_detections:
            logits, d = self.det_head(roi_feats)
            det = decode_detections(boxes, logits.reshape(b, r, -1),
                                    d.reshape(b, r, *d.shape[1:]),
                                    cfg.image_size)
            out["det_boxes"] = det["boxes"]
            out["det_scores"] = det["scores"]
            out["det_classes"] = det["classes"]
        return out


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """flax's lecun_normal: a normal truncated to ±2 std, scaled so its
    variance is 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / .87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


@torch.no_grad()
def init_detector(cfg: DetectorConfig, generator: torch.Generator,
                  use_pallas_roi_align: bool = False,
                  device: str | torch.device | None = None, **kwargs
                  ) -> FasterRCNNExtractor:
    """The detector cfg describes, on `device` (cuda unless the caller
    asks for the CPU): random weights in the flax initialisers'
    distributions (lecun-normal conv and dense kernels, zero biases, unit
    scale and variance in every FrozenBN) drawn on the CPU from
    `generator`; then, when cfg.weights names a torch checkpoint, its
    weights (`utils/torch_convert.load_detector_weights`: what the
    checkpoint lacks keeps its random draw); then BN folded when
    cfg.fold_bn, after the load, as the reference's callers fold. kwargs
    go to FasterRCNNExtractor."""
    device = resolve_device(device)
    model = FasterRCNNExtractor(cfg, use_pallas_roi_align, **kwargs)
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            w = torch.empty(mod.weight.shape)
            _lecun_normal_(w, w[0].numel(), generator)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            w = torch.empty(mod.weight.shape)
            _lecun_normal_(w, w.shape[1], generator)
            mod.weight.copy_(w)
            mod.bias.zero_()
    if cfg.weights:
        from nafae_torch.utils.torch_convert import load_detector_weights
        load_detector_weights(cfg.weights, model,
                              num_scales=len(cfg.anchor_scales),
                              num_ratios=len(cfg.anchor_ratios))
    if cfg.fold_bn:
        fold_frozen_bn(model)
    return model.to(device).eval()


def detector_params_from_jax(np_tree: dict) -> dict[str, torch.Tensor]:
    """The flax tree of the JAX package's `init_detector` (as numpy arrays,
    with or without its top-level "params") -> a state dict for
    FasterRCNNExtractor.load_state_dict: HWIO conv kernels become OIHW,
    dense kernels are transposed, FrozenBN vectors load as buffers."""
    tree = np_tree.get("params", np_tree)
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + [k])
                continue
            a = np.asarray(v, np.float32)
            name = ".".join(prefix)
            if k == "kernel" and a.ndim == 4:
                out[name + ".weight"] = torch.from_numpy(
                    np.ascontiguousarray(a.transpose(3, 2, 0, 1)))
            elif k == "kernel":
                out[name + ".weight"] = torch.from_numpy(
                    np.ascontiguousarray(a.T))
            else:
                out[name + "." + k] = torch.from_numpy(a.copy())

    walk(tree, [])
    return out
