"""VGG16 backbone: conv5_3 features and the fc6/fc7 RoI head (the port of
`nafae_tpu/models/detector/vgg.py`).

conv1_1..conv5_3 with the last max pool dropped give stride-16 features with
512 channels; the RoI head is fc6 -> fc7 on the 7x7 RoIAlign crop, pooled to
4096-d features (so the grounding model runs with model.feat_dim=4096). No
batch norm (classic VGG) and no dropout: the detector is frozen.

Modules are named as the flax tree names its scopes (`Conv_0`..`Conv_12`,
`Dense_0`, `Dense_1`), so that the reference's parameters load by name
(`faster_rcnn.detector_params_from_jax`). Convolutions are the ResNet's
`Conv` (f32 weights cast to the input's dtype, channels_last); ReLU runs in
place, which keeps two full-resolution maps alive at conv1_2 instead of
three (at 640x640, 320 frames of 64 f32 channels are 33.6 GB each).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from nafae_torch.models.detector.resnet import Conv

# (torchvision `features` module index, out_channels) of each conv, in order.
# Pools sit after blocks 1-4 (indices 4, 9, 16, 23); the stride-32 pool at
# index 30 is dropped, as in the faster-rcnn.pytorch lineage (features[:-1]).
VGG16_CONV_LAYERS = (
    (0, 64), (2, 64),
    (5, 128), (7, 128),
    (10, 256), (12, 256), (14, 256),
    (17, 512), (19, 512), (21, 512),
    (24, 512), (26, 512), (28, 512),
)
_POOL_AFTER = {1, 3, 6, 9}    # conv ordinal (0-based) followed by a 2x2 pool


class VGG16Features(nn.Module):
    """conv1_1..conv5_3, final pool dropped: images [B,H,W,3] -> features
    [B,H/16,W/16,512] (NHWC views of channels_last tensors). dtype:
    activation dtype (None: f32); params stay f32."""

    def __init__(self, dtype=None):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for i, (_, ch) in enumerate(VGG16_CONV_LAYERS):
            self.add_module(f"Conv_{i}", Conv(cin, ch, 3, padding=1,
                                              bias=True))
            cin = ch

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        y = images.permute(0, 3, 1, 2)
        if self.dtype is not None:
            y = y.to(self.dtype)
        for i in range(len(VGG16_CONV_LAYERS)):
            y = getattr(self, f"Conv_{i}")(y)
            y = F.relu_(y)
            if i in _POOL_AFTER:
                y = F.max_pool2d(y, 2, 2)
        return y.permute(0, 2, 3, 1)


class VGG16RoIHead(nn.Module):
    """fc6 -> fc7 on the flattened 7x7 RoI crop: [N,7,7,512] -> [N,4096]
    f32. The flatten is in (h, w, c) order, as the flax head flattens; the
    converter permutes a torch checkpoint's fc6 (which flattens (c, h, w))
    to match."""

    def __init__(self, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = nn.Linear(7 * 7 * 512, 4096)
        self.Dense_1 = nn.Linear(4096, 4096)

    def forward(self, rois: torch.Tensor) -> torch.Tensor:
        y = rois if self.dtype is None else rois.to(self.dtype)
        y = y.reshape(y.shape[0], -1)                    # (h, w, c)
        for fc in (self.Dense_0, self.Dense_1):
            y = F.relu_(F.linear(y, fc.weight.to(y.dtype),
                                 fc.bias.to(y.dtype)))
        return y.float()
