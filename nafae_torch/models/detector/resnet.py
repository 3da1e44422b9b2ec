"""ResNet backbone: C4 features and the C5 RoI head (the port of
`nafae_tpu/models/detector/resnet.py`).

The classic Faster R-CNN split: conv1..conv4 give stride-16 features with
1024 channels, and the conv5 stage runs per RoI after RoIAlign, pooled to
2048-d. Batch norm is frozen. Modules are named as the flax tree names its
scopes (`Conv_0`, `FrozenBN_0`, `Bottleneck_3`, ...), so that the reference's
parameters load by name (`faster_rcnn.detector_params_from_jax`).

Convolutions are `nn.Conv2d` in channels_last memory order: an NHWC tensor
viewed as [B,C,H,W] costs no copy. Weights stay f32 and are cast to the
input's dtype at each call, as flax casts its f32 params to the module
dtype. Padding is explicit and symmetric where the reference pads so
((1,1) in the 3x3 convs, (3,3) in the stem, (1,1) in the max pool), which is
also PyTorch's convention.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# conv2..conv4 bottleneck counts per depth (the C5 head is always 3 blocks)
RESNET_BLOCKS = {"resnet50": (3, 4, 6), "resnet101": (3, 4, 23)}

BN_EPS = 1e-5


class Conv(nn.Conv2d):
    """nn.Conv2d whose f32 weights are cast to the input's dtype per call,
    stored channels_last."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, bias: bool = False):
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         bias=bias)
        self.weight.data = self.weight.data.contiguous(
            memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, b, self.stride, self.padding)


class FrozenBN(nn.Module):
    """Inference-style normalisation with fixed statistics: y = x·inv +
    shift, inv = scale / sqrt(var + 1e-5), shift = bias - mean·inv, both
    derived in f32 and cast to the input's dtype, applied in one pass over
    x (`addcmul`). The four vectors are buffers: the detector is frozen."""

    def __init__(self, features: int):
        super().__init__()
        for name, val in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0),
                          ("var", 1.0)):
            self.register_buffer(name, torch.full((features,), val))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.scale / torch.sqrt(self.var + BN_EPS)
        shift = self.bias - self.mean * inv
        inv, shift = inv.to(x.dtype), shift.to(x.dtype)
        return torch.addcmul(shift[:, None, None], x, inv[:, None, None])


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.Conv_0 = Conv(cin, features, 1)
        self.FrozenBN_0 = FrozenBN(features)
        self.Conv_1 = Conv(features, features, 3, stride, padding=1)
        self.FrozenBN_1 = FrozenBN(features)
        self.Conv_2 = Conv(features, features * 4, 1)
        self.FrozenBN_2 = FrozenBN(features * 4)
        self.project = cin != features * 4 or stride != 1
        if self.project:
            self.Conv_3 = Conv(cin, features * 4, 1, stride)
            self.FrozenBN_3 = FrozenBN(features * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.FrozenBN_0(self.Conv_0(x)))
        y = F.relu(self.FrozenBN_1(self.Conv_1(y)))
        y = self.FrozenBN_2(self.Conv_2(y))
        residual = self.FrozenBN_3(self.Conv_3(x)) if self.project else x
        return F.relu(y + residual)


class ResNetC4(nn.Module):
    """conv1..conv4: images [B,H,W,3] -> features [B,H/16,W/16,1024] (NHWC
    views of channels_last tensors: no copy either way). dtype: activation
    dtype (None: f32); params stay f32.

    The stem is the plain 7x7/s2 convolution. The reference's stem knobs
    (`stem_s2d`, `stem_pad_ch`, `stem_im2col`, `stem_nminor`) are the same
    sums arranged for the TPU's convolution emitter; they are not ported and
    raise NotImplementedError."""

    def __init__(self, blocks=(3, 4, 6), dtype=None, stem_s2d: bool = False,
                 stem_pad_ch: int = 0, stem_im2col: bool = False,
                 stem_nminor: bool = False):
        super().__init__()
        knobs = {"detector.stem_s2d": stem_s2d,
                 "detector.stem_pad_ch": stem_pad_ch > 0,
                 "detector.stem_im2col": stem_im2col,
                 "detector.stem_nminor": stem_nminor}
        on = [k for k, v in knobs.items() if v]
        if on:
            raise NotImplementedError(
                f"{', '.join(on)}: the TPU stem layouts are not ported; the "
                "port runs the plain 7x7/s2 stem (the same sums)")
        self.dtype = dtype
        self.Conv_0 = Conv(3, 64, 7, 2, padding=3)
        self.FrozenBN_0 = FrozenBN(64)
        cin, n = 64, 0
        for stage, n_blocks in enumerate(blocks):
            feats = 64 * (2 ** stage)
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                self.add_module(f"Bottleneck_{n}",
                                Bottleneck(cin, feats, stride))
                cin, n = feats * 4, n + 1
        self.num_blocks = n

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        if self.dtype is not None:
            x = x.to(self.dtype)
        y = F.relu(self.FrozenBN_0(self.Conv_0(x)))
        y = F.max_pool2d(y, 3, 2, 1)
        for i in range(self.num_blocks):
            y = getattr(self, f"Bottleneck_{i}")(y)
        return y.permute(0, 2, 3, 1)


class ResNetC5Head(nn.Module):
    """conv5 stage per RoI: pooled RoIs [N,7,7,1024] -> [N,2048] f32,
    the 4x4 map averaged by adding its 16 positions in f32 one after the
    other (the reference's order), times 1/16."""

    def __init__(self, blocks: int = 3, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.blocks = blocks
        for b in range(blocks):
            self.add_module(f"Bottleneck_{b}",
                            Bottleneck(1024 if b == 0 else 2048, 512,
                                       2 if b == 0 else 1))

    def forward(self, rois: torch.Tensor) -> torch.Tensor:
        y = rois.permute(0, 3, 1, 2)
        y = y if self.dtype is None else y.to(self.dtype)
        for b in range(self.blocks):
            y = getattr(self, f"Bottleneck_{b}")(y)
        n, c, h, w = y.shape
        acc = y[:, :, 0, 0].float()
        for i in range(h):
            for j in range(w):
                if i or j:
                    acc = acc + y[:, :, i, j].float()
        return acc * (1.0 / (h * w))


@torch.no_grad()
def fold_frozen_bn(module: nn.Module) -> nn.Module:
    """Fold every FrozenBN into the bias-free convolution before it (each
    `FrozenBN_i` beside a `Conv_i`), in place, as the reference's
    `fold_frozen_bn` rewrites its tree: the kernel times inv, and the BN
    turned into an exact identity with shift (scale = sqrt(1 + eps) in f32,
    var 1, mean 0, bias = shift), so the forward's inv is exactly 1.0.
    Idempotent."""
    z = float(np.sqrt(np.float32(1.0) + np.float32(BN_EPS)).astype(np.float32))
    for mod in module.modules():
        for name, bn in list(mod.named_children()):
            if not (name.startswith("FrozenBN_")
                    and isinstance(bn, FrozenBN)):
                continue
            conv = getattr(mod, "Conv_" + name.split("_", 1)[1], None)
            if not isinstance(conv, nn.Conv2d) or conv.bias is not None:
                continue
            # the root in f64, rounded once: the correctly rounded f32
            # root the reference's numpy takes (torch's vectorised CPU sqrt
            # can be an ulp off)
            inv = bn.scale / torch.sqrt((bn.var + BN_EPS).double()).float()
            shift = bn.bias - bn.mean * inv
            conv.weight.mul_(inv[:, None, None, None])
            bn.scale.fill_(z)
            bn.var.fill_(1.0)
            bn.mean.zero_()
            bn.bias.copy_(shift)
    return module
