"""Torch checkpoints -> the port's parameters (the port of
`nafae_tpu/utils/torch_convert.py`).

Two kinds of checkpoint:

- a grounding model's (`convert_state_dict`, `convert_pth`, the CLI): the
  flat params the port's server and trainer read, {word_emb [V,E],
  w_v [D,E], b_v [E]} plus attn_w [E] and m_sim [E,E] when the source has
  them, written as an .npz;

      python -m nafae_torch.utils.torch_convert model.pth params.npz \\
          [--map '{"w_v": ["my.proj.weight"]}']

- a detector's (`load_detector_weights`): a torchvision resnet50/resnet101
  or vgg16 state dict (backbone and RoI head), or a faster-rcnn.pytorch
  checkpoint (RCNN_base/RCNN_top, the RPN and the detection head; ResNet or
  VGG16 backbone), written straight into a `FasterRCNNExtractor`'s state
  dict: conv weights stay OIHW and linear weights [out, in], as torch
  stores them; only fc6's input axis is permuted, from torch's (c, h, w)
  flatten to the head's (h, w, c). What the checkpoint lacks keeps the
  model's own weights. A checkpoint of one lineage aimed at a detector of
  the other, or of another depth, raises ValueError naming the fix.

The values are the JAX package's converters' bit for bit (held by
`tests/test_torch_convert.py` against `load_detector_weights` there, then
`faster_rcnn.detector_params_from_jax`).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from nafae_torch.models.detector.vgg import VGG16_CONV_LAYERS

DEFAULT_MAP = {
    "word_emb": ["word_emb", "emb.weight", "embedding.weight",
                 "txt_emb.weight"],
    "w_v": ["w_v", "vis_proj.weight", "proj.weight", "visual_emb.weight"],
    "b_v": ["b_v", "vis_proj.bias", "proj.bias", "visual_emb.bias"],
}

# the optional params of model.frame_pool=learned and
# model.similarity=bilinear: mapped when a source key is present
OPTIONAL_MAP = {
    "attn_w": ["attn_w", "frame_attn.weight", "attn.weight",
               "frame_scorer.weight"],
    "m_sim": ["m_sim", "bilinear.weight", "sim.weight", "M"],
}


def _to_numpy_dict(state_dict: dict) -> dict:
    """torch tensors (or arrays) -> host numpy arrays."""
    return {k: np.asarray(v.detach().cpu().numpy()
                          if hasattr(v, "detach") else v)
            for k, v in state_dict.items()}


def convert_state_dict(state_dict: dict, key_map: dict | None = None,
                       expect: dict | None = None) -> dict:
    """torch state_dict (tensors or arrays) -> {word_emb, w_v, b_v, ...}
    as f32 numpy. A torch-named w_v source (a Linear's [E, D] weight) is
    always transposed to [D, E], square or not; one named w_v is taken as
    it is. expect: {name: shape} to check."""
    key_map = key_map or DEFAULT_MAP
    flat = _to_numpy_dict(state_dict)
    out = {}
    for ours, candidates in key_map.items():
        found = None
        for c in candidates:
            if c in flat:
                found = flat[c]
                break
        if found is None:
            raise KeyError(
                f"no source key for {ours!r}; tried {candidates}; "
                f"checkpoint has {sorted(flat)[:20]}...")
        if ours == "w_v" and found.ndim == 2 and c != "w_v":
            found = found.T
        out[ours] = found.astype(np.float32)
    for ours, candidates in OPTIONAL_MAP.items():
        for c in candidates:
            if c in flat:
                v = np.asarray(flat[c], np.float32)
                # a [1,E]/[E,1] torch Linear scorer weight -> a flat [E]
                out[ours] = v.reshape(-1) if ours == "attn_w" else v
                break
    if expect:
        for k, shape in expect.items():
            if tuple(out[k].shape) != tuple(shape):
                raise ValueError(f"{k}: shape {out[k].shape} != expected {shape}")
    return out


def convert_pth(pth_path: str, out_path: str | None = None,
                key_map: dict | None = None) -> dict:
    """Load a .pth (weights only; a "state_dict" entry is unwrapped) and
    convert it; with out_path, also save the params as an .npz."""
    obj = torch.load(pth_path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    params = convert_state_dict(obj, key_map)
    if out_path:
        np.savez(out_path, **params)
    return params


def _resnet_blocks_of(flat: dict) -> tuple:
    """The conv2..conv4 block counts of a torchvision-style state dict
    (resnet50 -> (3,4,6), resnet101 -> (3,4,23))."""
    blocks = []
    for stage in (1, 2, 3):
        n = 0
        while f"layer{stage}.{n}.conv1.weight" in flat:
            n += 1
        blocks.append(n)
    return tuple(blocks)


class _Target:
    """The model's state dict, written in place key by key; a shape that
    differs from the model's raises (a config that does not match the
    checkpoint, e.g. detector.rpn_channels)."""

    def __init__(self, model: torch.nn.Module):
        self.sd = model.state_dict()

    @torch.no_grad()
    def put(self, key: str, value: np.ndarray) -> None:
        dst = self.sd[key]
        if tuple(dst.shape) != tuple(value.shape):
            raise ValueError(
                f"{key}: the checkpoint gives shape {tuple(value.shape)}, "
                f"the detector has {tuple(dst.shape)} — match the "
                "detector.* config to the checkpoint (rpn_channels, "
                "anchor_scales, anchor_ratios)")
        dst.copy_(torch.from_numpy(np.ascontiguousarray(value, np.float32)))


def convert_detector_resnet50(state_dict: dict, model: torch.nn.Module
                              ) -> torch.nn.Module:
    """A torchvision-style resnet50/resnet101 state dict -> the ResNet C4
    backbone (conv1 + layer1-3) and the C5 head (layer4) of `model`, in
    place (depth read from the block counts). Convolutions copy as they
    are; BN weight/bias/running_mean/running_var load as the FrozenBN's
    scale/bias/mean/var. The RPN and detection head are left as they are.
    Returns model."""
    if not hasattr(model.head, "Bottleneck_0"):
        raise ValueError(
            "checkpoint is the resnet lineage but the detector is not — "
            "init the model with detector.backbone=resnet50 or resnet101 "
            "(and model.feat_dim=2048)")
    flat = _to_numpy_dict(state_dict)
    blocks = _resnet_blocks_of(flat)
    n_total = sum(blocks)
    have = model.backbone.num_blocks
    if have != n_total:
        raise ValueError(
            f"checkpoint depth (blocks {blocks}, {n_total} bottlenecks) does "
            f"not match the detector ({have} bottlenecks) — init the model "
            "with the matching detector.backbone (resnet50 = 13, resnet101 "
            "= 30)")
    dst = _Target(model)

    def conv(to, name):
        dst.put(to + ".weight", flat[name + ".weight"])

    def bn(to, name):
        for ours, theirs in (("scale", "weight"), ("bias", "bias"),
                             ("mean", "running_mean"), ("var", "running_var")):
            dst.put(f"{to}.{ours}", flat[f"{name}.{theirs}"].astype(np.float32))

    conv("backbone.Conv_0", "conv1")
    bn("backbone.FrozenBN_0", "bn1")
    bi = 0
    for stage, n_blocks in enumerate(blocks, start=1):
        for b in range(n_blocks):
            _copy_bottleneck(f"backbone.Bottleneck_{bi}", f"layer{stage}.{b}",
                             conv, bn, flat)
            bi += 1
    for b in range(3):
        _copy_bottleneck(f"head.Bottleneck_{b}", f"layer4.{b}", conv, bn, flat)
    return model


def _copy_bottleneck(to, src, conv, bn, flat):
    for i in (0, 1, 2):
        conv(f"{to}.Conv_{i}", f"{src}.conv{i + 1}")
        bn(f"{to}.FrozenBN_{i}", f"{src}.bn{i + 1}")
    if f"{src}.downsample.0.weight" in flat:
        conv(f"{to}.Conv_3", f"{src}.downsample.0")
        bn(f"{to}.FrozenBN_3", f"{src}.downsample.1")


def convert_detector_vgg16(state_dict: dict, model: torch.nn.Module
                           ) -> torch.nn.Module:
    """A torchvision-style vgg16 state dict -> the VGG16 backbone
    (features.{i} convs, `vgg.VGG16_CONV_LAYERS`) and the fc6/fc7 head
    (classifier.0 / classifier.3) of `model`, in place. fc6's input axis
    is permuted from torch's (c,h,w) flatten to the head's (h,w,c). The
    RPN and detection head are left as they are. Returns model."""
    if not hasattr(model.head, "Dense_0"):
        raise ValueError(
            "checkpoint is the vgg16 lineage but the detector is not — "
            "init the model with detector.backbone=vgg16 (plus "
            "rpn_channels=512 and model.feat_dim=4096 for the fc7 features)")
    flat = _to_numpy_dict(state_dict)
    dst = _Target(model)
    for i, (li, _) in enumerate(VGG16_CONV_LAYERS):
        for part in ("weight", "bias"):
            dst.put(f"backbone.Conv_{i}.{part}",
                    flat[f"features.{li}.{part}"].astype(np.float32))
    w6 = flat["classifier.0.weight"]                # [4096, 512*7*7] (c,h,w)
    w6 = w6.reshape(4096, 512, 7, 7).transpose(0, 2, 3, 1).reshape(4096, -1)
    dst.put("head.Dense_0.weight", w6.astype(np.float32))
    dst.put("head.Dense_0.bias", flat["classifier.0.bias"].astype(np.float32))
    dst.put("head.Dense_1.weight",
            flat["classifier.3.weight"].astype(np.float32))
    dst.put("head.Dense_1.bias", flat["classifier.3.bias"].astype(np.float32))
    return model


# faster-rcnn.pytorch lineage: RCNN_base wraps conv1+bn1+layer1-3, RCNN_top
# wraps layer4.
FASTER_RCNN_BASE_RENAMES = {
    "RCNN_base.0.": "conv1.",
    "RCNN_base.1.": "bn1.",
    "RCNN_base.4.": "layer1.",
    "RCNN_base.5.": "layer2.",
    "RCNN_base.6.": "layer3.",
    "RCNN_top.0.": "layer4.",
}


def anchor_permutation(num_scales: int, num_ratios: int) -> np.ndarray:
    """perm[a_ours] = source anchor index, mapping the faster-rcnn.pytorch
    ratio-major per-cell anchor order (a = ratio·nS + scale) onto the
    port's (`anchors.generate_anchors`: scale-major, a = scale·nR +
    ratio)."""
    perm = np.empty(num_scales * num_ratios, np.int64)
    for s in range(num_scales):
        for r in range(num_ratios):
            perm[s * num_ratios + r] = r * num_scales + s
    return perm


def convert_faster_rcnn(state_dict: dict, model: torch.nn.Module,
                        num_scales: int = 5, num_ratios: int = 3,
                        bbox_stds=(0.1, 0.1, 0.2, 0.2),
                        bbox_means=(0.0, 0.0, 0.0, 0.0)) -> torch.nn.Module:
    """A whole faster-rcnn.pytorch checkpoint -> `model`, in place.

    Beyond the backbone and RoI head:
      * RPN: RCNN_rpn.RPN_Conv (3x3) -> rpn.Conv_0; the 2A-channel bg/fg
        softmax RPN_cls_score folds to A objectness logits fg − bg
        (sigmoid(fg − bg) is the softmax's fg probability, so proposals
        rank as the source's); RPN_bbox_pred -> rpn.Conv_2. Anchor
        channels are permuted from the source's ratio-major order to the
        port's scale-major one, in both convs (`anchor_permutation`).
      * Detection head (when the model has one): RCNN_cls_score ->
        det_head.cls, RCNN_bbox_pred -> det_head.reg with the lineage's
        BBOX_NORMALIZE stds/means folded into the weights (the source
        denormalizes its predictions at test time; the port applies
        deltas raw).

    The lineage's RPN conv is 512 wide: build the model with
    detector.rpn_channels=512. The backbone is read from the checkpoint:
    RCNN_base.0.weight shaped [64,3,3,3] (a 3x3 conv on RGB) is the vgg16
    variant (RCNN_base = vgg.features[:-1], RCNN_top.{0,3} = fc6/fc7), else
    ResNet. Returns model."""
    flat = _normalize_sd(_to_numpy_dict(state_dict))
    if flat["RCNN_base.0.weight"].shape == (64, 3, 3, 3):      # vgg16 lineage
        tv = {}
        for k, v in flat.items():
            if k.startswith("RCNN_base."):
                tv["features." + k[len("RCNN_base."):]] = v
            elif k.startswith("RCNN_top."):                    # 0=fc6, 3=fc7
                tv["classifier." + k[len("RCNN_top."):]] = v
        convert_detector_vgg16(tv, model)
    else:
        tv = {}
        for k, v in flat.items():
            for src, dst in FASTER_RCNN_BASE_RENAMES.items():
                if k.startswith(src):
                    tv[dst + k[len(src):]] = v
                    break
        convert_detector_resnet50(tv, model)
    a = num_scales * num_ratios
    perm = anchor_permutation(num_scales, num_ratios)
    dst = _Target(model)
    dst.put("rpn.Conv_0.weight", flat["RCNN_rpn.RPN_Conv.weight"])
    dst.put("rpn.Conv_0.bias",
            flat["RCNN_rpn.RPN_Conv.bias"].astype(np.float32))
    # cls: channels 0..A-1 are bg, A..2A-1 fg (the lineage's view(B,2,·,W))
    wc = flat["RCNN_rpn.RPN_cls_score.weight"]              # [2A,C,1,1]
    bc = flat["RCNN_rpn.RPN_cls_score.bias"]
    dst.put("rpn.Conv_1.weight", (wc[a + perm] - wc[perm]).astype(np.float32))
    dst.put("rpn.Conv_1.bias", (bc[a + perm] - bc[perm]).astype(np.float32))
    # bbox: 4A channels = A anchor-major groups of (dx,dy,dw,dh)
    wd = flat["RCNN_rpn.RPN_bbox_pred.weight"]              # [4A,C,1,1]
    bd = flat["RCNN_rpn.RPN_bbox_pred.bias"]
    sh = wd.shape[1:]
    dst.put("rpn.Conv_2.weight",
            wd.reshape(a, 4, *sh)[perm].reshape(4 * a, *sh).astype(
                np.float32))
    dst.put("rpn.Conv_2.bias",
            bd.reshape(a, 4)[perm].reshape(-1).astype(np.float32))

    if hasattr(model, "det_head") and "RCNN_cls_score.weight" in flat:
        dst.put("det_head.cls.weight",
                flat["RCNN_cls_score.weight"].astype(np.float32))
        dst.put("det_head.cls.bias",
                flat["RCNN_cls_score.bias"].astype(np.float32))
        wr = flat["RCNN_bbox_pred.weight"]                  # [(C+1)*4, F]
        br = flat["RCNN_bbox_pred.bias"]
        stds = np.tile(np.asarray(bbox_stds, np.float32), wr.shape[0] // 4)
        means = np.tile(np.asarray(bbox_means, np.float32), wr.shape[0] // 4)
        dst.put("det_head.reg.weight",
                (wr * stds[:, None]).astype(np.float32))
        dst.put("det_head.reg.bias", (br * stds + means).astype(np.float32))
    return model


def _normalize_sd(flat: dict) -> dict:
    """Strip DataParallel 'module.' prefixes."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in flat.items()}


def load_detector_weights(pth_path: str, model: torch.nn.Module,
                          num_scales: int = 5, num_ratios: int = 3
                          ) -> torch.nn.Module:
    """Load a detector .pth (weights only) into `model`, in place, by its
    lineage: faster-rcnn.pytorch checkpoints (RCNN_base.* keys, usually
    nested under "model") get the whole conversion, RPN and detection head
    included (ResNet or VGG16 backbone, read from the checkpoint); plain
    torchvision resnet50/101 or vgg16 state dicts give the backbone and RoI
    head only. Returns model."""
    obj = torch.load(pth_path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for nest in ("model", "state_dict"):
            if nest in obj and isinstance(obj[nest], dict):
                obj = obj[nest]
                break
    flat = _normalize_sd(_to_numpy_dict(obj))
    if any(k.startswith("RCNN_base.") for k in flat):
        return convert_faster_rcnn(flat, model, num_scales, num_ratios)
    if "features.0.weight" in flat:        # torchvision vgg16
        return convert_detector_vgg16(flat, model)
    return convert_detector_resnet50(flat, model)


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser("nafae_torch.utils.torch_convert")
    p.add_argument("pth")
    p.add_argument("out", help="output .npz")
    p.add_argument("--map", default=None, help="JSON key map override")
    args = p.parse_args(argv)
    key_map = json.loads(args.map) if args.map else None
    params = convert_pth(args.pth, args.out, key_map)
    print(json.dumps({k: list(v.shape) for k, v in params.items()}))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
