"""Evaluation: grounding inference and macro/micro box accuracy.

The port of `nafae_tpu/evaluate.py` (the paper's metric, config 1): for
each annotated (frame, object word) pair, the box of the region with the
highest similarity must reach IoU > 0.5 with the ground-truth box. The
correctness bits of a batch come from one pass on the device (embed →
project → similarity → region mask → `ops/iou.grounding_hits`); the
per-class sums are taken on the host.

    python -m nafae_torch.evaluate --preset config1 \\
        --override data.root=... [--checkpoint ckpt_dir|params.npz] \\
        [--per-class] [--device cpu]

Runs on cuda unless the caller asks for the CPU (`device.resolve_device`).
`model.quantize=int8` projects with the int8 product over features
quantized per batch; `int8pre` reads int8 feature files (`extract
--quantize int8`) and sends them to the device as int8 with their scales.
Not ported yet: evaluation sharded over several devices (the reference's
`mesh` and `--mesh`) waits for data parallelism (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from nafae_torch.config import Config
from nafae_torch.device import resolve_device
from nafae_torch.ops import grounding as G
from nafae_torch.ops.iou import grounding_hits


def masked_scores(params: dict, batch: dict) -> torch.Tensor:
    """The region scores [B,K,T,R] of a batch of tensors that eval takes
    the argmax of (invalid regions masked), on the batch's device."""
    with torch.inference_mode():
        w_emb = G.embed_words(batch["word_ids"], params["word_emb"],
                              m_sim=params.get("m_sim"))
        v_emb = G.project_params(params, batch["feats"],
                                 feats_scale=batch.get("feats_scale"))
        return G.mask_regions(G.similarity_tensor(w_emb, v_emb),
                              batch.get("region_mask"))


def _eval_batch(params: dict, batch: dict, iou_thresh: float = 0.5
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(correct [B,K,T], gt_mask [B,K,T]) of a batch of tensors, on the
    batch's device."""
    with torch.inference_mode():
        # padded frames and words have gt_mask 0, so their argmax counts
        # for nothing
        return grounding_hits(masked_scores(params, batch), batch["boxes"],
                              batch["gt_boxes"], batch["gt_mask"], iou_thresh)


def evaluate(params: dict, dataset, batch_size: int, num_classes: int,
             iou_thresh: float = 0.5,
             device: str | torch.device | None = None) -> dict:
    """Grounding eval over `dataset` (built with with_gt=True), on `device`
    (cuda unless "cpu" is asked for). The ragged final batch is padded with
    zero rows to batch_size, as the reference pads it: they have gt_mask 0
    and contribute nothing."""
    from nafae_torch.data.loader import BatchLoader
    from nafae_torch.train import batch_to_device

    device = resolve_device(device)
    params = {k: torch.as_tensor(v).to(device) for k, v in params.items()}
    loader = BatchLoader(dataset, batch_size, shuffle=False,
                         drop_remainder=False)
    per_class_correct = np.zeros(num_classes)
    per_class_total = np.zeros(num_classes)
    for batch in loader:
        padded = {k: _pad_rows(v, batch_size) for k, v in batch.items()}
        correct, gt_mask = _eval_batch(params,
                                       batch_to_device(padded, device),
                                       iou_thresh)
        b_real = batch["word_ids"].shape[0]
        correct = correct.cpu().numpy()[:b_real]        # [B,K,T]
        gt_mask = gt_mask.cpu().numpy()[:b_real]
        b, k, t = correct.shape
        cls = np.broadcast_to(batch["word_ids"][:, :, None], (b, k, t))
        np.add.at(per_class_correct, cls.ravel(),
                  (correct * gt_mask).ravel())
        np.add.at(per_class_total, cls.ravel(), gt_mask.ravel())

    seen = per_class_total > 0
    per_class_acc = np.zeros(num_classes)
    per_class_acc[seen] = per_class_correct[seen] / per_class_total[seen]
    micro = float(per_class_correct.sum() / max(per_class_total.sum(), 1.0))
    macro = float(per_class_acc[seen].mean()) if seen.any() else 0.0
    return {
        "box_acc_micro": micro,
        "box_acc_macro": macro,
        "num_annotations": int(per_class_total.sum()),
        "num_classes_seen": int(seen.sum()),
        "per_class_acc": {int(i): float(per_class_acc[i])
                          for i in np.nonzero(seen)[0]},
    }


def _pad_rows(x: np.ndarray, n: int) -> np.ndarray:
    if x.shape[0] >= n:
        return x
    pad = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(np.asarray(x), pad)


def evaluate_config(cfg: Config, params: dict | None = None,
                    split: str = "val", require_checkpoint: bool = False,
                    device: str | torch.device | None = None) -> dict:
    """Config-driven eval: loads the split (and, when params is None, the
    params of the newest checkpoint in train.ckpt_dir, shaped by the
    checkpoint itself, so that a config-4 checkpoint evaluates under the
    config1 preset). Without a checkpoint it evaluates a random init,
    unless require_checkpoint asks it to raise."""
    from nafae_torch.data.youcook2 import SegmentDataset
    from nafae_torch.models.grounding import inference_params

    device = resolve_device(device)
    ds = SegmentDataset(cfg.data.root, split, cfg.data.max_frames,
                        cfg.data.num_regions, cfg.data.feat_dim,
                        cfg.data.max_words, with_gt=True,
                        # int8pre: int8 feats + scales reach the device
                        # untouched (ValueError on non-int8 files)
                        keep_int8=cfg.model.quantize == "int8pre")
    if params is None:
        from nafae_torch.utils.checkpoint import load_eval_params
        params = load_eval_params(cfg, device=device)
        if params is None:
            if require_checkpoint:
                raise FileNotFoundError(
                    f"no checkpoint found in {cfg.train.ckpt_dir!r} — "
                    "refusing to evaluate randomly initialized parameters")
            from nafae_torch.train import TrainState
            params = TrainState.create(cfg, device=device, seed=0).params
    # model.quantize=int8|int8pre: the weights are quantized once, here
    params = inference_params(cfg, params)
    return evaluate(params, ds, cfg.data.batch_size, cfg.model.vocab_size,
                    device=device)


def main(argv=None) -> int:
    import argparse

    from nafae_torch.config import load_config

    p = argparse.ArgumentParser("nafae_torch.evaluate")
    p.add_argument("--preset", default="config1")
    p.add_argument("--config", default=None)
    p.add_argument("--override", nargs="*", action="extend", default=None)
    p.add_argument("--split", default="val")
    p.add_argument("--checkpoint", default=None,
                   help="a directory of the port's training checkpoints "
                        "(the newest is restored) or a converted params .npz")
    p.add_argument("--per-class", action="store_true",
                   help="include the per-class accuracy table")
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    cfg = load_config(args.config, args.preset, args.override or [])
    params = None
    if args.checkpoint and args.checkpoint.endswith(".npz"):
        from nafae_torch.utils.checkpoint import load_eval_params
        params = load_eval_params(cfg, args.checkpoint, device=args.device)
    elif args.checkpoint:
        cfg.train.ckpt_dir = args.checkpoint
    result = evaluate_config(cfg, params=params, split=args.split,
                             require_checkpoint=args.checkpoint is not None,
                             device=args.device)
    if not args.per_class:
        result.pop("per_class_acc")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
