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
On the card a batch is one device program, as the reference's jitted
`_eval_batch`: a CUDA graph of `eval_batch`, captured at the first batch
of each shape and iou_thresh and replayed (`utils/cuda_graph.Graphed`);
on the CPU `eval_batch` runs eagerly.
`model.quantize=int8` projects with the int8 product over features
quantized per batch; `int8pre` reads int8 feature files (`extract
--quantize int8`) and sends them to the device as int8 with their scales.
Under a mesh (`--mesh`, with torchrun for more than one rank) each rank
scores its rows of every batch and the per-class counts are all-reduced:

    torchrun --nproc_per_node N -m nafae_torch.evaluate --mesh \\
        --preset config1 --override data.root=... [--device cpu]
"""

from __future__ import annotations

import functools
import json
import threading

import numpy as np
import torch

from nafae_torch.config import Config
from nafae_torch.device import resolve_device
from nafae_torch.ops import grounding as G
from nafae_torch.ops.iou import grounding_hits
from nafae_torch.utils import cuda_graph as CG


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


def eval_batch(params: dict, batch: dict, iou_thresh: float = 0.5
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(correct [B,K,T], gt_mask [B,K,T]) of a batch of tensors, on the
    batch's device, eagerly: the body of eval's device program."""
    with torch.inference_mode():
        # padded frames and words have gt_mask 0, so their argmax counts
        # for nothing
        return grounding_hits(masked_scores(params, batch), batch["boxes"],
                              batch["gt_boxes"], batch["gt_mask"], iou_thresh)


# eval's device programs, kept across `evaluate` calls as the reference's
# jit keeps its compiled programs: for each device and layout of the
# params, static buffers of the params and a `Graphed` of eval_batch over
# them (on the card a graph a batch shape and iou_thresh)
_PROGRAMS: dict = {}
_LOCK = threading.Lock()        # one `evaluate` at a time runs them


def _eval_batch(params: dict, device: torch.device) -> CG.Graphed:
    """The program that scores a batch (host arrays) with `params`:
    (batch, iou_thresh=...) -> (correct, gt_mask), read before the next
    call. The params are copied into its static buffers here, at each
    `evaluate`, so that a periodic eval in training scores the weights it
    is handed, not those an earlier capture saw."""
    key = (device, tuple((k, v.shape, v.dtype, v.stride())
                         for k, v in sorted(params.items())))
    if key not in _PROGRAMS:
        static = {k: torch.empty_like(v) for k, v in params.items()}
        _PROGRAMS[key] = CG.Graphed(functools.partial(eval_batch, static),
                                    device)
    program = _PROGRAMS[key]
    with torch.no_grad():
        for k, buf in program.fn.args[0].items():
            buf.copy_(params[k])
    return program


def evaluate(params: dict, dataset, batch_size: int, num_classes: int,
             iou_thresh: float = 0.5,
             device: str | torch.device | None = None, mesh=None) -> dict:
    """Grounding eval over `dataset` (built with with_gt=True), on `device`
    (cuda unless "cpu" is asked for). The ragged final batch is padded with
    zero rows to batch_size, as the reference pads it: they have gt_mask 0
    and contribute nothing.

    mesh (`parallel.make_mesh`): on the mesh's device, every batch is
    padded to a multiple of the data axis's W ranks, rank r scores rows
    [r·B/W, (r+1)·B/W), and the per-class counts are all-reduced, so every
    rank returns the single-device dict."""
    from nafae_torch.data.loader import BatchLoader
    from nafae_torch.parallel.sharding import shard_rows

    rank, world, group = 0, 1, None
    if mesh is not None:
        from nafae_torch.parallel.mesh import mesh_device
        group = mesh.get_group(mesh.mesh_dim_names[0])
        rank = torch.distributed.get_rank(group)
        world = torch.distributed.get_world_size(group)
        device = mesh_device(mesh)
    else:
        device = resolve_device(device)
    padded_b = -(-batch_size // world) * world
    params = {k: torch.as_tensor(v).to(device) for k, v in params.items()}
    loader = BatchLoader(dataset, batch_size, shuffle=False,
                         drop_remainder=False)
    per_class_correct = np.zeros(num_classes)
    per_class_total = np.zeros(num_classes)
    with _LOCK:
        program = _eval_batch(params, device)
        for batch in loader:
            mine = {k: shard_rows(_pad_rows(v, padded_b), rank, world)
                    for k, v in batch.items()}
            correct, gt_mask = program(mine, iou_thresh=iou_thresh)
            # rows past the batch's real ones are padding
            b_real = min(max(batch["word_ids"].shape[0]
                             - rank * len(correct), 0), len(correct))
            correct = correct.cpu().numpy()[:b_real]        # [B,K,T]
            gt_mask = gt_mask.cpu().numpy()[:b_real]
            b, k, t = correct.shape
            cls = np.broadcast_to(mine["word_ids"][:b_real, :, None],
                                  (b, k, t))
            np.add.at(per_class_correct, cls.ravel(),
                      (correct * gt_mask).ravel())
            np.add.at(per_class_total, cls.ravel(), gt_mask.ravel())
    if group is not None:
        from nafae_torch.parallel.sharding import all_reduce
        counts = all_reduce(torch.from_numpy(np.stack(
            [per_class_correct, per_class_total])).to(device), group)
        per_class_correct, per_class_total = counts.cpu().numpy()

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
                    device: str | torch.device | None = None,
                    mesh=None) -> dict:
    """Config-driven eval: loads the split (and, when params is None, the
    params of the newest checkpoint in train.ckpt_dir, shaped by the
    checkpoint itself, so that a config-4 checkpoint evaluates under the
    config1 preset). Without a checkpoint it evaluates a random init,
    unless require_checkpoint asks it to raise. mesh: see `evaluate`."""
    from nafae_torch.data.youcook2 import SegmentDataset
    from nafae_torch.models.grounding import inference_params

    if mesh is not None:
        from nafae_torch.parallel.mesh import mesh_device
        device = mesh_device(mesh)
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
                    device=device, mesh=mesh)


def main(argv=None) -> int:
    import argparse

    from nafae_torch.config import load_config

    p = argparse.ArgumentParser("nafae_torch.evaluate")
    p.add_argument("--preset", default="config1")
    p.add_argument("--config", default=None)
    p.add_argument("--override", nargs="*", action="extend", default=None)
    p.add_argument("--split", default="val")
    p.add_argument("--checkpoint", default=None,
                   help=".npz, a port checkpoint directory, or an orbax "
                        "checkpoint directory of the JAX package (the newest "
                        "step is restored)")
    p.add_argument("--per-class", action="store_true",
                   help="include the per-class accuracy table")
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--mesh", action="store_true",
                   help="shard each batch over the ranks of the job "
                        "(torchrun --nproc_per_node N): NCCL on the cards, "
                        "gloo with --device cpu")
    args = p.parse_args(argv)
    cfg = load_config(args.config, args.preset, args.override or [])
    mesh = None
    if args.mesh:
        from nafae_torch.parallel.mesh import make_mesh
        mesh = make_mesh(cfg.mesh.data_axis, 1, cfg.mesh.data_axis_name,
                         cfg.mesh.frame_axis_name, device=args.device)
    lead = mesh is None or torch.distributed.get_rank() == 0
    try:
        result = _run(cfg, args, mesh)
    finally:
        if mesh is not None:
            from nafae_torch.parallel.mesh import shutdown
            shutdown()
    if lead:
        print(json.dumps(result))
    return 0


def _run(cfg: Config, args, mesh) -> dict:
    params = None
    if args.checkpoint and args.checkpoint.endswith(".npz"):
        from nafae_torch.utils.checkpoint import load_eval_params
        params = load_eval_params(cfg, args.checkpoint, device=args.device)
    elif args.checkpoint:
        cfg.train.ckpt_dir = args.checkpoint
    result = evaluate_config(cfg, params=params, split=args.split,
                             require_checkpoint=args.checkpoint is not None,
                             device=args.device, mesh=mesh)
    if not args.per_class:
        result.pop("per_class_acc")
    return result


if __name__ == "__main__":
    import sys
    sys.exit(main())
