"""Training: the config-2/3/4 step on precomputed RoI features and the
config-5 step on frames, the optimizer, the k-means refresh, the fit loop
and the CLI.

The port of `nafae_tpu/train.py` with the streaming loader: forward, the
three losses, their gradient (autograd; the context mix's gradient in the
CUDA kernels of `ops/kernels/ctx_mix.py` on the GPU), the optimizer update
and the periodic k-means refresh. `train.kernels=pallas` (or the legacy
`train.use_pallas=true`) takes the reference's fused route: the fused
cross-MIL (`ops/kernels/cross_mil.py`, K3a/K3b) for the score matrix and,
at config 4, the fused diag epilogue (`ops/kernels/diag.py`, K4f/K4b) for
the context and cluster losses. With `data.from_videos=true` (config 5)
batches carry frames: the loader decodes them (`data/video_dataset.py`) and
the step runs the frozen Faster R-CNN (`models/detector`, with the NMS and
RoIAlign kernels) before the losses.

    python -m nafae_torch.train --preset config4 --override data.root=... \\
        [--device cpu]
    python -m nafae_torch.train --preset config5 --override \\
        data.from_videos=true data.annotations=segments.jsonl

Config 5 takes a torch detector checkpoint through `detector.weights`
(`utils/torch_convert.load_detector_weights`, then the BN fold when
`detector.fold_bn`) and the VGG16 backbone through
`detector.backbone=vgg16`; `model.word_vectors` seeds `word_emb` from a
GloVe-style file and `loss.kmeans_init=plusplus` seeds the k-means centers
from step 0's selections.

    python -m nafae_torch.train --preset config5 --override \\
        data.from_videos=true data.annotations=segments.jsonl \\
        detector.backbone=vgg16 detector.rpn_channels=512 \\
        model.feat_dim=4096 detector.weights=frcnn_vgg16.pth \\
        model.word_vectors=glove.txt loss.kmeans_init=plusplus

Runs on cuda unless the caller asks for the CPU (`device.resolve_device`).
`model.matmul_precision=default` runs the f32 products of the losses and
their gradient in TF32 (`device.matmul_precision` around that part of
`step_body`, as the reference's compute_losses runs under its context);
k-means, the update, convolutions and the CUDA kernels stay exact.
Under a mesh (`parallel.make_mesh`; the CLI's `--mesh`) the step is data
parallel over the mesh's data axis and frame parallel over its frame
axis (`mesh.frame_axis`): every rank reads the same global batches and
trains on its rows and, under frame parallelism, its T/F consecutive
frames (`parallel/multihost.global_batch_spec`). The words and the score
diagonal are all-gathered over the data axis; the context window takes
its neighbours' frames through a halo exchange and the frame softmax is an
online softmax over the frame axis (`parallel/sp.py`); every loss is a
global sum or mean, and one all-reduce of the parameter gradients over
both axes gives every rank the exact global gradient, so the trajectory
is the single device's. NCCL on the cards, gloo with `--device cpu`:

    torchrun --nproc_per_node N -m nafae_torch.train --mesh \\
        --preset config4 --override data.root=... [mesh.frame_axis=F] \\
        [--device cpu]

`--multihost` starts one process group across hosts
(`parallel/multihost.init_multihost`: torchrun's, SLURM's or Open MPI's
environment) and meshes over every rank of it; data.batch_size stays the
global batch.

`train.tensorboard_dir` mirrors the logged scalars into a TensorBoard
event file; `--profile DIR` writes a torch.profiler trace of the run, and
`--debug-nans` turns on autograd's anomaly mode and checks every step's
losses and gradients. The CLI evaluates every `train.eval_every` steps on
the val split (`evaluate.evaluate_config`), as the reference's does.

`fit` runs the step through `build_train_fn`: on the card (no mesh, or
an NCCL mesh without a frame axis) the step, config 5's frozen detector
included, is captured in CUDA graphs and each step is a replay; on the
CPU, with debug_nans, on a gloo mesh and under frame parallelism the
same step body runs eagerly (`eager_reason`). `train.steps_per_call`
(spc) orders the steps and sets
the cadence as in the reference, where a group of spc steps is one XLA
program: the streaming fit applies spc batches of one frame bucket at a
time (the reference's `make_multi_step`: here spc replays with no host
read between them; with several buckets not in the loader's yield
order), takes the steps left over one by one, and logs, checkpoints and
evaluates once a group.
`train.device_cache=true` keeps the dataset on the device and gathers
each batch there, inside the captured step (`fit_device_cached`, with or
without a mesh).
Batches are packed by the C++ packer (`utils/native_io`, built by g++ at
first use) when `data.use_native_io` is on, and `data.pipeline=grain`
takes grain's batch order (`data/grain_loader`).

    python -m nafae_torch.train --preset config4 --override data.root=... \\
        train.device_cache=true train.steps_per_call=10 [--device cpu]
"""

from __future__ import annotations

import functools
import math
import os
import sys
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from nafae_torch.config import Config
from nafae_torch.device import matmul_precision, resolve_device
from nafae_torch.models.grounding import COMPUTE_DTYPES, init_params
from nafae_torch.ops import grounding as G
from nafae_torch.ops import losses as L
from nafae_torch.ops.kernels.diag import diag_epilogue
from nafae_torch.ops.kmeans import (bank_write, kmeans_init, kmeans_lloyd,
                                    kmeans_plusplus_init)
from nafae_torch.parallel import sharding as S
from nafae_torch.parallel import sp
from nafae_torch.utils import cuda_graph as CG
from nafae_torch.utils.cuda_graph import WARMUP_STEPS

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8      # optax.adamw's defaults
SGD_MOMENTUM = 0.9


@dataclass
class TrainState:
    step: int
    params: dict[str, torch.Tensor]
    opt_state: dict            # count + adam's mu/nu, or sgd's trace
    centers: torch.Tensor      # k-means centroids [Kc, E] (unit norm)
    # selection bank (loss.kmeans_source="bank"): ring of the last W steps'
    # selected region embeddings [W, B, T, K, E] and their validity
    bank: torch.Tensor | None = None
    bank_valid: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.centers.device

    @classmethod
    def create(cls, cfg: Config, device: str | torch.device | None = None,
               seed: int | None = None) -> "TrainState":
        """Random params and centers from a torch.Generator seeded with
        train.seed, on `device` (cuda unless "cpu" is asked for)."""
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(
            cfg.train.seed if seed is None else seed)
        params = init_params(cfg.model, gen, device)
        centers = kmeans_init(gen, cfg.loss.num_clusters,
                              cfg.model.embed_dim).to(device)
        bank = bank_valid = None
        if cfg.loss.kmeans_source == "bank" and cfg.loss.cluster_weight > 0:
            w, b = cfg.loss.bank_steps, cfg.data.batch_size
            t = (max(cfg.data.frame_buckets) if cfg.data.frame_buckets
                 else cfg.data.max_frames)
            k = cfg.data.max_words
            bank = torch.zeros((w, b, t, k, cfg.model.embed_dim),
                               device=device)
            bank_valid = torch.zeros((w, b, t, k), device=device)
        return cls(step=0, params=params,
                   opt_state=make_optimizer(cfg).init(params),
                   centers=centers, bank=bank, bank_valid=bank_valid)

    def state_dict(self) -> dict:
        """Everything, as CPU tensors and ints (what checkpoints store)."""
        cpu = lambda d: None if d is None else {   # noqa: E731
            k: v.detach().cpu() for k, v in d.items()}
        opt = {k: (cpu(v) if isinstance(v, dict) else v)
               for k, v in self.opt_state.items()}
        return {"step": self.step, "params": cpu(self.params),
                "opt_state": opt, "centers": self.centers.cpu(),
                "bank": None if self.bank is None else self.bank.cpu(),
                "bank_valid": (None if self.bank_valid is None
                               else self.bank_valid.cpu())}

    @classmethod
    def from_state_dict(cls, d: dict, device) -> "TrainState":
        to = lambda x: None if x is None else x.to(device)  # noqa: E731
        todict = lambda m: {k: v.to(device) for k, v in m.items()}  # noqa: E731
        opt = {k: (todict(v) if isinstance(v, dict) else v)
               for k, v in d["opt_state"].items()}
        return cls(step=int(d["step"]), params=todict(d["params"]),
                   opt_state=opt, centers=to(d["centers"]),
                   bank=to(d["bank"]), bank_valid=to(d["bank_valid"]))


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(tree[k].float() ** 2)
                          for k in sorted(tree)))


class Optimizer:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, wd)) (or
    sgd with momentum 0.9), written out so that the port updates exactly
    as optax does:

    - the schedule is warmup_cosine_decay_schedule(0, lr, warmup_steps,
      max(steps, warmup_steps + 1), lr / 100), read at the count BEFORE the
      update: the first update has lr 0;
    - the clip scales by grad_clip / norm when norm >= grad_clip, with no
      epsilon (torch's clip_grad_norm_ divides by norm + 1e-6);
    - adamw's decay is decoupled: p -= lr (m̂ / (sqrt(v̂) + 1e-8) + wd p).

    The per-count scalars (the step size -lr and Adam's bias corrections)
    are read from `tables`, built once on the host and kept on the
    device, by the count, so that a captured step reads the count it
    runs at.
    """

    def __init__(self, cfg: Config):
        tc = cfg.train
        self.kind = "sgd" if tc.optimizer == "sgd" else "adam"
        self.peak, self.warmup = tc.lr, tc.warmup_steps
        self.decay_steps = max(tc.steps, tc.warmup_steps + 1)
        self.end = tc.lr * 0.01
        self.wd = tc.weight_decay
        self.clip = tc.grad_clip
        self.steps = tc.steps
        self._tables: dict[torch.device, torch.Tensor] = {}

    def tables(self, device: str | torch.device, count: int = 0
               ) -> torch.Tensor:
        """[n, 3] f32 on `device`, row c the scalars of the update at
        count c: the step size -lr(c), then Adam's bias corrections
        1 - b1^(c+1) and 1 - b2^(c+1) (1 for sgd). n is train.steps + 1,
        or more when `count` lies past it (a new tensor then). On CUDA the
        corrections are stored as their f32 reciprocals: CUDA's division
        by a host scalar multiplies by its reciprocal, and the update
        multiplies by the row where the CPU divides by it, so each device
        computes what dividing by the host float computes there.

        Each correction is the f32 scalar expression `1 - torch.tensor(b)
        ** torch.tensor(float(c + 1))`, evaluated one row at a time:
        torch's vectorized power over all rows may differ from it in the
        last bit."""
        device = torch.device(device)
        have = self._tables.get(device)
        if have is not None and count < have.shape[0]:
            return have
        rows = self._rows(max(self.steps, count) + 1,
                          reciprocal=device.type == "cuda")
        have = torch.from_numpy(rows).to(device)
        self._tables[device] = have
        return have

    def _rows(self, n: int, reciprocal: bool) -> np.ndarray:
        """The first n rows of `tables` on the host."""
        rows = np.ones((n, 3), np.float32)
        rows[:, 0] = [-self.lr(c) for c in range(n)]
        if self.kind == "sgd":
            return rows
        for c in range(n):
            for j, b in ((1, ADAM_B1), (2, ADAM_B2)):
                bc = (1 - torch.tensor(b) ** torch.tensor(float(c + 1))
                      ).numpy()
                rows[c, j] = np.float32(1) / bc if reciprocal else bc
        return rows

    def lr(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule at `count`, in float32."""
        f32 = np.float32
        if self.warmup > 0 and count < self.warmup:
            c = min(max(count, 0), self.warmup)
            frac = f32(1) - f32(c) / f32(self.warmup)
            return float(f32(0.0 - self.peak) * frac + f32(self.peak))
        steps = self.decay_steps - self.warmup        # >= 1
        alpha = 0.0 if self.peak == 0.0 else self.end / self.peak
        c = f32(min(count - self.warmup, steps))
        cos = f32(0.5) * (f32(1) + f32(math.cos(f32(math.pi) * c / f32(steps))))
        return float(f32(self.peak) * (f32(1 - alpha) * cos + f32(alpha)))

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}  # noqa: E731
        if self.kind == "sgd":
            return {"count": 0, "trace": zeros()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: dict,
               params: dict[str, torch.Tensor]
               ) -> tuple[dict[str, torch.Tensor], dict]:
        """(new params, new state); the inputs are not changed.

        state["count"]: an int or a 0-d int64 tensor (the step body's
        device counter, so that no host value enters the update), whose
        row `tables` already holds (`tables(device, count)` grows them);
        the new state's count is a tensor on the params' device."""
        if self.clip > 0:     # no host sync: a select, as optax does
            norm = global_norm(grads)
            keep = norm < self.clip
            grads = {k: torch.where(keep, g, g / norm * self.clip)
                     for k, g in grads.items()}
        device = next(iter(params.values())).device
        count = torch.as_tensor(state["count"], dtype=torch.int64,
                                device=device)
        row = self.tables(device).index_select(0, count.reshape(1))[0]
        step_size = row[0]
        if self.kind == "sgd":
            trace = {k: g + SGD_MOMENTUM * state["trace"][k]
                     for k, g in grads.items()}
            new = {k: params[k] + trace[k] * step_size for k in params}
            return new, {"count": count + 1, "trace": trace}
        b1, b2 = ADAM_B1, ADAM_B2
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * g ** 2 + b2 * state["nu"][k]
              for k, g in grads.items()}
        bc1, bc2 = row[1], row[2]
        new = {}
        for k, p in params.items():
            if device.type == "cuda":            # the rows' reciprocals
                m_hat, v_hat = mu[k] * bc1, nu[k] * bc2
            else:
                m_hat, v_hat = mu[k] / bc1, nu[k] / bc2
            upd = m_hat / (torch.sqrt(v_hat) + ADAM_EPS) + self.wd * p
            new[k] = p + upd * step_size
        return new, {"count": count + 1, "mu": mu, "nu": nu}


def make_optimizer(cfg: Config) -> Optimizer:
    return Optimizer(cfg)


def compute_losses(params: dict, centers: torch.Tensor, batch: dict,
                   cfg: Config, kernels: str = "auto", extractor=None,
                   group=None, row_offset: int = 0, frame_group=None,
                   axes_group=None) -> tuple[torch.Tensor, dict]:
    """Total loss + aux for one batch of tensors on the training device:
    ranking over the in-batch score matrix, then (config 3/4) the context
    loss against the context-mixed teacher ŝ, then (config 4) the cluster
    loss of the selected regions against the k-means centers.

    kernels: "auto" and "jnp" route alike (the context mix through the
    CUDA kernels on the GPU; the cross path in plain torch). "pallas" is
    the reference's fused route: the score matrix through the fused
    cross-MIL, and, with the stop-gradient context target and both the
    context and the cluster loss on (config 4), the context loss, the
    top-region selection and the cluster loss through the fused diag
    epilogue, which never forms the dense [B,K,T,R] similarity.

    extractor: the frozen detector (`models.detector.FasterRCNNExtractor`);
    when given and the batch carries "frames" [B,T,S,S,3], the RoI features,
    boxes and region mask (its NMS survivors) are computed from the frames
    first, with no gradient.

    group (the mesh's data axis) and row_offset (the global index of the
    batch's first row): the batch is this rank's row shard. The words and
    the diagonal are all-gathered, so the score matrix is [B_loc, B_glob],
    and every loss is the global one (`parallel.sharding`): its value is
    the whole batch's on every rank, its gradient this rank's share.
    frame_group (the mesh's frame axis, when it has more than one rank):
    the batch holds this rank's frames; the context mix runs on real
    halos (`extend_for_window`), the score rows come from
    `parallel.sp.sp_cross_scores` whatever `kernels` says, as in the
    reference (so K3 is not launched), and the context and cluster losses
    are means over axes_group, the group over both axes (default:
    group)."""
    pallas = kernels == "pallas"
    axes_group = group if axes_group is None else axes_group
    if extractor is not None and "frames" in batch:
        frames = batch["frames"]
        b_, t_ = frames.shape[:2]
        det = extractor(frames.reshape((b_ * t_,) + frames.shape[2:]))
        batch = dict(batch)
        for key, out in (("feats", "feats"), ("boxes", "boxes"),
                         ("region_mask", "region_valid")):
            batch[key] = det[out].reshape(b_, t_, *det[out].shape[1:])
    lc, mc = cfg.loss, cfg.model
    feats = batch["feats"]
    fm, wm = batch["frame_mask"], batch["word_mask"]
    rm = batch.get("region_mask")
    ctx_on = lc.ctx_weight > 0 or mc.frame_pool == "context"
    ctx_window = lc.ctx_window if ctx_on else 0
    dt = COMPUTE_DTYPES[mc.dtype]
    cdt = None if dt == torch.float32 else dt

    w_emb = G.embed_words(batch["word_ids"], params["word_emb"],
                          m_sim=params.get("m_sim"))
    # the reduced-precision mode takes the JAX package's production choices
    # (its train.PROJ_FUSED, ARGMAX_2D and ASSIGN_MXU): v̂ in the compute
    # dtype with the normalize backward in it, selection by
    # argmax_regions_2d, k-means sims on compute-dtype operands
    if cdt is not None:
        v_emb = G.project_regions_fused(feats, params["w_v"], params["b_v"],
                                        cdt)
    else:
        v_emb = G.project_regions(feats, params["w_v"], params["b_v"])
    diag_route = (pallas and ctx_on
                  and lc.ctx_target == "stopgrad" and lc.ctx_weight > 0
                  and lc.cluster_weight > 0)
    # the dense s has no consumer on the diag route
    s = (None if diag_route else
         G.mask_regions(G.similarity_tensor(w_emb, v_emb, dtype=cdt), rm))

    # context mixing, shared by context pooling and the ctx loss
    u = nbr_valid = None
    if ctx_on:
        w_ = lc.ctx_window
        v_ext, fm_ext, rm_ext = G.extend_for_window(v_emb, fm, rm, w_,
                                                    frame_group=frame_group)
        u, nbr_valid = G.context_mix(v_ext, fm_ext, w_, lc.ctx_temp,
                                     dtype=cdt, rm_ext=rm_ext)

    g_learned = (G.learned_frame_logits(v_emb, fm, rm, params["attn_w"])
                 if mc.frame_pool == "learned" else None)
    gw, gwm = S.gather_words(w_emb, wm, group)
    if frame_group is not None:
        rows = sp.sp_cross_scores(gw, gwm, v_emb, fm, mc.frame_attn_temp,
                                  mc.frame_pool, frame_group, ctx_window,
                                  lc.ctx_temp, dtype=cdt, region_mask=rm,
                                  u=u, frame_logits=g_learned)
    else:
        rows = G.cross_scores(gw, gwm, v_emb, fm, mc.frame_attn_temp,
                              mc.frame_pool, ctx_window, lc.ctx_temp,
                              impl="pallas" if pallas else "jnp", dtype=cdt,
                              region_mask=rm, u=u, frame_logits=g_learned)
    b_loc, b_glob = rows.shape
    gidx = row_offset + torch.arange(b_loc, device=rows.device)
    is_diag = (torch.arange(b_glob, device=rows.device)[None, :]
               == gidx[:, None]).to(rows.dtype)
    diag = torch.sum(rows * is_diag, dim=1)
    diag_global = S.gather_diag(diag, group)
    l_rank = S.ranking_loss_rows(rows, diag_global, row_offset, lc.margin,
                                 group, norm=lc.rank_norm)
    total = l_rank
    aux = {"l_rank": l_rank,
           "score_pos": S.global_sum(torch.sum(diag) / max(b_glob, 1), group)}

    if diag_route:
        # the reference's loss algebra over the kernel's per-(k, t) partial
        # sums (nafae_tpu/train.py, the diag_out block)
        has_ctx = (nbr_valid.sum(-1) > 0).to(fm.dtype)
        ctx_kt, clu_kt, f_tk = diag_epilogue(w_emb, v_emb, u, centers, fm, rm,
                                             has_ctx, dtype=cdt)
        m3 = wm[:, :, None] * fm[:, None, :] * has_ctx[:, None, :]
        rsum = (rm.sum(-1) if rm is not None
                else torch.full(fm.shape, float(feats.shape[2]),
                                device=fm.device))
        l_ctx = S.global_mean(torch.sum(wm[:, :, None] * ctx_kt),
                              torch.sum(m3 * rsum[:, None, :]), axes_group)
        total = total + lc.ctx_weight * l_ctx
        aux["l_ctx"] = l_ctx
        any_region = ((rm.amax(-1) > 0).to(wm.dtype) if rm is not None
                      else torch.ones_like(fm))
        valid_tk = (fm * any_region)[:, :, None] * wm[:, None, :]  # [B,T,K]
        aux["sel_feats"] = f_tk                        # already stop-grad
        aux["sel_valid"] = valid_tk
        l_clu = S.global_mean(torch.sum(clu_kt * valid_tk.permute(0, 2, 1)),
                              torch.sum(valid_tk), axes_group)
        total = total + lc.cluster_weight * l_clu
        aux["l_clu"] = l_clu
        aux["loss"] = total
        return total, aux

    if ctx_on:
        shat = G.mask_regions(G.similarity_tensor(w_emb, u, dtype=cdt), rm)
        if lc.ctx_weight > 0:
            l_ctx = S.global_mean(*L.context_loss_terms(
                s, shat, wm, fm, nbr_valid, rm, target=lc.ctx_target),
                axes_group)
            total = total + lc.ctx_weight * l_ctx
            aux["l_ctx"] = l_ctx

    r_star = G.argmax_regions_2d(s) if cdt is not None else None
    f, valid = L.select_top_regions(s, v_emb, wm, fm, region_mask=rm,
                                    r_star=r_star)
    # the [B,T,K,...] layout of the JAX package's aux
    aux["sel_feats"] = f.detach().permute(0, 2, 1, 3)
    aux["sel_valid"] = valid.permute(0, 2, 1)
    if lc.cluster_weight > 0:
        num, den, _ = L.cluster_loss_terms(f, valid, centers,
                                           assign_dtype=cdt)
        l_clu = S.global_mean(num, den, axes_group)
        total = total + lc.cluster_weight * l_clu
        aux["l_clu"] = l_clu
    aux["loss"] = total
    return total, aux


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch (BatchLoader) -> tensors on `device` (a value that is
    a tensor already is moved as it is)."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v))).to(device)
            for k, v in batch.items()}


def refresh_due(cfg: Config, step: int) -> bool:
    """Whether the step at host count `step` ends with the k-means
    refresh: loss.cluster_weight > 0 and step a multiple of
    loss.kmeans_interval (so step 0 always)."""
    return cfg.loss.cluster_weight > 0 and step % cfg.loss.kmeans_interval == 0


def seed_due(cfg: Config, step: int) -> bool:
    """Whether the step at `step` seeds the centers by k-means++ first
    (loss.kmeans_init=plusplus, step 0)."""
    return (cfg.loss.cluster_weight > 0 and cfg.loss.kmeans_init == "plusplus"
            and step == 0)


def mesh_groups(cfg: Config, mesh) -> tuple:
    """(data group, frame group or None, group over both axes, this
    rank's data rank) of `mesh`, or (None, None, None, 0) without one."""
    if mesh is None:
        return None, None, None, 0
    from nafae_torch.parallel.mesh import axes_group, frame_size
    group = mesh.get_group(cfg.mesh.data_axis_name)
    frame_group = (mesh.get_group(cfg.mesh.frame_axis_name)
                   if frame_size(mesh) > 1 else None)
    return group, frame_group, axes_group(mesh), \
        torch.distributed.get_rank(group)


def step_body(cfg: Config, tx: Optimizer, state: TrainState, batch: dict,
              step_t: torch.Tensor, count_t: torch.Tensor, *, refresh: bool,
              seed: bool = False, extractor=None, groups=(None, None, None, 0),
              debug_nans: bool = False) -> tuple[dict, dict, torch.Tensor,
                                                 dict]:
    """The whole optimizer step as a function of tensors, the same on
    every path (`train_step`, and `build_train_fn` eager or captured in a
    CUDA graph): forward and losses, their gradient, the all-reduce over
    the mesh, the update, the bank write and the k-means refresh.

    step_t and count_t: 0-d int64 tensors on the state's device holding
    state.step and the optimizer's count; the update reads its row of
    `tx.tables` by count_t and the bank writes slot step_t % W, so no host
    value of the step enters. refresh and seed (`refresh_due`,
    `seed_due`): the host's choices for this step. groups: `mesh_groups`.

    Returns (params, optimizer tensors without the count, centers,
    metrics), new tensors but the bank, which is written in place (a
    centers tensor that did not change is the state's own)."""
    group, frame_group, axes, data_rank = groups
    row_offset = data_rank * batch["word_ids"].shape[0]
    names = sorted(state.params)
    params = {k: state.params[k].detach().requires_grad_() for k in names}
    # the losses and their gradient at model.matmul_precision, as the
    # reference's compute_losses runs under G.matmul_precision; k-means and
    # the update below stay exact
    with matmul_precision(cfg.model.matmul_precision), torch.enable_grad():
        total, aux = compute_losses(params, state.centers, batch, cfg,
                                    cfg.train.resolved_kernels(), extractor,
                                    group, row_offset, frame_group, axes)
        if debug_nans:
            _check_finite({k: v for k, v in aux.items()
                           if not k.startswith("sel_")}, "loss term")
        grads = torch.autograd.grad(total, [params[k] for k in names],
                                    allow_unused=True)
    grads = {k: torch.zeros_like(params[k]) if g is None else g
             for k, g in zip(names, grads)}
    if axes is not None:
        flat = S.all_reduce(torch.cat([grads[k].reshape(-1) for k in names]),
                            axes)
        grads = {k: g.view(grads[k].shape) for k, g in zip(
            names, flat.split([grads[k].numel() for k in names]))}
    if debug_nans:
        _check_finite(grads, "gradient of parameter")
    new_params, opt = tx.update(grads, {**state.opt_state, "count": count_t},
                                state.params)
    opt.pop("count")

    centers, bank, bank_valid = state.centers, state.bank, state.bank_valid
    sel_f, sel_v = aux.pop("sel_feats"), aux.pop("sel_valid")
    lc = cfg.loss
    if lc.cluster_weight > 0:
        with torch.no_grad():
            e = cfg.model.embed_dim
            if lc.kmeans_source == "bank" and bank is not None:
                bank_write(bank, bank_valid, step_t, sel_f, sel_v)
                f_nd, v_nd, bdim = bank, bank_valid, 1
            else:
                f_nd, v_nd, bdim = sel_f, sel_v, 0
            f, valid = f_nd.reshape(-1, e), v_nd.reshape(-1)
            if seed:
                gathers = [(g, d) for g, d in ((group, bdim),
                                               (frame_group, bdim + 1))
                           if g is not None]
                centers = kmeans_plusplus_init(
                    f_nd, v_nd, lc.num_clusters,
                    generator=torch.Generator().manual_seed(cfg.train.seed),
                    gathers=gathers)
            if refresh:
                dt = COMPUTE_DTYPES[cfg.model.dtype]
                centers = kmeans_lloyd(
                    f, valid, centers, lc.kmeans_iters, lc.kmeans_ema,
                    assign_dtype=None if dt == torch.float32 else dt,
                    group=axes)
    metrics = {k: v.detach() for k, v in aux.items()}
    metrics["grad_norm"] = global_norm(grads).detach()
    return new_params, opt, centers, metrics


def train_step(state: TrainState, batch: dict, cfg: Config,
               tx: Optimizer | None = None, extractor=None, mesh=None,
               debug_nans: bool = False
               ) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One optimizer step on a batch of tensors on state's device
    (`step_body`, eagerly); returns (new state, metrics as 0-d tensors:
    l_rank, score_pos, [l_ctx], [l_clu], loss, grad_norm — the norm before
    clipping). The state passed in keeps its params, optimizer tensors and
    centers; the bank, if any, is written in place.

    The k-means refresh runs after the update, on this step's selections
    (or the bank), when the step count before the update is a multiple of
    loss.kmeans_interval (so at step 0 always); with
    loss.kmeans_init=plusplus, step 0 first seeds the centers from the
    same rows by k-means++ (noise from a generator seeded with
    train.seed). extractor: the frozen detector of a batch of frames (see
    compute_losses).

    mesh (`parallel.make_mesh`): the batch is this rank's part of the
    global batch (`parallel.multihost.local_batch`: data rank d holds rows
    [d·B_loc, (d+1)·B_loc) and, under frame parallelism, frame rank f the
    frames [f·T_loc, (f+1)·T_loc)) and the bank, if any, its [W, B_loc,
    T_loc, ...] shard. Each rank backpropagates its share of the global
    losses, one all-reduce (SUM) over both axes of every parameter
    gradient, flattened in sorted key order, makes the global gradient,
    and every rank applies the same update; the k-means refresh sums over
    both axes and the seeding gathers along both. The metrics are the
    global ones.

    debug_nans: raise FloatingPointError naming the first loss term that
    is not finite (before the backward) or the first parameter whose
    gradient is not (after the reduction). Each check waits for the
    device."""
    tx = tx or make_optimizer(cfg)
    count = state.opt_state["count"]
    dev = state.device
    tx.tables(dev, count)
    step_t = torch.full((), state.step, dtype=torch.int64, device=dev)
    count_t = torch.full((), count, dtype=torch.int64, device=dev)
    params, opt, centers, metrics = step_body(
        cfg, tx, state, batch, step_t, count_t,
        refresh=refresh_due(cfg, state.step), seed=seed_due(cfg, state.step),
        extractor=extractor, groups=mesh_groups(cfg, mesh),
        debug_nans=debug_nans)
    return replace(state, step=state.step + 1, params=params,
                   opt_state={"count": count + 1, **opt},
                   centers=centers), metrics


# train.kernels=pallas at model.dtype=float16 on the card: K3, K4f and K4b
# have no f16 kernels yet (the context mix's have)
F16_FUSED_REFUSAL = ("train.kernels=pallas at model.dtype=float16 is not "
                     "ported to the card yet: ROADMAP Queue 1 item 16 (K3, "
                     "K4f and K4b at f16); use train.kernels=auto, or "
                     "bfloat16")


def unported_reason(cfg: Config, device) -> str | None:
    """Why the port cannot run these settings on this device yet (the
    ROADMAP item that will), or None. `fit` and `build_train_fn` raise
    NotImplementedError with it before any step; nothing falls back to
    another dtype, route or device. On the CPU the fused route runs its
    plain versions at f16."""
    from nafae_torch.models.detector.faster_rcnn import F16_REFUSAL
    if cfg.data.from_videos and cfg.detector.dtype == "float16":
        return F16_REFUSAL
    if (torch.device(device).type == "cuda" and cfg.model.dtype == "float16"
            and cfg.train.resolved_kernels() == "pallas"):
        return F16_FUSED_REFUSAL
    return None


def eager_reason(cfg: Config, device, mesh=None,
                 debug_nans: bool = False) -> str | None:
    """Why `build_train_fn` runs the step eagerly on these settings, or
    None when it captures the step in CUDA graphs (config 5's too, the
    frozen detector inside). Decided from the config and the device
    before the first step; an error in a capture or a replay raises, it
    never turns a run eager."""
    device = torch.device(device)
    if device.type != "cuda":
        return f"device {device.type}: CUDA graphs need a CUDA device"
    if debug_nans:
        return ("debug_nans: the step checks its losses and gradients on "
                "the host")
    if mesh is not None:
        from nafae_torch.parallel.mesh import frame_size
        if frame_size(mesh) > 1:
            return ("frame parallelism (mesh.frame_axis > 1): the halo "
                    "exchange's sends and receives")
        backend = torch.distributed.get_backend(
            mesh.get_group(cfg.mesh.data_axis_name))
        if backend != "nccl":
            return (f"a {backend} mesh: its collectives stage CUDA tensors "
                    "through host memory")
    return None


class TrainFn:
    """The step program of `build_train_fn`: fn(state, batch) -> (state,
    metrics).

    The state's params, optimizer tensors, centers, bank and bank_valid
    are the step's buffers: every step updates them in place (`copy_`),
    so the state returned holds the same tensors, its host step and count
    one further. Two 0-d int64 device counters hold the step and the
    count; the step body reads the optimizer's row and the bank's slot by
    them and advances them. The metrics are fixed 0-d buffers, the same
    dict every call: read them before the next call overwrites them.

    batch: a dict of host arrays or tensors (the streaming path), copied
    into a static buffer of its shape on the device by the pageable copy
    `batch_to_device` makes (eager: by `batch_to_device` itself); with
    `cache` (the device-resident dataset), an index tensor [B], copied
    into a static index buffer, the batch gathered from the cache by
    `index_select` inside the step.

    Captured (`eager_reason` None): one CUDA graph for each batch shape
    and refresh or not (`refresh_due`), all in one memory pool, captured
    at a shape's first use, both together when the run refreshes now and
    then: WARMUP_STEPS eager steps of each on clones of the state on a
    side stream (where a kernel's first use builds it and the detector
    makes its anchors), then the captures, so that no eager step runs
    beside the pool (config 5's step takes most of the card). They are
    captured again when the state's buffers or the optimizer's tables are
    new (a restored checkpoint). A k-means++ seeding step (`seed_due`)
    runs eagerly: it draws its noise on the host. Eager: the same body and
    commit, run op by op. `stats` counts graphs, replays, eager steps,
    warm-up steps and their launches by kernel (set apart from the kernel
    modules' counts, which count the steps), capture seconds and the
    pool's reserved bytes."""

    def __init__(self, cfg: Config, tx: Optimizer, device, mesh=None,
                 extractor=None, debug_nans: bool = False, cache=None):
        self.cfg, self.tx, self.device = cfg, tx, torch.device(device)
        reason = unported_reason(cfg, self.device)
        if reason is not None:
            raise NotImplementedError(reason)
        self.extractor, self.debug_nans, self.cache = (extractor, debug_nans,
                                                       cache)
        self.eager_reason = eager_reason(cfg, self.device, mesh, debug_nans)
        self.groups = mesh_groups(cfg, mesh)
        self.stats = {"graphs": 0, "replays": 0, "eager_steps": 0,
                      "warmup_steps": 0, "warmup_launches": {},
                      "capture_s": 0.0, "pool_bytes": 0}
        self._bound = None          # the buffers the counters belong to
        self._counters = None       # 0-d int64: the step, the count
        self._at = None             # the host (step, count) they hold
        self._graphs: dict = {}
        self._inputs: dict = {}
        self._metrics: dict | None = None
        self._pool = self._stream = None

    @property
    def graphed(self) -> bool:
        return self.eager_reason is None

    def __call__(self, state: TrainState, batch
                 ) -> tuple[TrainState, dict[str, torch.Tensor]]:
        count = state.opt_state["count"]
        self._bind(state, self.tx.tables(self.device, count))
        key, inputs = self._stage(batch)
        refresh = refresh_due(self.cfg, state.step)
        seed = seed_due(self.cfg, state.step)
        if self.graphed and not seed:
            graph = self._graphs.get((key, refresh))
            if graph is None:
                lc = self.cfg.loss
                both = lc.cluster_weight > 0 and lc.kmeans_interval > 1
                refreshes = (refresh, not refresh) if both else (refresh,)
                self._graphs.update(
                    ((key, r), g) for r, g in
                    zip(refreshes, self._capture(state, inputs, refreshes)))
                graph = self._graphs[key, refresh]
            graph.replay()
            self.stats["replays"] += 1
        else:
            self._run(state, inputs, refresh, seed, self._counters)
            self.stats["eager_steps"] += 1
        self._at = (state.step + 1, count + 1)
        return replace(state, step=state.step + 1,
                       opt_state={**state.opt_state, "count": count + 1}), \
            self._metrics

    @staticmethod
    def _buffers(state: TrainState) -> list[torch.Tensor]:
        opt = [d[k] for _, d in sorted(state.opt_state.items())
               if isinstance(d, dict) for k in sorted(d)]
        return [*(state.params[k] for k in sorted(state.params)), *opt,
                state.centers,
                *(t for t in (state.bank, state.bank_valid) if t is not None)]

    def _bind(self, state: TrainState, tables: torch.Tensor) -> None:
        """Points the counters at the state's host step and count, and
        drops the graphs when the buffers are not those they captured."""
        at = (state.step, state.opt_state["count"])
        bound = (tables.data_ptr(), *((t.data_ptr(), t.shape)
                                      for t in self._buffers(state)))
        if bound != self._bound:
            self._graphs.clear()
            self._bound = bound
            self._counters = tuple(
                torch.full((), n, dtype=torch.int64, device=self.device)
                for n in at)
        elif at != self._at:
            for t, n in zip(self._counters, at):
                t.fill_(n)
        self._at = at

    def _stage(self, batch) -> tuple[tuple, dict[str, torch.Tensor]]:
        """Captured: copies the batch (or the index batch) into its static
        buffers and returns (its shape key, the buffers). Eager: the batch
        on the device (`batch_to_device`), and no key."""
        if self.cache is not None:
            batch = {"index": batch}
        if not self.graphed:
            return None, batch_to_device(batch, self.device)
        host = {k: torch.as_tensor(v if isinstance(v, torch.Tensor)
                                   else np.asarray(v))
                for k, v in batch.items()}
        key = tuple((k, tuple(t.shape), t.dtype) for k, t in host.items())
        bufs = self._inputs.get(key)
        if bufs is None:
            bufs = self._inputs[key] = {
                k: torch.empty(t.shape, dtype=t.dtype, device=self.device)
                for k, t in host.items()}
        for k, t in host.items():
            bufs[k].copy_(t)
        return key, bufs

    def _run(self, state: TrainState, inputs: dict, refresh: bool,
             seed: bool, counters: tuple) -> None:
        """step_body on the staged inputs, then its commit into the
        state's buffers, the counters and the metric buffers."""
        batch = inputs
        if self.cache is not None:
            batch = {k: v.index_select(0, inputs["index"])
                     for k, v in self.cache.items()}
        step_t, count_t = counters
        params, opt, centers, metrics = step_body(
            self.cfg, self.tx, state, batch, step_t, count_t,
            refresh=refresh, seed=seed, extractor=self.extractor,
            groups=self.groups, debug_nans=self.debug_nans)
        with torch.no_grad():
            for k, v in params.items():
                state.params[k].copy_(v)
            for name, d in opt.items():
                for k, v in d.items():
                    state.opt_state[name][k].copy_(v)
            if centers is not state.centers:
                state.centers.copy_(centers)
            step_t.add_(1)
            count_t.add_(1)
            if self._metrics is None:       # never inside a capture: a
                self._metrics = {           # warm-up or an eager step runs
                    k: torch.empty_like(v) for k, v in metrics.items()}
            for k, v in metrics.items():
                self._metrics[k].copy_(v)

    def _capture(self, state: TrainState, inputs: dict,
                 refreshes: tuple[bool, ...]) -> list[CG.CapturedStep]:
        """WARMUP_STEPS eager steps for each refresh of `refreshes` on
        clones of the state, then a graph of each, in that order."""
        t0 = time.perf_counter()
        dev = self.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = CG.capture_stream(dev)
        main = torch.cuda.current_stream(dev)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            with CG.set_apart(self.stats["warmup_launches"]):
                shadow = replace(
                    state,
                    params={k: v.clone() for k, v in state.params.items()},
                    opt_state={k: ({n: t.clone() for n, t in v.items()}
                                   if isinstance(v, dict) else v)
                               for k, v in state.opt_state.items()},
                    centers=state.centers.clone(),
                    bank=None if state.bank is None else state.bank.clone(),
                    bank_valid=(None if state.bank_valid is None
                                else state.bank_valid.clone()))
                for refresh in refreshes:
                    # from count 0 each time: the warm-up reads the
                    # optimizer's first rows, which every table holds
                    counters = tuple(torch.zeros_like(t)
                                     for t in self._counters)
                    for _ in range(WARMUP_STEPS):
                        self._run(shadow, inputs, refresh, False, counters)
                        self.stats["warmup_steps"] += 1
                del shadow, counters
            steps = []
            for refresh in refreshes:
                step, grew = CG.record(
                    functools.partial(self._run, state, inputs, refresh,
                                      False, self._counters),
                    dev, self._pool, self._stream)
                steps.append(step)
                self.stats["pool_bytes"] += grew
                self.stats["graphs"] += 1
        main.wait_stream(self._stream)
        self.stats["capture_s"] += time.perf_counter() - t0
        return steps


def build_train_fn(cfg: Config, tx: Optimizer, device, mesh=None,
                   extractor=None, debug_nans: bool = False,
                   cache: dict[str, torch.Tensor] | None = None) -> TrainFn:
    """The training step as one device program (the reference's
    `build_train_fn`, whose jax.jit compiles the step): fn(state, batch)
    -> (state, metrics), a `TrainFn`, updating the state's tensors in
    place.

    On cuda the step is captured in CUDA graphs and replayed, with no
    mesh or on an NCCL mesh without a frame axis (the gradient all-reduce
    and the losses' and k-means' collectives inside the graph). It runs
    the same body eagerly, op by op, on the CPU; with debug_nans (host
    checks every step); on a gloo mesh (collectives staged through host
    memory); and with mesh.frame_axis > 1 (the halo exchange).
    `eager_reason` names which. With an extractor (config 5) the frozen
    detector is captured inside the step, as in the reference's one
    program (decode -> detector -> losses). `TrainFn` says what a batch
    is (cache: the device-resident dataset, batches by index)."""
    return TrainFn(cfg, tx, device, mesh, extractor, debug_nans, cache)


def _check_finite(tensors: dict[str, torch.Tensor], what: str) -> None:
    for k, v in tensors.items():
        if not bool(torch.isfinite(v).all()):
            raise FloatingPointError(f"{what} {k!r} is not finite "
                                     "(--debug-nans)")


def _word_vectors(cfg: Config, device: torch.device) -> torch.Tensor:
    """word_emb [V,E] from model.word_vectors, for the data config's
    vocab, which must have model.vocab_size classes."""
    from nafae_torch.data.vocab import vocab_from_config
    from nafae_torch.models.grounding import load_word_vectors

    vocab = vocab_from_config(cfg.data)
    if len(vocab) != cfg.model.vocab_size:
        # a silent mismatch would crash in the optimizer (its state is
        # sized at vocab_size) or give every word id the wrong vector
        raise ValueError(
            f"model.word_vectors: the vocab has {len(vocab)} classes "
            f"but model.vocab_size={cfg.model.vocab_size}; point "
            "data.classes_file at the class list the features were "
            "extracted with (and keep vocab_size in sync)")
    vecs, _ = load_word_vectors(cfg.model.word_vectors, vocab,
                                cfg.model.embed_dim)
    # f32 as the reference's jnp.asarray gives it (numpy may hand back f64)
    return torch.from_numpy(np.asarray(vecs, np.float32)).to(device)


def fit(cfg: Config, device: str | torch.device | None = None,
        log_fn=None, extractor=None, eval_fn=None, mesh=None,
        debug_nans: bool = False) -> tuple[TrainState, dict]:
    """Run cfg.train.steps steps from the newest checkpoint in
    train.ckpt_dir (or from scratch); returns the final state and the last
    metrics. Logs JSONL to train.ckpt_dir/metrics.jsonl every log_every
    steps (and calls log_fn; also into a TensorBoard event file in
    train.tensorboard_dir when set), checkpoints every ckpt_every steps
    and at the end, and calls eval_fn(state) every eval_every steps.

    With data.from_videos, the dataset is the annotations' segments
    decoded to frames and the step runs `extractor`, by default the
    detector cfg.detector describes (`init_detector`: random weights from
    train.seed, then detector.weights when set; the reference's config-5
    inline path, `nafae_tpu/train.py` fit). model.word_vectors replaces the
    initial word_emb (before a checkpoint is restored).

    mesh (`parallel.make_mesh`): data and frame parallel on the mesh's
    device (the `device` argument, if given, must be of its type). Every
    rank builds the same loader from the same seed and trains on its part
    of each global batch, sliced by `parallel.multihost.global_batch_spec`
    (data rank d of D: rows [d·B/D, (d+1)·B/D), so data.batch_size must
    divide by D; frame rank f of F: frames [f·T/F, (f+1)·T/F)), so the
    row order and the resume position are the single device's. Only rank
    0 of the world logs, calls log_fn and eval_fn and writes checkpoints;
    a checkpoint holds the single-device layout (the bank's shards
    gathered along both axes), so a run resumes with or without a mesh.
    frames_per_sec counts the global batch. The returned state holds this
    rank's bank shard. debug_nans: autograd's anomaly mode for the run,
    and the step's checks of every step (it then runs eagerly).

    The steps run through `build_train_fn` (CUDA graphs on the card, see
    `eager_reason`), which updates the state's tensors in place: the
    state returned holds the tensors the run started from, and the
    metrics are the program's buffers."""
    from nafae_torch.data.youcook2 import SegmentDataset
    from nafae_torch.parallel.multihost import global_batch_spec, local_batch
    from nafae_torch.utils.checkpoint import CheckpointManager
    from nafae_torch.utils.metrics_log import MetricsLogger

    lead = True
    if mesh is not None:
        from nafae_torch.parallel.mesh import axes_group, mesh_device
        world = int(mesh.mesh.shape[0])
        if cfg.data.batch_size % world:
            raise ValueError(
                f"data.batch_size={cfg.data.batch_size} does not divide "
                f"over the mesh's {world} ranks")
        if device is not None and torch.device(device).type != \
                mesh.device_type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device_type}")
        device = mesh_device(mesh)
        lead = torch.distributed.get_rank() == 0
    else:
        device = resolve_device(device)
    reason = unported_reason(cfg, device)
    if reason is not None:
        raise NotImplementedError(reason)
    if cfg.data.from_videos:
        from nafae_torch.data.video_dataset import VideoSegmentDataset
        from nafae_torch.data.vocab import vocab_from_config
        from nafae_torch.models.detector.faster_rcnn import init_detector
        if not cfg.data.annotations:
            raise ValueError("data.from_videos needs data.annotations "
                             "(segments.jsonl)")
        if cfg.train.device_cache:
            raise ValueError("device_cache caches features, not raw frames; "
                             "extract first or disable one of the two")
        ds = VideoSegmentDataset(cfg.data.annotations, cfg.data.max_frames,
                                 cfg.detector.image_size, cfg.data.max_words,
                                 frame_rate=cfg.detector.frame_rate,
                                 vocab=vocab_from_config(cfg.data))
        if extractor is None:
            extractor = init_detector(
                cfg.detector, torch.Generator().manual_seed(cfg.train.seed),
                device=device)
    else:
        ds = SegmentDataset(cfg.data.root, cfg.data.split,
                            cfg.data.max_frames, cfg.data.num_regions,
                            cfg.data.feat_dim, cfg.data.max_words,
                            frame_buckets=tuple(cfg.data.frame_buckets),
                            transfer_dtype=cfg.data.transfer_dtype)
        if cfg.train.device_cache and len(ds.frame_buckets) > 1:
            raise ValueError("device_cache requires a single frame bucket")
    state = TrainState.create(cfg, device=device)
    if cfg.model.word_vectors:
        state = replace(state, params={**state.params,
                                       "word_emb": _word_vectors(cfg, device)})
    ckpt = CheckpointManager(cfg.train.ckpt_dir, keep=cfg.train.keep_ckpts)
    restored = ckpt.restore_latest(state)
    if restored is not None:
        state = restored
        if lead:
            _, path, fmt = ckpt.latest()
            print(f"resumed at step {state.step} from the {fmt} checkpoint "
                  f"{path}", file=sys.stderr, flush=True)
    if state.bank is not None and mesh is not None:
        state = replace(state, bank=_bank_shard(state.bank, mesh),
                        bank_valid=_bank_shard(state.bank_valid, mesh))
    logger = (MetricsLogger(cfg.train.ckpt_dir,
                            tensorboard_dir=cfg.train.tensorboard_dir)
              if lead else None)
    tx = make_optimizer(cfg)

    def save(state):
        if mesh is not None:
            if state.bank is not None:
                state = replace(state, bank=_bank_whole(state.bank, mesh),
                                bank_valid=_bank_whole(state.bank_valid,
                                                       mesh))
            if lead:
                ckpt.save(state)
            torch.distributed.barrier(axes_group(mesh))
        else:
            ckpt.save(state)

    if cfg.train.device_cache:
        return fit_device_cached(cfg, state, ds, tx, device, save, logger,
                                 log_fn=log_fn, eval_fn=eval_fn, mesh=mesh,
                                 debug_nans=debug_nans)
    # built after the device_cache return: the cached path never reads the
    # streaming loader (a native packer would build its cache for nothing)
    from nafae_torch.data.grain_loader import make_loader
    loader = make_loader(cfg.data, ds, seed=cfg.train.seed,
                         pipeline=cfg.data.pipeline)
    spec = global_batch_spec(cfg, mesh, with_frames=cfg.data.from_videos)

    # resume the loader at its exact position (epoch + offset from the
    # step). Exact only when batches apply in yield order: spc == 1, or a
    # single bucket. With several buckets and spc > 1 the grouping by
    # bucket reorders the steps, so a resume restarts at the epoch boundary
    # (it never skips a batch that was not applied), as the reference does.
    spc = max(1, cfg.train.steps_per_call)
    start_step = state.step
    eb = loader.batches_per_epoch()
    exact = spc == 1 or len(getattr(ds, "frame_buckets", ())) <= 1
    start_epoch = start_step // eb if eb else 0
    skip = (start_step % eb if eb else 0) if exact else 0
    target = cfg.train.steps
    applied = start_step
    frames_applied = frames_logged = 0
    last_fired = dict.fromkeys(("log", "ckpt", "eval"), start_step)
    t0 = time.perf_counter()
    metrics: dict = {}

    def due(kind, every):
        return every > 0 and applied - last_fired[kind] >= every

    step = build_train_fn(cfg, tx, device, mesh, extractor, debug_nans)

    def apply(batches):
        """A group of spc batches, or one batch: a step each, with no host
        read between them."""
        nonlocal state, metrics, applied, frames_applied
        for b in batches:
            state, metrics = step(state, local_batch(b, spec, mesh))
        applied += len(batches)
        frames_applied += sum(int(np.prod(b["frame_mask"].shape))
                              for b in batches)

    def emit():
        nonlocal t0, frames_logged
        if due("log", cfg.train.log_every):
            last_fired["log"] = applied
            if lead:
                m = {k: float(v) for k, v in metrics.items()}
                m["frames_per_sec"] = ((frames_applied - frames_logged)
                                       / max(time.perf_counter() - t0, 1e-9))
                m["step"] = applied
                logger.log(m)
                if log_fn:
                    log_fn(m)
            t0, frames_logged = time.perf_counter(), frames_applied
        if due("ckpt", cfg.train.ckpt_every):
            last_fired["ckpt"] = applied
            save(state)
        if eval_fn and due("eval", cfg.train.eval_every):
            last_fired["eval"] = applied
            if lead:
                eval_fn(state)

    # enough yields to cover the batches a bucket leaves over; the loop
    # ends on `applied >= target`, not on the budget
    budget = (target - applied) * 2 + spc * 16
    pending: dict[int, list] = {}
    with torch.autograd.set_detect_anomaly(debug_nans):
        for _, batch in loader.steps(budget, start_epoch=start_epoch,
                                     skip=skip):
            if applied >= target:
                break     # e.g. re-running an already-completed checkpoint
            if spc > 1:
                # a group is spc batches of one frame bucket, applied one
                # after the other with no host read between them
                key = batch["frame_mask"].shape[1]
                pending.setdefault(key, []).append(batch)
                if target - applied < spc:
                    # fewer steps left than a group: stop collecting once
                    # the tail below has enough batches
                    if sum(len(g) for g in pending.values()) >= \
                            target - applied:
                        break
                    continue
                if len(pending[key]) < spc:
                    continue
                apply(pending.pop(key))
            else:
                apply([batch])
            emit()
            if applied >= target:
                break
        # the tail: fewer than spc steps left, or a dataset too small to
        # fill a group; the pending batches one by one, in bucket order
        for b in [b for grp in pending.values() for b in grp]:
            if applied >= target:
                break
            apply([b])
            emit()
    save(state)
    return state, metrics


def build_cache(ds, device: torch.device, mesh=None
                ) -> dict[str, torch.Tensor]:
    """The dataset on the device for train.device_cache: one pass ds[i]
    over every segment, each key but boxes (which the step never reads)
    stacked along a new dim 0 and copied once, in the dataset's dtypes
    (feats in its transfer dtype). Under a mesh, this rank's frame shard of
    feats, region_mask and frame_mask (frames [f·T/F, (f+1)·T/F)) and
    every other key whole."""
    samples = [ds[i] for i in range(len(ds))]
    host = {k: np.stack([s[k] for s in samples])
            for k in samples[0] if k != "boxes"}
    del samples
    if mesh is not None:
        f, nf = mesh.get_coordinate()[1], int(mesh.mesh.shape[1])
        for k in ("feats", "region_mask", "frame_mask"):
            host[k] = S.shard_rows(host[k], f, nf, 1)
    return {k: torch.from_numpy(np.ascontiguousarray(host.pop(k))).to(device)
            for k in list(host)}


def fit_device_cached(cfg: Config, state: TrainState, ds, tx: Optimizer,
                      device: torch.device, save, logger, log_fn=None,
                      eval_fn=None, mesh=None, debug_nans: bool = False
                      ) -> tuple[TrainState, dict]:
    """The training loop with the dataset resident on the device
    (train.device_cache; the reference's `fit_device_cached`).

    The dataset is uploaded once (`build_cache`); each step's batch is
    gathered on the device by index (`index_select` along dim 0, inside
    the step `build_train_fn` captures, from a static index buffer). The
    index stream is the reference's: a RandomState seeded with train.seed
    draws one permutation of the segments per epoch, batches run across
    epoch boundaries, and a resumed run skips the start step's positions.
    A call takes steps_per_call steps (the last one the steps left) with
    no host read between them (the reference's `make_multi_step`: here
    that many replays of the captured step), and its metrics are its last
    step's;
    logging, eval and checkpoints fire on the calls where
    step % max(every, spc) < spc.

    mesh: each rank holds its frame shard of feats, region_mask and
    frame_mask (an F-way frame axis divides its cache by F) and every
    other key whole, and gathers its data rank's rows of each global index
    batch; the step is the DP/SP step of `step_body`, so the trajectory is
    the single device's. `save` writes the single-device checkpoint (rank 0)."""
    from nafae_torch.parallel.multihost import process_shard

    n = len(ds)
    bsz = cfg.data.batch_size
    cache = build_cache(ds, device, mesh)
    rows = range(bsz)
    lead = mesh is None or torch.distributed.get_rank() == 0
    nf = 1
    if mesh is not None:
        (d, _), (nd, nf) = mesh.get_coordinate(), mesh.mesh.shape
        rows = process_shard(bsz, d, int(nd))
    # frames of a global batch, from the cache's own T: a single bucket
    # may be smaller than data.max_frames
    frames_per_batch = bsz * int(cache["frame_mask"].shape[1]) * int(nf)
    spc = max(1, cfg.train.steps_per_call)
    start_step = state.step
    total = cfg.train.steps - start_step
    rng = np.random.RandomState(cfg.train.seed)
    # resume: skip the positions the steps before start_step consumed
    order: list = []
    consumed = start_step * bsz
    while consumed > 0:
        ep = np.arange(n)
        rng.shuffle(ep)
        if consumed >= n:
            consumed -= n
        else:
            order = ep[consumed:].tolist()
            consumed = 0
    done = done_logged = 0
    gstep = start_step
    t0 = t_start = time.perf_counter()
    metrics: dict = {}

    def due(every):
        return every > 0 and gstep % max(every, spc) < spc

    step = build_train_fn(cfg, tx, device, mesh, debug_nans=debug_nans,
                          cache=cache)

    with torch.autograd.set_detect_anomaly(debug_nans):
        while done < total:
            take = min(spc, total - done)
            while len(order) < take * bsz:
                ep = np.arange(n)
                rng.shuffle(ep)
                order.extend(ep.tolist())
            idxs = np.asarray(order[:take * bsz], np.int64).reshape(take,
                                                                    bsz)
            order = order[take * bsz:]
            idxs = torch.from_numpy(idxs[:, rows.start:rows.stop].copy())
            if device.type == "cuda":     # one copy a call, no host wait
                idxs = idxs.pin_memory().to(device, non_blocking=True)
            for idx in idxs:
                state, metrics = step(state, idx)
            done += take
            gstep = start_step + done
            if due(cfg.train.log_every):
                now = time.perf_counter()
                if lead:
                    m = {k: float(v) for k, v in metrics.items()}
                    # windowed since the last log, and since the start
                    # (which includes the upload)
                    m["frames_per_sec"] = (frames_per_batch
                                           * (done - done_logged)
                                           / max(now - t0, 1e-9))
                    m["frames_per_sec_avg"] = (frames_per_batch * done
                                               / max(now - t_start, 1e-9))
                    m["step"] = gstep
                    logger.log(m)
                    if log_fn:
                        log_fn(m)
                t0, done_logged = now, done
            if eval_fn and due(cfg.train.eval_every) and lead:
                eval_fn(state)
            if due(cfg.train.ckpt_every):
                save(state)
    save(state)
    return state, metrics


def _bank_shard(bank: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's shard of a whole bank [W, B, T, ...]: its data rank's
    rows (dim 1) and frame rank's frames (dim 2)."""
    (d, f), (nd, nf) = mesh.get_coordinate(), mesh.mesh.shape
    return S.shard_rows(S.shard_rows(bank, d, int(nd), 1), f, int(nf),
                        2).clone()


def _bank_whole(bank: torch.Tensor, mesh) -> torch.Tensor:
    """The whole bank from every rank's shard: gathered along the data
    axis (dim 1), then the frame axis (dim 2)."""
    from nafae_torch.parallel.mesh import frame_size

    names = mesh.mesh_dim_names
    bank = S.all_gather(bank, mesh.get_group(names[0]), dim=1)
    if frame_size(mesh) > 1:
        bank = S.all_gather(bank, mesh.get_group(names[1]), dim=2)
    return bank


def main(argv=None) -> int:
    import argparse

    from nafae_torch.config import load_config

    p = argparse.ArgumentParser("nafae_torch.train")
    p.add_argument("--preset", default="config2")
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--override", nargs="*", action="extend", default=None)
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--mesh", action="store_true",
                   help="data parallel (and frame parallel with "
                        "mesh.frame_axis > 1) over the ranks of the job "
                        "(torchrun --nproc_per_node N): NCCL on the cards, "
                        "gloo with --device cpu; a world of one without "
                        "torchrun")
    p.add_argument("--multihost", action="store_true",
                   help="one process group across hosts (torchrun --nnodes "
                        "N, or a SLURM / Open MPI job exporting MASTER_ADDR"
                        "/MASTER_PORT), then the mesh over every rank of "
                        "it; implies --mesh. data.batch_size stays the "
                        "GLOBAL batch")
    p.add_argument("--debug-nans", action="store_true",
                   help="autograd's anomaly mode, and a check that every "
                        "step's losses and gradients are finite "
                        "(FloatingPointError); syncs the host every step")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the whole run "
                        "into DIR (Chrome trace JSON)")
    args = p.parse_args(argv)
    cfg = load_config(args.config, args.preset, args.override or [])
    mesh = None
    if args.multihost:
        from nafae_torch.parallel.multihost import init_multihost
        init_multihost(device=args.device)
    if args.mesh or args.multihost:
        from nafae_torch.parallel.mesh import make_mesh
        mesh = make_mesh(cfg.mesh.data_axis, cfg.mesh.frame_axis,
                         cfg.mesh.data_axis_name, cfg.mesh.frame_axis_name,
                         device=args.device)
    lead = mesh is None or torch.distributed.get_rank() == 0

    def log_fn(m):
        print(" ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in sorted(m.items())), flush=True)

    def eval_fn(state):
        if not os.path.exists(os.path.join(cfg.data.root, "val",
                                           "index.jsonl")):
            return
        from nafae_torch.evaluate import evaluate_config
        r = evaluate_config(cfg, params=state.params, device=state.device)
        r.pop("per_class_acc", None)
        r["step"] = int(state.step)
        print("eval " + " ".join(f"{k}={v}" for k, v in sorted(r.items())),
              flush=True)

    def run():
        fit(cfg, device=None if mesh is not None else args.device,
            log_fn=log_fn, eval_fn=eval_fn, mesh=mesh,
            debug_nans=args.debug_nans)

    try:
        if args.profile:
            from nafae_torch.utils.profiling import trace
            with trace(args.profile):
                run()
            if lead:
                print(f"profile trace written to {args.profile}", flush=True)
        else:
            run()
    finally:
        if mesh is not None:
            from nafae_torch.parallel.mesh import shutdown
            shutdown()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
