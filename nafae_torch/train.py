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

`train.steps_per_call` (spc) orders the steps and sets the cadence as in
the reference, where a group of spc steps is one XLA program: the
streaming fit applies spc batches of one frame bucket at a time, one
train_step after the other with no host read between them (with several
buckets not in the loader's yield order), takes the steps left over one
by one, and logs, checkpoints and evaluates once a group.
`train.device_cache=true` keeps the dataset on the device and gathers
each batch there (`fit_device_cached`, with or without a mesh).
Batches are packed by the C++ packer (`utils/native_io`, built by g++ at
first use) when `data.use_native_io` is on, and `data.pipeline=grain`
takes grain's batch order (`data/grain_loader`).

    python -m nafae_torch.train --preset config4 --override data.root=... \\
        train.device_cache=true train.steps_per_call=10 [--device cpu]
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from nafae_torch.config import Config
from nafae_torch.device import resolve_device
from nafae_torch.models.grounding import COMPUTE_DTYPES, init_params
from nafae_torch.ops import grounding as G
from nafae_torch.ops import losses as L
from nafae_torch.ops.kernels.diag import diag_epilogue
from nafae_torch.ops.kmeans import (bank_write, kmeans_init, kmeans_lloyd,
                                    kmeans_plusplus_init)
from nafae_torch.parallel import sharding as S
from nafae_torch.parallel import sp

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
    """

    def __init__(self, cfg: Config):
        tc = cfg.train
        self.kind = "sgd" if tc.optimizer == "sgd" else "adam"
        self.peak, self.warmup = tc.lr, tc.warmup_steps
        self.decay_steps = max(tc.steps, tc.warmup_steps + 1)
        self.end = tc.lr * 0.01
        self.wd = tc.weight_decay
        self.clip = tc.grad_clip

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
        """(new params, new state); the inputs are not changed."""
        if self.clip > 0:     # no host sync: a select, as optax does
            norm = global_norm(grads)
            keep = norm < self.clip
            grads = {k: torch.where(keep, g, g / norm * self.clip)
                     for k, g in grads.items()}
        count = state["count"]
        step_size = -self.lr(count)
        if self.kind == "sgd":
            trace = {k: g + SGD_MOMENTUM * state["trace"][k]
                     for k, g in grads.items()}
            new = {k: params[k] + trace[k] * step_size for k in params}
            return new, {"count": count + 1, "trace": trace}
        b1, b2 = ADAM_B1, ADAM_B2
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * g ** 2 + b2 * state["nu"][k]
              for k, g in grads.items()}
        c = torch.tensor(float(count + 1))       # bias corrections in f32
        bc1 = 1 - torch.tensor(b1) ** c
        bc2 = 1 - torch.tensor(b2) ** c
        new = {}
        for k, p in params.items():
            m_hat = mu[k] / bc1.item()
            v_hat = nu[k] / bc2.item()
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
    """numpy batch (BatchLoader) -> tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def train_step(state: TrainState, batch: dict, cfg: Config,
               tx: Optimizer | None = None, extractor=None, mesh=None,
               debug_nans: bool = False
               ) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One optimizer step on a batch of tensors on state's device; returns
    (new state, metrics as 0-d tensors: l_rank, score_pos, [l_ctx],
    [l_clu], loss, grad_norm — the norm before clipping).

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
    group = frame_group = axes = None
    row_offset = 0
    if mesh is not None:
        from nafae_torch.parallel.mesh import axes_group, frame_size
        group = mesh.get_group(cfg.mesh.data_axis_name)
        if frame_size(mesh) > 1:
            frame_group = mesh.get_group(cfg.mesh.frame_axis_name)
        axes = axes_group(mesh)
        row_offset = (torch.distributed.get_rank(group)
                      * batch["word_ids"].shape[0])
    names = sorted(state.params)
    params = {k: state.params[k].detach().requires_grad_() for k in names}
    with torch.enable_grad():
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
    new_params, opt_state = tx.update(grads, state.opt_state, state.params)

    centers, bank, bank_valid = state.centers, state.bank, state.bank_valid
    sel_f, sel_v = aux.pop("sel_feats"), aux.pop("sel_valid")
    lc = cfg.loss
    if lc.cluster_weight > 0:
        with torch.no_grad():
            e = cfg.model.embed_dim
            if lc.kmeans_source == "bank" and bank is not None:
                bank, bank_valid = bank_write(bank, bank_valid, state.step,
                                              sel_f, sel_v)
                f_nd, v_nd, bdim = bank, bank_valid, 1
            else:
                f_nd, v_nd, bdim = sel_f, sel_v, 0
            f, valid = f_nd.reshape(-1, e), v_nd.reshape(-1)
            if lc.kmeans_init == "plusplus" and state.step == 0:
                gathers = [(g, d) for g, d in ((group, bdim),
                                               (frame_group, bdim + 1))
                           if g is not None]
                centers = kmeans_plusplus_init(
                    f_nd, v_nd, lc.num_clusters,
                    generator=torch.Generator().manual_seed(cfg.train.seed),
                    gathers=gathers)
            if state.step % lc.kmeans_interval == 0:
                dt = COMPUTE_DTYPES[cfg.model.dtype]
                centers = kmeans_lloyd(
                    f, valid, centers, lc.kmeans_iters, lc.kmeans_ema,
                    assign_dtype=None if dt == torch.float32 else dt,
                    group=axes)
    metrics = {k: v.detach() for k, v in aux.items()}
    metrics["grad_norm"] = global_norm(grads).detach()
    return replace(state, step=state.step + 1, params=new_params,
                   opt_state=opt_state, centers=centers, bank=bank,
                   bank_valid=bank_valid), metrics


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
    and train_step's checks of every step."""
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

    def apply(batch):
        nonlocal state, metrics, applied, frames_applied
        state, metrics = train_step(
            state, batch_to_device(local_batch(batch, spec, mesh), device),
            cfg, tx, extractor, mesh, debug_nans)
        applied += 1
        frames_applied += int(np.prod(batch["frame_mask"].shape))

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
                for b in pending.pop(key):
                    apply(b)
            else:
                apply(batch)
            emit()
            if applied >= target:
                break
        # the tail: fewer than spc steps left, or a dataset too small to
        # fill a group; the pending batches one by one, in bucket order
        for b in [b for grp in pending.values() for b in grp]:
            if applied >= target:
                break
            apply(b)
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
    gathered on the device by index (`index_select` along dim 0). The
    index stream is the reference's: a RandomState seeded with train.seed
    draws one permutation of the segments per epoch, batches run across
    epoch boundaries, and a resumed run skips the start step's positions.
    A call takes steps_per_call steps (the last one the steps left) with
    no host read between them, and its metrics are its last step's;
    logging, eval and checkpoints fire on the calls where
    step % max(every, spc) < spc.

    mesh: each rank holds its frame shard of feats, region_mask and
    frame_mask (an F-way frame axis divides its cache by F) and every
    other key whole, and gathers its data rank's rows of each global index
    batch; the step is train_step's DP/SP step, so the trajectory is the
    single device's. `save` writes the single-device checkpoint (rank 0)."""
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
            for j in range(take):
                batch = {k: v.index_select(0, idxs[j])
                         for k, v in cache.items()}
                state, metrics = train_step(state, batch, cfg, tx, mesh=mesh,
                                            debug_nans=debug_nans)
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
