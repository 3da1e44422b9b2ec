"""Training: the config-2/3/4 step on precomputed RoI features and the
config-5 step on frames, the optimizer, the k-means refresh, the fit loop
and the CLI.

The port of `nafae_tpu/train.py` on one device with the streaming loader:
forward, the three losses, their gradient (autograd; the context mix's
gradient in the CUDA kernels of `ops/kernels/ctx_mix.py` on the GPU), the
optimizer update and the periodic k-means refresh. `train.kernels=pallas`
(or the legacy `train.use_pallas=true`) takes the reference's fused route:
the fused cross-MIL (`ops/kernels/cross_mil.py`, K3a/K3b) for the score
matrix and, at config 4, the fused diag epilogue (`ops/kernels/diag.py`,
K4f/K4b) for the context and cluster losses. With `data.from_videos=true`
(config 5) batches carry frames: the loader decodes them
(`data/video_dataset.py`) and the step runs the frozen Faster R-CNN
(`models/detector`, with the NMS and RoIAlign kernels) before the losses.

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
Not ported yet, and raising NotImplementedError: the device-resident
dataset (`train.device_cache`), the grain pipeline and the TensorBoard
mirror (`train.tensorboard_dir`). Meshes and data parallelism are not ported
either: the reference builds a mesh only under its CLI's `--mesh` or
`--multihost`, which this CLI does not accept, so `mesh.*` alone trains on
one device in both. The CLI evaluates every `train.eval_every` steps on the
val split (`evaluate.evaluate_config`), as the reference's does.
`train.steps_per_call` groups steps into one XLA program in the JAX
package; PyTorch runs eagerly, so the port ignores it.
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
        _check_supported(cfg)
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


def _check_supported(cfg: Config) -> None:
    todo = {"train.device_cache": cfg.train.device_cache,
            "data.pipeline=grain": cfg.data.pipeline == "grain",
            "train.tensorboard_dir": bool(cfg.train.tensorboard_dir)}
    on = [k for k, v in todo.items() if v]
    if on:
        raise NotImplementedError(
            f"{', '.join(on)}: not ported yet (the port trains on one "
            "device from the streaming loader)")


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
                   cfg: Config, kernels: str = "auto", extractor=None
                   ) -> tuple[torch.Tensor, dict]:
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
    first, with no gradient."""
    pallas = kernels == "pallas"
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
        v_ext, fm_ext, rm_ext = G.extend_for_window(v_emb, fm, rm, w_)
        u, nbr_valid = G.context_mix(v_ext, fm_ext, w_, lc.ctx_temp,
                                     dtype=cdt, rm_ext=rm_ext)

    g_learned = (G.learned_frame_logits(v_emb, fm, rm, params["attn_w"])
                 if mc.frame_pool == "learned" else None)
    rows = G.cross_scores(w_emb, wm, v_emb, fm, mc.frame_attn_temp,
                          mc.frame_pool, ctx_window, lc.ctx_temp,
                          impl="pallas" if pallas else "jnp", dtype=cdt,
                          region_mask=rm, u=u, frame_logits=g_learned)
    b = rows.shape[0]
    diag = torch.sum(rows * torch.eye(b, dtype=rows.dtype,
                                      device=rows.device), dim=1)
    l_rank = L.ranking_loss_rows(rows, diag, 0, lc.margin, norm=lc.rank_norm)
    total = l_rank
    aux = {"l_rank": l_rank, "score_pos": torch.sum(diag) / max(b, 1)}

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
        l_ctx = (torch.sum(wm[:, :, None] * ctx_kt)
                 / torch.clamp(torch.sum(m3 * rsum[:, None, :]), min=1.0))
        total = total + lc.ctx_weight * l_ctx
        aux["l_ctx"] = l_ctx
        any_region = ((rm.amax(-1) > 0).to(wm.dtype) if rm is not None
                      else torch.ones_like(fm))
        valid_tk = (fm * any_region)[:, :, None] * wm[:, None, :]  # [B,T,K]
        aux["sel_feats"] = f_tk                        # already stop-grad
        aux["sel_valid"] = valid_tk
        l_clu = (torch.sum(clu_kt * valid_tk.permute(0, 2, 1))
                 / torch.clamp(torch.sum(valid_tk), min=1.0))
        total = total + lc.cluster_weight * l_clu
        aux["l_clu"] = l_clu
        aux["loss"] = total
        return total, aux

    if ctx_on:
        shat = G.mask_regions(G.similarity_tensor(w_emb, u, dtype=cdt), rm)
        if lc.ctx_weight > 0:
            num, den = L.context_loss_terms(s, shat, wm, fm, nbr_valid, rm,
                                            target=lc.ctx_target)
            l_ctx = num / torch.clamp(den, min=1.0)
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
        l_clu = num / torch.clamp(den, min=1.0)
        total = total + lc.cluster_weight * l_clu
        aux["l_clu"] = l_clu
    aux["loss"] = total
    return total, aux


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch (BatchLoader) -> tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def train_step(state: TrainState, batch: dict, cfg: Config,
               tx: Optimizer | None = None, extractor=None
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
    compute_losses)."""
    tx = tx or make_optimizer(cfg)
    names = sorted(state.params)
    params = {k: state.params[k].detach().requires_grad_() for k in names}
    with torch.enable_grad():
        total, aux = compute_losses(params, state.centers, batch, cfg,
                                    cfg.train.resolved_kernels(), extractor)
        grads = torch.autograd.grad(total, [params[k] for k in names],
                                    allow_unused=True)
    grads = {k: torch.zeros_like(params[k]) if g is None else g
             for k, g in zip(names, grads)}
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
                f_nd, v_nd = bank, bank_valid
            else:
                f_nd, v_nd = sel_f, sel_v
            f, valid = f_nd.reshape(-1, e), v_nd.reshape(-1)
            if lc.kmeans_init == "plusplus" and state.step == 0:
                centers = kmeans_plusplus_init(
                    f_nd, v_nd, lc.num_clusters,
                    generator=torch.Generator().manual_seed(cfg.train.seed))
            if state.step % lc.kmeans_interval == 0:
                dt = COMPUTE_DTYPES[cfg.model.dtype]
                centers = kmeans_lloyd(
                    f, valid, centers, lc.kmeans_iters, lc.kmeans_ema,
                    assign_dtype=None if dt == torch.float32 else dt)
    metrics = {k: v.detach() for k, v in aux.items()}
    metrics["grad_norm"] = global_norm(grads).detach()
    return replace(state, step=state.step + 1, params=new_params,
                   opt_state=opt_state, centers=centers, bank=bank,
                   bank_valid=bank_valid), metrics


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
        log_fn=None, extractor=None, eval_fn=None) -> tuple[TrainState, dict]:
    """Run cfg.train.steps steps from the newest checkpoint in
    train.ckpt_dir (or from scratch); returns the final state and the last
    metrics. Logs JSONL to train.ckpt_dir/metrics.jsonl every log_every
    steps (and calls log_fn), checkpoints every ckpt_every steps and at
    the end, and calls eval_fn(state) every eval_every steps.

    With data.from_videos, the dataset is the annotations' segments
    decoded to frames and the step runs `extractor`, by default the
    detector cfg.detector describes (`init_detector`: random weights from
    train.seed, then detector.weights when set; the reference's config-5
    inline path, `nafae_tpu/train.py` fit). model.word_vectors replaces the
    initial word_emb (before a checkpoint is restored)."""
    from nafae_torch.data.loader import BatchLoader
    from nafae_torch.data.youcook2 import SegmentDataset
    from nafae_torch.utils.checkpoint import CheckpointManager
    from nafae_torch.utils.metrics_log import MetricsLogger

    _check_supported(cfg)
    device = resolve_device(device)
    if cfg.data.from_videos:
        from nafae_torch.data.video_dataset import VideoSegmentDataset
        from nafae_torch.data.vocab import vocab_from_config
        from nafae_torch.models.detector.faster_rcnn import init_detector
        if not cfg.data.annotations:
            raise ValueError("data.from_videos needs data.annotations "
                             "(segments.jsonl)")
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
    state = TrainState.create(cfg, device=device)
    if cfg.model.word_vectors:
        state = replace(state, params={**state.params,
                                       "word_emb": _word_vectors(cfg, device)})
    ckpt = CheckpointManager(cfg.train.ckpt_dir, keep=cfg.train.keep_ckpts)
    restored = ckpt.restore_latest(state)
    if restored is not None:
        state = restored
    logger = MetricsLogger(cfg.train.ckpt_dir)
    loader = BatchLoader(ds, cfg.data.batch_size, shuffle=True,
                         seed=cfg.train.seed, prefetch=cfg.data.prefetch)
    tx = make_optimizer(cfg)

    # resume the loader at its exact position (epoch + offset from the step)
    start_step = state.step
    eb = loader.batches_per_epoch()
    start_epoch = start_step // eb if eb else 0
    skip = start_step % eb if eb else 0
    target = cfg.train.steps
    applied = start_step
    frames_applied = frames_logged = 0
    last_fired = dict.fromkeys(("log", "ckpt", "eval"), start_step)
    t0 = time.perf_counter()
    metrics: dict = {}

    def due(kind, every):
        return every > 0 and applied - last_fired[kind] >= every

    budget = (target - applied) * 2 + 16
    for _, batch in loader.steps(budget, start_epoch=start_epoch, skip=skip):
        if applied >= target:
            break     # e.g. re-running an already-completed checkpoint dir
        state, metrics = train_step(state, batch_to_device(batch, device),
                                    cfg, tx, extractor)
        applied += 1
        frames_applied += int(np.prod(batch["frame_mask"].shape))
        if due("log", cfg.train.log_every):
            last_fired["log"] = applied
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
            ckpt.save(state)
        if eval_fn and due("eval", cfg.train.eval_every):
            last_fired["eval"] = applied
            eval_fn(state)
        if applied >= target:
            break
    ckpt.save(state)
    return state, metrics


def main(argv=None) -> None:
    import argparse

    from nafae_torch.config import load_config

    p = argparse.ArgumentParser("nafae_torch.train")
    p.add_argument("--preset", default="config2")
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--override", nargs="*", action="extend", default=None)
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    cfg = load_config(args.config, args.preset, args.override or [])

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

    fit(cfg, device=args.device, log_fn=log_fn, eval_fn=eval_fn)


if __name__ == "__main__":
    main()
