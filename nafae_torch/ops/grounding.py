"""Grounding forward ops: similarity tensor, MIL pooling, context mixing,
cross-batch scores.

The port of `nafae_tpu/ops/grounding.py` that serving and the training step
need (docs/MATH.md §Forward and §Contextual-similarity), and its int8
inference projection. Plain functions on tensors, differentiable by
autograd; the context mix and the fused cross-MIL dispatch to the CUDA
kernels of `ops/kernels/` on the GPU, the int8 product to
`torch._int_mm`.

Conventions: masks are float (0/1). NEG = -1e9 is the masked-max/-softmax
fill. Every product keeps an f32 output: with a bf16 compute dtype its
operands are rounded to bf16 and multiplied in f32 (bf16 x bf16 products
are exact in f32), which is the reference's preferred_element_type=f32
contract; a bf16 torch product would round its output to bf16. f32 products
need TF32 off, which `device.resolve_device` sets; the one exception is the
training step's losses and their gradient under
model.matmul_precision=default (`device.matmul_precision`), where they run
in TF32 as the reference's run in bf16 MXU passes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nafae_torch.ops.kernels import cross_mil as _cross_mil
from nafae_torch.ops.kernels import ctx_mix as _ctx_mix
from nafae_torch.ops.roi_align import _div

NEG = -1e9


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)


def _take_rows(emb: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """emb[ids] with `jnp.take(emb, ids, axis=0)`'s out-of-range rule: an id
    in [-V, 0) wraps, any other id outside [0, V) gives a NaN row. Plain
    indexing would instead fail (a device-side assert on CUDA)."""
    v = emb.shape[0]
    idx = torch.where(ids < 0, ids + v, ids)
    ok = (idx >= 0) & (idx < v)
    rows = emb[idx.clamp(0, v - 1)]
    return torch.where(ok[..., None], rows, torch.nan)


def embed_words(word_ids: torch.Tensor, emb: torch.Tensor,
                m_sim: torch.Tensor | None = None) -> torch.Tensor:
    """word_ids [B,K] int, emb [V,E] -> normalized ŵ [B,K,E].

    m_sim [E,E] (model.similarity="bilinear"): the bilinear form ŵᵀ·M·v̂
    folded into the word side, w̃ = ŵ@M."""
    w = l2_normalize(_take_rows(emb, word_ids.long()))
    if m_sim is not None:
        w = torch.einsum("bke,ef->bkf", w, m_sim.float())
    return w


def _f32_operand(x: torch.Tensor, dtype) -> torch.Tensor:
    return (x if dtype is None else x.to(dtype)).float()


def project_regions(feats: torch.Tensor, w_v: torch.Tensor, b_v: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """feats [B,T,R,D] -> normalized v̂ [B,T,R,E] f32, the [B·T·R, D]x[D, E]
    product taken in `dtype` operands with f32 sums."""
    b, t, r, d = feats.shape
    f2 = _f32_operand(feats.reshape(b * t * r, d), dtype)
    v = f2 @ _f32_operand(w_v, dtype)
    v = v.reshape(b, t, r, -1) + b_v.float()
    return l2_normalize(v)


class ProjectRegionsFused(torch.autograd.Function):
    """project_regions + the cast to the compute dtype, with the normalize
    BACKWARD run in the compute dtype (the JAX package's
    `project_regions_fused`, train.PROJ_FUSED; reduced-precision mode only).

    Same forward as `project_regions(...).to(dtype)`. The backward keeps
    the compute-dtype output and the [N,1] f32 inverse norms as residuals
    and computes dv = (g - v̂ (g·v̂)) inv with f32 row sums, rounds dv to the
    compute dtype and feeds the dW/db products from it. feats is data: it
    gets no gradient."""

    @staticmethod
    def forward(ctx, feats, w_v, b_v, dtype):
        b, t, r, d = feats.shape
        f2 = feats.reshape(b * t * r, d).to(dtype)
        v = f2.float() @ w_v.to(dtype).float() + b_v.float()       # [N,E]
        inv = torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-8)
        vhat = (v * inv).to(dtype)
        ctx.save_for_backward(f2, vhat, inv)
        ctx.dtype = dtype
        return vhat.reshape(b, t, r, -1)

    @staticmethod
    def backward(ctx, g):
        f2, vhat, inv = ctx.saved_tensors
        n, e = vhat.shape
        g2 = g.reshape(n, e).to(ctx.dtype).float()
        vh = vhat.float()
        gd = torch.sum(g2 * vh, dim=-1, keepdim=True)               # [N,1]
        dv32 = (g2 - vh * gd) * inv
        dv = dv32.to(ctx.dtype).float()
        dw = f2.float().T @ dv                                      # [D,E]
        db = dv32.sum(0)
        return None, dw, db, None


def project_regions_fused(feats: torch.Tensor, w_v: torch.Tensor,
                          b_v: torch.Tensor, dtype) -> torch.Tensor:
    """feats [B,T,R,D] -> normalized v̂ [B,T,R,E] in `dtype` (see
    ProjectRegionsFused)."""
    return ProjectRegionsFused.apply(feats, w_v, b_v, dtype)


# ---------------------------------------------------------------- int8 path
# Quantized inference compute (model.quantize=int8|int8pre): the projection
# is the one product quantized, per output channel on the weight side (the
# one granularity that factors out of the contraction over D) and per
# region row on the feature side; the l2_normalize after it nearly cancels
# the row scale. Values are the JAX package's bit for bit: every division
# is IEEE (by a tensor on the operand's device, `_div`: PyTorch's CUDA
# division by a Python number multiplies by its reciprocal, which can move
# a quantized value by one step), and torch.round, like jnp.round, rounds
# half to even.

def _row_scale(x: torch.Tensor, dim: int) -> torch.Tensor:
    """max(max|x| over `dim`, 1e-12) / 127, kept as a size-1 axis."""
    return _div(torch.clamp(torch.amax(torch.abs(x), dim=dim, keepdim=True),
                            min=1e-12), 127.0)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def int8_weight(q: torch.Tensor) -> torch.Tensor:
    """q [K,N] int8, same values, laid out column-major (a transposed view
    of a contiguous [N,K]): the layout of the weight operand that
    cuBLASLt's int8 product reads without a transpose of its own.
    quantize_weight_int8 returns it, and the live server and load_exported
    hold "w_v.q8" this way. Idempotent."""
    return q.t().contiguous().t()


def quantize_weight_int8(w: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """w [D,E] -> (q [D,E] int8 column-major (`int8_weight`), scale [1,E]
    f32), per output channel: s_e = max|w[:, e]| / 127,
    q = clip(round(w / s_e), -127, 127)."""
    w = w.float()
    scale = _row_scale(w, 0)
    return int8_weight(_quantize(w, scale)), scale


def quantize_params_int8(params: dict) -> dict:
    """Inference params: "w_v" replaced by "w_v.q8" and "w_v.scale8" (the
    rest passes through). `project_params` dispatches on "w_v.q8"; the
    "8" keeps these keys apart from serve.quantize_params' storage keys
    (".q" / ".scale"), which dequantize at load."""
    out = {k: v for k, v in params.items() if k != "w_v"}
    out["w_v.q8"], out["w_v.scale8"] = quantize_weight_int8(
        torch.as_tensor(params["w_v"]))
    return out


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M,K] int8 @ b [K,N] int8 -> [M,N] int32, exact, any shape.

    CUDA: `torch._int_mm` (cuBLASLt, int32 sums), which takes M > 16 and K,
    N multiples of 8: other shapes are zero-padded up to those (the padded
    terms add exact zeros to the int32 sums) and the product sliced back. b
    is best column-major (`int8_weight`; its padded copy is laid out so
    too); a row-major b is multiplied as it is, more slowly. CPU: the plain
    version, an int64 product (exact: |sum| <= 127^2·K; an f32 sum is not
    exact past 2^24, which 127^2·2048 passes)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} "
                        f"and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul takes [M,K] x [K,N], got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if a.device.type == "cpu":
        return (a.long() @ b.long()).to(torch.int32)
    if a.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu, not {a.device}")
    (m, k), n = a.shape, b.shape[1]
    pm, pk, pn = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (pm, pk, pn) == (m, k, n):
        return torch._int_mm(a.contiguous(), b)
    a_p = a.new_zeros(pm, pk)
    a_p[:m, :k] = a
    b_p = int8_weight(b.new_zeros(pk, pn))
    b_p[:k, :n] = b
    return torch._int_mm(a_p, b_p)[:m, :n]


def _dequant_project(q2: torch.Tensor, sf: torch.Tensor, w_q: torch.Tensor,
                     w_scale: torch.Tensor, b_v: torch.Tensor,
                     shape: tuple) -> torch.Tensor:
    """int32 product of q2 [N,D] and w_q [D,E], the rank-1 dequant by
    sf [N,1] · w_scale [1,E], bias and normalize -> [B,T,R,E] f32."""
    acc = int8_matmul(q2, w_q)                                  # [N,E] i32
    v = acc.float() * (sf * w_scale.float()) + b_v.float()
    return l2_normalize(v.reshape(*shape, -1))


def project_regions_int8(feats: torch.Tensor, w_q: torch.Tensor,
                         w_scale: torch.Tensor, b_v: torch.Tensor,
                         dtype=None) -> torch.Tensor:
    """feats [B,T,R,D] -> v̂ [B,T,R,E] f32 through an int8 x int8 -> int32
    product: each region row quantized with its own dynamic scale
    (max|f| / 127). `dtype` is taken for the signature and ignored: the
    product is int8 and the output f32, as project_regions' is."""
    del dtype
    b, t, r, d = feats.shape
    f2 = feats.reshape(b * t * r, d)
    sf = _row_scale(f2, 1)                                      # [N,1]
    return _dequant_project(_quantize(f2, sf), sf, w_q, w_scale, b_v,
                            (b, t, r))


def quantize_feats_int8(feats: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """feats [B,T,R,D] -> (q int8, sf [B,T,R,1] f32), per region row: the
    offline half of int8pre (features stored and sent as int8)."""
    sf = _row_scale(feats, -1)
    return _quantize(feats, sf), sf


def project_regions_int8_pre(q_feats: torch.Tensor, sf: torch.Tensor,
                             w_q: torch.Tensor, w_scale: torch.Tensor,
                             b_v: torch.Tensor) -> torch.Tensor:
    """Projection of pre-quantized features (quantize_feats_int8; sf
    [B,T,R] or [B,T,R,1]) -> v̂ [B,T,R,E] f32."""
    b, t, r, d = q_feats.shape
    return _dequant_project(q_feats.reshape(b * t * r, d),
                            sf.reshape(-1, 1).float(), w_q, w_scale, b_v,
                            (b, t, r))


def project_params(params: dict, feats: torch.Tensor, dtype=torch.float32,
                   feats_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Projection dispatch, as the JAX package's: pre-quantized int8
    features (int8 feats + feats_scale, with quantized params), dynamic
    int8 (quantized params), or the f32 / bf16 product."""
    if feats.dtype == torch.int8:
        if "w_v.q8" not in params or feats_scale is None:
            raise ValueError("int8 features need quantized params + their "
                             "scales")
        return project_regions_int8_pre(feats, feats_scale, params["w_v.q8"],
                                        params["w_v.scale8"], params["b_v"])
    if "w_v.q8" in params:
        return project_regions_int8(feats, params["w_v.q8"],
                                    params["w_v.scale8"], params["b_v"],
                                    dtype=dtype)
    return project_regions(feats, params["w_v"], params["b_v"], dtype=dtype)


def _cast2(a: torch.Tensor, b: torch.Tensor, dtype):
    """Cast both operands to the compute dtype, each independently (one may
    already be in it)."""
    if dtype is None:
        return a, b
    return a.to(dtype), b.to(dtype)


def similarity_tensor(w_emb: torch.Tensor, v_emb: torch.Tensor,
                      dtype=None) -> torch.Tensor:
    """s[b,k,t,r] = ŵ[b,k]·v̂[b,t,r]: [B,K,E]x[B,T,R,E] -> [B,K,T,R] f32."""
    w_emb, v_emb = _cast2(w_emb, v_emb, dtype)
    return torch.einsum("bke,btre->bktr", w_emb.float(), v_emb.float())


def mask_regions(s: torch.Tensor,
                 region_mask: torch.Tensor | None) -> torch.Tensor:
    """Fill invalid region slots with NEG so max/argmax/softmax ignore them.

    s [..,K,T,R] (leading video axis first); region_mask [B,T,R] or None."""
    if region_mask is None:
        return s
    extra = s.dim() - region_mask.dim() - 1
    rm = region_mask.reshape(
        region_mask.shape[:1] + (1,) * (extra + 1) + region_mask.shape[1:])
    return torch.where(rm > 0, s, NEG)


def argmax_regions_2d(s: torch.Tensor) -> torch.Tensor:
    """argmax_r of the [B,K,T,R] similarity, first index on ties (the JAX
    package's [R, B·K·T] relayout is a TPU layout choice; the selection is
    the same)."""
    b, k, t, r = s.shape
    return torch.argmax(s.reshape(b * k * t, r), dim=-1).reshape(b, k, t)


def frame_mil_max(s: torch.Tensor, frame_mask: torch.Tensor) -> torch.Tensor:
    """MIL max over regions: a[..,k,t] = max_r s (invalid frames -> 0).
    torch.amax splits the gradient evenly between tied maxima, as JAX's max
    does (torch.max(dim) would send it all to one index): a valid frame
    whose regions are all masked has R tied NEG entries."""
    a = torch.amax(s, dim=-1)
    return torch.where(frame_mask[..., None, :] > 0, a, 0.0)


def frame_attention(frame_logits: torch.Tensor, frame_mask: torch.Tensor,
                    temp: float, pool: str) -> torch.Tensor:
    """β[..,t] from per-frame logits g[..,t] (docs/MATH.md step 5)."""
    if pool == "mean":
        denom = torch.clamp(frame_mask.sum(-1, keepdim=True), min=1.0)
        return (frame_mask / denom).expand(frame_logits.shape)
    logits = torch.where(frame_mask > 0, frame_logits / temp, NEG)
    return torch.softmax(logits, dim=-1) * frame_mask


def _masked_word_mean(x: torch.Tensor, word_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the word axis: x [..,K,T], word_mask [..,K] -> [..,T]."""
    num = torch.sum(x * word_mask[..., None], dim=-2)
    den = torch.clamp(word_mask.sum(-1), min=1.0)
    return num / den[..., None]


def learned_frame_logits(v_emb: torch.Tensor, frame_mask: torch.Tensor,
                         region_mask: torch.Tensor | None,
                         attn_w: torch.Tensor) -> torch.Tensor:
    """Learned per-frame logits g[b,t] = v̄[b,t]·attn_w (frame_pool=
    "learned"; bias-free), v̄ the masked mean of v̂ over valid regions."""
    if region_mask is not None:
        num = torch.sum(v_emb * region_mask[..., None].to(v_emb.dtype), dim=-2)
        den = torch.clamp(region_mask.sum(-1), min=1.0)
    else:
        num = torch.sum(v_emb, dim=-2)
        # a fill on the device, not a copy from the host (which a CUDA
        # graph's capture refuses)
        den = torch.full((), float(v_emb.shape[-2]), device=v_emb.device)
    vbar = num.float() / den[..., None]                          # [B,T,E]
    g = torch.einsum("bte,e->bt", vbar, attn_w.float())
    return g * frame_mask


def video_scores(a: torch.Tensor, word_mask: torch.Tensor,
                 frame_mask: torch.Tensor, temp: float, pool: str,
                 frame_logits: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """a [..,K,T] -> (S [..], β [..,T]). frame_logits overrides g."""
    g = frame_logits if frame_logits is not None \
        else _masked_word_mean(a, word_mask)
    beta = frame_attention(g, frame_mask, temp,
                           "attention" if pool in ("context", "learned")
                           else pool)
    s_w = torch.sum(beta[..., None, :] * a, dim=-1)              # [.., K]
    s = torch.sum(s_w * word_mask, dim=-1) / torch.clamp(
        word_mask.sum(-1), min=1.0)
    return s, beta


def extend_for_window(v_emb: torch.Tensor, frame_mask: torch.Tensor,
                      region_mask: torch.Tensor | None, window: int,
                      frame_group=None):
    """(v_ext, fm_ext, rm_ext) extended by `window` frames on each side:
    zero halo frames on a single device (invalid, fm_ext = 0), the
    neighbouring shards' frames through `parallel.sp.halo_exchange` under
    frame parallelism (`frame_group`, the mesh's frame axis), where the
    edge shards receive zeros, so that the two are mask-identical."""
    if frame_group is not None:
        from nafae_torch.parallel.sp import halo_exchange
        return (halo_exchange(v_emb, window, frame_group),
                halo_exchange(frame_mask, window, frame_group),
                halo_exchange(region_mask, window, frame_group)
                if region_mask is not None else None)
    w = window
    return (F.pad(v_emb, (0, 0, 0, 0, w, w)),
            F.pad(frame_mask, (w, w)),
            F.pad(region_mask, (0, 0, w, w))
            if region_mask is not None else None)


def context_mix(v_ext: torch.Tensor, fm_ext: torch.Tensor, window: int,
                temp: float, dtype=None,
                rm_ext: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Context-mixed region embeddings (u [B,T,R,E] f32, nbr_valid
    [B,T,2w]): the CUDA kernel on the GPU, its plain version on the CPU
    (ops/kernels/ctx_mix.py)."""
    return _ctx_mix.ctx_mix(v_ext, fm_ext, window, temp, dtype=dtype,
                            rm_ext=rm_ext)


def _cross_sim(we: torch.Tensor, ve: torch.Tensor) -> torch.Tensor:
    """[J,K,E]x[I,T,R,E] -> [I,J,K,T,R] f32."""
    return torch.einsum("jke,itre->ijktr", we.float(), ve.float())


def cross_scores(w_emb: torch.Tensor, word_mask: torch.Tensor,
                 v_emb: torch.Tensor, frame_mask: torch.Tensor,
                 temp: float, pool: str,
                 ctx_window: int = 0, ctx_temp: float = 0.1,
                 impl: str = "jnp", dtype=None,
                 region_mask: torch.Tensor | None = None,
                 u: torch.Tensor | None = None,
                 frame_logits: torch.Tensor | None = None) -> torch.Tensor:
    """Full B×B score matrix S[i,j] = score(video i, sentence j) for the
    ranking loss. impl="jnp": einsums over the [I,J,K,T,R] cross tensor;
    impl="pallas": the fused cross-MIL of `ops/kernels/cross_mil.py` (the
    CUDA kernel on the GPU, the port of K3a/K3b), which never materialises
    that tensor and routes the gradient to the saved argmax.
    u: precomputed context-mixed embeddings (context_mix on the same
    v_emb and masks), so the train step runs the context mix once.
    frame_logits: precomputed sentence-independent per-frame logits [I,T]
    (pool="learned"), broadcast over sentences j."""
    fm = frame_mask[:, None, :]                               # [I,1,T]
    wm = word_mask[None, :, :]                                # [1,J,K]
    g_learned = (frame_logits[:, None, :]
                 if frame_logits is not None else None)
    ctx_pool = pool == "context" and ctx_window > 0
    if ctx_pool and u is None:
        v_ext, fm_ext, rm_ext = extend_for_window(v_emb, frame_mask,
                                                  region_mask, ctx_window)
        u, _ = context_mix(v_ext, fm_ext, ctx_window, ctx_temp,
                           dtype=dtype, rm_ext=rm_ext)
    if impl == "pallas":
        a = _cross_mil.cross_mil(w_emb, v_emb, frame_mask, region_mask,
                                 dtype=dtype)                 # [I,J,K,T]
        frame_logits = g_learned
        if ctx_pool:
            ahat = _cross_mil.cross_mil(w_emb, u, frame_mask, region_mask,
                                        dtype=dtype)
            frame_logits = _masked_word_mean(ahat, wm)
        return video_scores(a, wm, fm, temp, pool,
                            frame_logits=frame_logits)[0]
    we, ve = _cast2(w_emb, v_emb, dtype)
    s = mask_regions(_cross_sim(we, ve), region_mask)        # [I,J,K,T,R]
    a = frame_mil_max(s, fm)                                  # [I,J,K,T]
    frame_logits = g_learned
    if ctx_pool:
        we2, ue = _cast2(w_emb, u, dtype)
        shat = mask_regions(_cross_sim(we2, ue), region_mask)
        ahat = frame_mil_max(shat, fm)
        frame_logits = _masked_word_mean(ahat, wm)
    return video_scores(a, wm, fm, temp, pool, frame_logits=frame_logits)[0]


def ground_forward(params: dict, feats: torch.Tensor, word_ids: torch.Tensor,
                   frame_mask: torch.Tensor, word_mask: torch.Tensor,
                   temp: float = 0.1, pool: str = "attention",
                   ctx_window: int = 0, ctx_temp: float = 0.1,
                   compute_dtype=torch.float32,
                   region_mask: torch.Tensor | None = None,
                   feats_scale: torch.Tensor | None = None) -> dict:
    """Full single-video forward pass (the serving path).

    params: {"word_emb": [V,E], "w_v": [D,E], "b_v": [E]} (+ "attn_w" [E]
    when pool="learned"; + "m_sim" [E,E] when model.similarity="bilinear").
    region_mask [B,T,R]: fills invalid region slots with NEG before every
    max; None = all regions of valid frames valid.
    Returns dict with w_emb, v_emb, s, a, beta, score, and (if
    ctx_window>0) u, nbr_valid, shat, ahat.
    """
    w_emb = embed_words(word_ids, params["word_emb"],
                        m_sim=params.get("m_sim"))
    v_emb = project_params(params, feats, dtype=compute_dtype,
                           feats_scale=feats_scale)
    cdt = (None if compute_dtype is None or compute_dtype == torch.float32
           else compute_dtype)
    s = mask_regions(similarity_tensor(w_emb, v_emb, dtype=cdt), region_mask)
    a = frame_mil_max(s, frame_mask)
    out = {"w_emb": w_emb, "v_emb": v_emb, "s": s, "a": a}
    frame_logits = None
    if ctx_window > 0:
        w_ = ctx_window
        v_ext, fm_ext, rm_ext = extend_for_window(v_emb, frame_mask,
                                                  region_mask, w_)
        u, nbr_valid = context_mix(v_ext, fm_ext, w_, ctx_temp, dtype=cdt,
                                   rm_ext=rm_ext)
        shat = mask_regions(similarity_tensor(w_emb, u, dtype=cdt),
                            region_mask)
        ahat = frame_mil_max(shat, frame_mask)
        out.update(nbr_valid=nbr_valid, shat=shat, ahat=ahat, u=u)
        if pool == "context":
            frame_logits = _masked_word_mean(ahat, word_mask)
    if pool == "learned":
        frame_logits = learned_frame_logits(
            v_emb, frame_mask, region_mask, params["attn_w"])
    score, beta = video_scores(a, word_mask, frame_mask, temp, pool,
                               frame_logits=frame_logits)
    out.update(score=score, beta=beta)
    return out
