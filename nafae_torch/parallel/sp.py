"""Frame parallelism (SP): the frame axis T sharded over the mesh's frame
axis (the port of `nafae_tpu/parallel/sp.py`). Three primitives make the
sharded step equal the single device's:

* halo_exchange — the context window needs w frames of each neighbouring
  shard: one send each way for w <= T_local, and for a window wider than a
  shard, whole blocks from the ceil(w/T_local) nearest shards on each side
  and the slice the farthest one contributes. Edge shards receive zeros,
  which the masks treat as out of range, as the single device's zero
  padding. The backward sends each halo's cotangent back to the shard it
  came from, which adds it into its frames.
* sp_video_scores — the frame-attention softmax over the global T as an
  online softmax: the all-reduced max of the logits (no gradient), then one
  sum over the axis of the exp-weighted scores and of the exps.
* sp_cross_scores — the B×B score rows from frame-sharded region tensors;
  every frame shard ends with the same rows.

The sums over the frame axis follow `sharding.global_sum`'s rule: their
values are the same on every shard and each shard's part takes the whole
cotangent (see `parallel/sharding.py`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from nafae_torch.ops import grounding as G
from nafae_torch.ops.grounding import NEG
from nafae_torch.parallel.sharding import (COLLECTIVES, all_reduce,
                                           all_reduce_max, global_sum, staged)


def _t_slice(x: torch.Tensor, t_axis: int, lo: int, hi: int) -> torch.Tensor:
    return x.narrow(t_axis, lo, hi - lo)


def _pieces(tl: int, window: int) -> list[tuple[int, int]]:
    """(hop d, frames) of each shard's halo on one side, nearest first: a
    whole block from each of the first hops-1 shards, then the `window -
    (hops-1)·tl` frames the farthest one contributes."""
    hops = -(-window // tl)
    return [(d, tl if d < hops else window - (hops - 1) * tl)
            for d in range(1, hops + 1)]


def _exchange(sends: list, recvs: list, group) -> None:
    """Posts every send, then every receive, of one exchange and waits for
    them all; every rank lists its peers in the same hop order.
    sends: (peer's rank in the group, tensor); recvs: (peer, view to fill).
    Each message goes through a contiguous buffer, on the host when the
    group is gloo and the tensor on cuda."""
    ops, back = [], []
    for peer, t in sends:
        COLLECTIVES.add("send", t)
        buf = t.contiguous()
        buf = buf.cpu() if staged(t, group) else buf
        ops.append(dist.P2POp(dist.isend, buf,
                              dist.get_global_rank(group, peer), group))
    for peer, view in recvs:
        COLLECTIVES.add("recv", view)
        buf = torch.empty(view.shape, dtype=view.dtype,
                          device="cpu" if staged(view, group)
                          else view.device)
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, peer), group))
        back.append((view, buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for view, buf in back:
        view.copy_(buf)


class HaloExchange(torch.autograd.Function):
    """x [.., T_l, ..] -> [.., w+T_l+w, ..] along t_axis, halos from the
    neighbouring shards of the frame group (zeros past the ends)."""

    @staticmethod
    def forward(ctx, x, window, group, t_axis):
        n, i = dist.get_world_size(group), dist.get_rank(group)
        tl = x.shape[t_axis]
        pieces = _pieces(tl, window)
        ctx.meta = (window, group, t_axis, n, i, tl, pieces)
        shape = list(x.shape)
        shape[t_axis] = window
        left = torch.zeros(shape, dtype=x.dtype, device=x.device)
        right = torch.zeros_like(left)
        sends, recvs = [], []
        lo = window                 # hop d's piece ends here in `left`,
        for d, k in pieces:         # filled from its inner end
            if i + d < n:           # my tail to the shard d to my right
                sends.append((i + d, _t_slice(x, t_axis, tl - k, tl)))
            if i - d >= 0:
                recvs.append((i - d, _t_slice(left, t_axis, lo - k, lo)))
            lo -= k
        hi = 0                      # where hop d's piece starts in `right`
        for d, k in pieces:         # right halo: nearest piece first
            if i - d >= 0:          # my head to the shard d to my left
                sends.append((i - d, _t_slice(x, t_axis, 0, k)))
            if i + d < n:
                recvs.append((i + d, _t_slice(right, t_axis, hi, hi + k)))
            hi += k
        _exchange(sends, recvs, group)
        return torch.cat([left, x, right], dim=t_axis)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        window, group, t_axis, n, i, tl, pieces = ctx.meta
        g_left = _t_slice(grad, t_axis, 0, window)
        g_right = _t_slice(grad, t_axis, window + tl, 2 * window + tl)
        dx = _t_slice(grad, t_axis, window, window + tl).clone()
        sends, recvs, adds = [], [], []
        lo = window
        for d, k in pieces:         # the left halo's pieces go back left
            if i - d >= 0:
                sends.append((i - d, _t_slice(g_left, t_axis, lo - k, lo)))
            if i + d < n:           # ... and my tail's comes from the right
                buf = torch.empty_like(_t_slice(dx, t_axis, tl - k, tl))
                recvs.append((i + d, buf))
                adds.append((tl - k, buf))
            lo -= k
        hi = 0
        for d, k in pieces:         # the right halo's pieces go back right
            if i + d < n:
                sends.append((i + d, _t_slice(g_right, t_axis, hi, hi + k)))
            if i - d >= 0:          # ... and my head's comes from the left
                buf = torch.empty_like(_t_slice(dx, t_axis, 0, k))
                recvs.append((i - d, buf))
                adds.append((0, buf))
            hi += k
        _exchange(sends, recvs, group)
        for lo, buf in adds:
            dx.narrow(t_axis, lo, buf.shape[t_axis]).add_(buf)
        return dx, None, None, None


def halo_exchange(x: torch.Tensor, window: int, group,
                  t_axis: int = 1) -> torch.Tensor:
    """x [.., T_l, ..] -> [.., w+T_l+w, ..]: this shard's frames between
    `window` frames of real halo on each side from the neighbouring shards
    of the frame group (zeros past the first and last shard), exactly the
    window of the zero-padded global tensor. Differentiable: a halo's
    cotangent goes back to the shard it came from."""
    if window < 1:
        raise ValueError(f"window={window} must be >= 1")
    return HaloExchange.apply(x, window, group, t_axis)


def sp_video_scores(a: torch.Tensor, word_mask: torch.Tensor,
                    frame_mask: torch.Tensor, temp: float, pool: str,
                    group, frame_logits: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Frame-sharded `ops.grounding.video_scores`: a [..,K,T_l] -> (S [..],
    β_local [..,T_l]); S is the same on every frame shard, and β_local
    carries no gradient.

    attention (and context / learned) pooling: an online softmax. The
    max of the masked logits is all-reduced without a gradient (softmax
    is shift-invariant), then one sum over the axis takes Σ_t e_t·a_t and
    Σ_t e_t together, and s_w is their quotient. The quotient is formed
    after the sum, so that the gradient of every e_t reaches the
    denominator through all shards' numerators (see the module
    docstring). mean pooling: the frame counts are summed over the axis."""
    g = (frame_logits if frame_logits is not None
         else G._masked_word_mean(a, word_mask))
    if pool == "mean":
        cnt = all_reduce(frame_mask.sum(-1).detach().clone(), group)
        beta = (frame_mask / torch.clamp(cnt, min=1.0)[..., None]).expand(
            g.shape)
        s_w = global_sum(torch.sum(beta[..., None, :] * a, dim=-1), group)
    else:
        logits = torch.where(frame_mask > 0, g / temp, NEG)
        m = all_reduce_max(logits.detach().amax(-1).contiguous(), group)
        e = torch.exp(logits - m[..., None]) * frame_mask            # [..,T]
        k = a.shape[-2]
        both = global_sum(torch.cat(
            [torch.sum(e[..., None, :] * a, dim=-1),                 # [..,K]
             e.sum(-1, keepdim=True)], dim=-1), group)
        den = torch.clamp(both[..., k], min=1e-30)
        s_w = both[..., :k] / den[..., None]
        beta = (e / den[..., None]).detach()
    s = torch.sum(s_w * word_mask, dim=-1) / torch.clamp(
        word_mask.sum(-1), min=1.0)
    return s, beta


def sp_cross_scores(w_emb: torch.Tensor, word_mask: torch.Tensor,
                    v_emb: torch.Tensor, frame_mask: torch.Tensor,
                    temp: float, pool: str, group,
                    ctx_window: int = 0, ctx_temp: float = 0.1, dtype=None,
                    region_mask: torch.Tensor | None = None,
                    u: torch.Tensor | None = None,
                    frame_logits: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """Frame-sharded `ops.grounding.cross_scores` from the dense product:
    v_emb [I,T_l,R,E] this shard's frames, w_emb [J,K,E] / word_mask [J,K]
    the (data-gathered) global sentences -> rows [I, J], the same on every
    frame shard. u: precomputed context-mixed embeddings of these frames
    (else the halo exchange and the context mix run here). frame_logits:
    per-local-frame logits [I,T_l] (pool="learned")."""
    fm = frame_mask[:, None, :]
    wm = word_mask[None, :, :]
    we, ve = G._cast2(w_emb, v_emb, dtype)
    s = G.mask_regions(G._cross_sim(we, ve), region_mask)     # [I,J,K,T_l,R]
    a = G.frame_mil_max(s, fm)
    logits = frame_logits[:, None, :] if frame_logits is not None else None
    if pool == "context" and ctx_window > 0:
        if u is None:
            v_ext, fm_ext, rm_ext = G.extend_for_window(
                v_emb, frame_mask, region_mask, ctx_window, frame_group=group)
            u, _ = G.context_mix(v_ext, fm_ext, ctx_window, ctx_temp,
                                 dtype=dtype, rm_ext=rm_ext)
        we2, ue = G._cast2(w_emb, u, dtype)
        shat = G.mask_regions(G._cross_sim(we2, ue), region_mask)
        logits = G._masked_word_mean(G.frame_mil_max(shat, fm), wm)
    return sp_video_scores(a, wm, fm, temp,
                           "attention" if pool in ("context", "learned")
                           else pool, group, frame_logits=logits)[0]
