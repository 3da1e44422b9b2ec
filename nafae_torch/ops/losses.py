"""Loss functions: ranking, contextual similarity, visual clustering.

The port of `nafae_tpu/ops/losses.py` (docs/MATH.md §Ranking /
§Contextual / §Visual-clustering); the ranking loss of a row shard,
`ranking_loss_rows`, is in `parallel/sharding.py`, as in the reference,
over `ranking_hinge_total` here. Each loss is a masked reduction over
the full batch tensor; gradients come from autograd, with the
stop-gradients of the reference written as `.detach()`.
"""

from __future__ import annotations

import torch

from nafae_torch.ops.kmeans import kmeans_assign


def rank_denominator(b: int, norm: str) -> int:
    """Normalizer of the ranking hinge sum (`loss.rank_norm`): "pairs"
    divides by the ordered pairs i≠j, "hinges" by the 2·B·(B−1) hinge
    terms, "batch" by B."""
    if norm == "pairs":
        return max(b * (b - 1), 1)
    if norm == "hinges":
        return max(2 * b * (b - 1), 1)
    if norm == "batch":
        return max(b, 1)
    raise ValueError(f"unknown rank_norm {norm!r}; "
                     "choose pairs | hinges | batch")


def ranking_hinge_total(rows: torch.Tensor, diag_global: torch.Tensor,
                        row_offset: int, margin: float) -> torch.Tensor:
    """Sum of both hinge families of a row block of the score matrix.

    rows [B_loc, B_glob] (row i's global id = row_offset + i);
    diag_global [B_glob] = S[j,j]."""
    b_loc, b_glob = rows.shape
    gidx = row_offset + torch.arange(b_loc, device=rows.device)
    is_diag = (torch.arange(b_glob, device=rows.device)[None, :]
               == gidx[:, None]).to(rows.dtype)
    off = 1.0 - is_diag
    my_diag = torch.sum(rows * is_diag, dim=1)               # S[i,i]
    wrong_sent = torch.relu(margin + rows - my_diag[:, None]) * off
    wrong_vid = torch.relu(margin + rows - diag_global[None, :]) * off
    return torch.sum(wrong_sent) + torch.sum(wrong_vid)


def ranking_loss(score_mat: torch.Tensor, margin: float,
                 norm: str = "pairs") -> torch.Tensor:
    """Max-margin triplet loss over the B×B in-batch score matrix
    (score_mat[i,j] = score(video i, sentence j); diagonal = positives)."""
    b = score_mat.shape[0]
    total = ranking_hinge_total(score_mat, torch.diagonal(score_mat), 0,
                                margin)
    return total / rank_denominator(b, norm)


def ctx_squared_error(s: torch.Tensor, shat: torch.Tensor,
                      target: str = "stopgrad") -> torch.Tensor:
    """(s − ŝ)², with the gradient flowing per `loss.ctx_target`:
    "stopgrad" (ŝ is a teacher: d/ds only), "live" (both sides),
    "symmetric" (½(s−sg ŝ)² + ½(ŝ−sg s)²)."""
    if target == "stopgrad":
        return (s - shat.detach()) ** 2
    if target == "live":
        return (s - shat) ** 2
    if target == "symmetric":
        return 0.5 * ((s - shat.detach()) ** 2 + (shat - s.detach()) ** 2)
    raise ValueError(f"unknown ctx_target {target!r}; "
                     "choose stopgrad | live | symmetric")


def context_loss_terms(s: torch.Tensor, shat: torch.Tensor,
                       word_mask: torch.Tensor, frame_mask: torch.Tensor,
                       nbr_valid: torch.Tensor,
                       region_mask: torch.Tensor | None = None,
                       target: str = "stopgrad"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(numerator, denominator) of L_ctx over valid (b,k,t,r): frames with
    no valid neighbour contribute nothing. region_mask is required whenever
    s was region-masked (its NEG fills would enter the squares)."""
    has_ctx = (nbr_valid.sum(-1) > 0).to(s.dtype)                 # [B,T]
    m = word_mask[:, :, None] * frame_mask[:, None, :] * has_ctx[:, None, :]
    sq = ctx_squared_error(s, shat, target)                       # [B,K,T,R]
    if region_mask is None:
        return torch.sum(sq * m[..., None]), torch.sum(m) * s.shape[-1]
    m4 = m[..., None] * region_mask[:, None, :, :]
    return torch.sum(sq * m4), torch.sum(m4)


def context_loss(s: torch.Tensor, shat: torch.Tensor, word_mask: torch.Tensor,
                 frame_mask: torch.Tensor, nbr_valid: torch.Tensor,
                 region_mask: torch.Tensor | None = None,
                 target: str = "stopgrad") -> torch.Tensor:
    """L_ctx = masked mean (s − ŝ)² (context_loss_terms)."""
    num, den = context_loss_terms(s, shat, word_mask, frame_mask, nbr_valid,
                                  region_mask, target)
    return num / torch.clamp(den, min=1.0)


def select_top_regions(s: torch.Tensor, v_emb: torch.Tensor,
                       word_mask: torch.Tensor, frame_mask: torch.Tensor,
                       region_mask: torch.Tensor | None = None,
                       r_star: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(word, frame) argmax region features: s [B,K,T,R], v_emb
    [B,T,R,E] -> f [B,K,T,E] f32, valid [B,K,T].

    An exact gather (the JAX package's one-hot product at full precision
    is exact too); the index carries no gradient, the gathered features
    do, and it flows into v̂, summed in f32 before any cast back to
    v̂'s dtype. Frames with no valid region are left out of `valid`."""
    if r_star is None:
        r_star = torch.argmax(s, dim=-1)                          # [B,K,T]
    b, k, t = r_star.shape
    bi = torch.arange(b, device=s.device)[:, None, None]
    ti = torch.arange(t, device=s.device)[None, None, :]
    f = v_emb.float()[bi, ti, r_star]                             # [B,K,T,E]
    valid = word_mask[:, :, None] * frame_mask[:, None, :]
    if region_mask is not None:
        any_region = region_mask.amax(-1) > 0                     # [B,T]
        valid = valid * any_region[:, None, :].to(valid.dtype)
    return f, valid


def cluster_loss_terms(f: torch.Tensor, valid: torch.Tensor,
                       centers: torch.Tensor, assign_dtype=None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(numerator, denominator, assignments) of L_clu = masked mean
    ‖f − sg[C[c*]]‖² with c* the cosine assignment (kmeans_assign)."""
    n = f.shape[:-1]
    assign = kmeans_assign(f, centers, dtype=assign_dtype)        # [..]
    target = centers[assign.reshape(-1)].reshape(*n, -1).detach()
    sq = torch.sum((f - target) ** 2, dim=-1)                     # [..]
    return torch.sum(sq * valid), torch.sum(valid), assign


def cluster_loss(f: torch.Tensor, valid: torch.Tensor,
                 centers: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L_clu, assignments)."""
    num, den, assign = cluster_loss_terms(f, valid, centers)
    return num / torch.clamp(den, min=1.0), assign
