"""Distributed grounding: the ranking decomposition over the data axis and
the collectives of the data- and frame-parallel step (the port of
`nafae_tpu/parallel/sharding.py`).

Each rank holds a row shard of the B×B score matrix: its own videos
against all sentences. Only the word embeddings (B·K·E) and the score
diagonal (B) are all-gathered, never region features (B·T·R·E), by the
identity

  Σ_{i≠j} relu(Δ+S[j,i]−S[i,i])  =  Σ_{i≠j} relu(Δ+S[i,j]−S[j,j])

so both hinge families are computable from row shards and the global
diagonal.

Gradients follow the reference's shard_map transposes. A value that is
the same on every rank of a group (the loss, the score rows under frame
parallelism) carries its whole cotangent on every rank, so `global_sum`,
the sum over a group, hands the cotangent to each rank's share
unchanged, as JAX transposes psum. A value that varies over ranks
carries only its own rank's part. Where a varying value is computed from
an invariant one, the invariant one's cotangent is the sum of the ranks'
parts: `gather_rows` adds them in its backward (data axis), and the one
all-reduce of the parameter gradients over both axes
(`train.train_step`) adds the rest, which is exact as long as nothing
between that value and the parameters needs its whole cotangent.
`global_sum`'s backward does need it, so the output of a sum must not
feed a varying value under autograd: `parallel/sp.py` forms its online
softmax's quotient after the sums, where both sides are invariant.

On gloo, a CUDA tensor is staged through host memory for every
collective here and in `parallel/sp.py` (gloo has no CUDA all_gather or
send/recv); the kernels still run on the card.

`COLLECTIVES` records every collective these functions issue, and every
send and receive of the halo exchange: its op, shape, dtype and bytes
(this rank's payload).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from nafae_torch.ops.losses import rank_denominator, ranking_hinge_total


class CollectiveLog:
    """The collectives issued since the last reset: (op, shape, dtype,
    bytes) each."""

    def __init__(self):
        self.records: list[tuple[str, tuple, str, int]] = []

    def add(self, op: str, t: torch.Tensor) -> None:
        self.records.append((op, tuple(t.shape), str(t.dtype).split(".")[-1],
                             t.numel() * t.element_size()))

    def reset(self) -> None:
        self.records.clear()


COLLECTIVES = CollectiveLog()


def shard_rows(x, rank: int, world: int, dim: int = 0):
    """Rank `rank`'s equal share of x (a tensor or numpy array) along
    `dim`: rows [rank·n, (rank+1)·n) with n = x.shape[dim] // world."""
    n = x.shape[dim] // world
    return x[(slice(None),) * dim + (slice(rank * n, (rank + 1) * n),)]


def staged(t: torch.Tensor, group) -> bool:
    """Whether a collective of `t` over `group` goes through host memory:
    a CUDA tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    with torch.no_grad():
        if staged(t, group):
            host = t.contiguous().cpu()
            dist.all_reduce(host, op=op, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """In-place SUM over the group, outside autograd; returns t."""
    COLLECTIVES.add("all_reduce", t)
    return _all_reduce(t, group, dist.ReduceOp.SUM)


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """In-place MAX over the group, outside autograd (the reference's
    pmax); returns t."""
    COLLECTIVES.add("all_reduce_max", t)
    return _all_reduce(t, group, dist.ReduceOp.MAX)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim` in rank order, outside
    autograd."""
    COLLECTIVES.add("all_gather", t)
    t = t.detach().contiguous()
    dev = t.device
    if staged(t, group):
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim).to(dev)


class _Gather(torch.autograd.Function):
    """all_gather along dim 0; the backward all-reduces the whole
    cotangent and keeps this rank's rows. (torch.distributed.nn's gather
    takes all_to_all in its backward, which gloo lacks.)"""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.rows = group, t.shape[0]
        return all_gather(t, group)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce(grad.contiguous().clone(), ctx.group)
        r = dist.get_rank(ctx.group)
        return grad[r * ctx.rows:(r + 1) * ctx.rows], None


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all_gather of `t` along dim 0 (equal shards)."""
    return _Gather.apply(t, group)


def global_sum(share: torch.Tensor, group) -> torch.Tensor:
    """The sum of `share` over the group, elementwise (the reference's
    psum), with the gradient of this rank's share only: the sum is the
    same on every rank, so its cotangent is whole on each, and the
    transpose hands it to each share unchanged."""
    if group is None:
        return share
    total = all_reduce(share.detach().clone(), group)
    return total + (share - share.detach())     # the value exactly total


def global_mean(num: torch.Tensor, den: torch.Tensor, group
                ) -> torch.Tensor:
    """Σ num / max(Σ den, 1) over the group's ranks (the reference's
    `_global_mean`): the denominator, which holds no gradient, is
    all-reduced, and each rank's gradient is that of num / max(Σ den, 1)."""
    if group is None:
        return num / torch.clamp(den, min=1.0)
    den = all_reduce(den.detach().clone(), group)
    return global_sum(num / torch.clamp(den, min=1.0), group)


def ranking_loss_rows(rows: torch.Tensor, diag_global: torch.Tensor,
                      row_offset: int, margin: float, group=None,
                      norm: str = "pairs") -> torch.Tensor:
    """Ranking loss from a row shard `rows` [B_loc, B_glob] and the
    global diagonal [B_glob]; row_offset is the global index of local row
    0. With a group, the hinge sums of every rank's rows are added
    (`global_sum`), so every rank returns the global loss. norm: the
    normalizer over the global batch (`ops.losses.rank_denominator`)."""
    total = global_sum(ranking_hinge_total(rows, diag_global, row_offset,
                                           margin), group)
    return total / rank_denominator(rows.shape[1], norm)


def _gathered(t: torch.Tensor, group) -> torch.Tensor:
    # without a group, a view: autograd then sums the gradients of its
    # consumers before they reach t, as the gather's backward does, so a
    # world of one gives the single device's gradient bit for bit
    return t.view_as(t) if group is None else gather_rows(t, group)


def gather_words(w_emb: torch.Tensor, word_mask: torch.Tensor, group
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Word embeddings [B_glob,K,E] (differentiable) and masks [B_glob,K]
    of every rank, in rank order (with no group, this rank's)."""
    return (_gathered(w_emb, group),
            word_mask if group is None else all_gather(word_mask, group))


def gather_diag(diag_local: torch.Tensor, group) -> torch.Tensor:
    """The global diagonal [B_glob] from every rank's [B_loc] (with no
    group, this rank's)."""
    return _gathered(diag_local, group)
