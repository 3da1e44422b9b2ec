"""Batched k-means (Lloyd) for the visual clustering loss.

The port of `nafae_tpu/ops/kmeans.py`: cosine assignment, one-hot segment
sums and the empty-cluster rule on the training device, on one device (the
data-parallel psums come with the port's data parallelism). k-means++
seeding (`loss.kmeans_init="plusplus"`) is not ported yet.
"""

from __future__ import annotations

import torch

from nafae_torch.ops.grounding import l2_normalize


def kmeans_assign(f: torch.Tensor, centers: torch.Tensor,
                  dtype=None) -> torch.Tensor:
    """Cosine assignment c* = argmax_c f·Ĉ[c] (first c on ties).
    f [..,E], centers [Kc,E] -> [..].

    dtype: compute dtype of the sims (the bf16 mode passes model.dtype,
    train.ASSIGN_MXU): operands rounded to it, products summed in f32, as
    one [Kc,E]x[E,N] product. None keeps everything f32."""
    cn = l2_normalize(centers)
    if dtype is None:
        sims = torch.einsum("...e,ce->...c", f.float(), cn.float())
        return torch.argmax(sims, dim=-1)
    f2 = f.reshape(-1, f.shape[-1]).to(dtype).float()
    sims = cn.to(dtype).float() @ f2.T                            # [Kc, N]
    return torch.argmax(sims, dim=0).reshape(f.shape[:-1])


def _lloyd_step(centers: torch.Tensor, f: torch.Tensor, valid: torch.Tensor,
                assign_dtype=None) -> torch.Tensor:
    assign = kmeans_assign(f, centers, dtype=assign_dtype)        # [N]
    onehot = torch.nn.functional.one_hot(assign, centers.shape[0]).to(
        f.dtype) * valid[:, None]                                 # [N,Kc]
    sums = onehot.T @ f                                           # [Kc,E]
    counts = onehot.sum(0)                                        # [Kc]
    new = l2_normalize(sums / torch.clamp(counts, min=1.0)[:, None])
    # empty-cluster handling: keep the old (normalized) center
    return torch.where((counts < 0.5)[:, None], centers, new)


def kmeans_lloyd(f: torch.Tensor, valid: torch.Tensor, centers: torch.Tensor,
                 iters: int, ema: float = 0.0,
                 assign_dtype=None) -> torch.Tensor:
    """`iters` Lloyd iterations; returns updated, normalized centers.

    f [N,E] flattened selected features, valid [N] (0/1), centers [Kc,E].
    ema: blend toward the OLD centers, C ← norm((1−ρ)C_lloyd + ρC_old)."""
    old = l2_normalize(centers)
    new = old
    for _ in range(iters):
        new = _lloyd_step(new, f, valid, assign_dtype=assign_dtype)
    if ema > 0.0:
        new = l2_normalize((1.0 - ema) * new + ema * old)
    return new


def bank_write(bank: torch.Tensor, bank_valid: torch.Tensor, step: int,
               f: torch.Tensor, valid: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one step's selected features into slot step % W of the
    step-granular ring bank [W, *sel_shape, E] / [W, *sel_shape]; a smaller
    write (a smaller frame bucket) is zero-padded with valid = 0. Writes
    in place, where the JAX package returns new arrays: a copy of the
    whole ring every step would move its full size (84 MB at config4 with
    32 slots) to change one slot. Returns the two tensors."""
    if f.shape != bank.shape[1:]:
        pads = [(0, b - s) for s, b in zip(f.shape, bank.shape[1:])]
        f = torch.nn.functional.pad(
            f, [p for pair in reversed(pads) for p in pair])
        valid = torch.nn.functional.pad(
            valid, [p for pair in reversed(pads[:valid.dim()]) for p in pair])
    slot = int(step) % bank.shape[0]
    bank[slot] = f.to(bank.dtype)
    bank_valid[slot] = valid.to(bank_valid.dtype)
    return bank, bank_valid


def kmeans_init(generator: torch.Generator, num_clusters: int,
                dim: int) -> torch.Tensor:
    """Random unit-norm initial centers [Kc, dim], drawn on the CPU from
    `generator` (the draws differ from jax.random's for the same seed)."""
    return l2_normalize(torch.randn(num_clusters, dim, generator=generator))
