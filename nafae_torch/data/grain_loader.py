"""The grain pipeline's batch order without grain (`data.pipeline=grain`).

The port's copy of `nafae_tpu/data/grain_loader.py`. The reference builds
`grain.MapDataset.source(ds).shuffle(seed=seed + epoch).batch(B,
drop_remainder)`; grain imports jax, so the port cannot use it, and keeps
a random-access copy of that order instead:

- grain's `ShuffleMapDataset` maps position i of an epoch to
  `index_shuffle(i, max_index=n-1, seed=(seed + epoch) % 2**32, rounds=4)`,
  its C++ `grain::random::index_shuffle`: a Simon-style Feistel cipher on
  the smallest even block of at least 16 bits holding max_index (halves of
  h bits, round function rotl(y,2) ^ (rotl(y,8) & rotl(y,1))), with
  `rounds` round keys drawn by `std::seed_seq{seed}.generate`, walked
  until the value is at most max_index. `index_shuffle` below is that
  function over a whole epoch in numpy. Like grain's, it is not a
  permutation when max_index is a power of two of 2**16 or more (the block
  then cannot hold max_index);
- with more than one frame bucket the batches are `epoch_batches`' index
  lists, the thread loader's order, as in the reference.

Batches are stacked samples, as the Python packer makes them.
"""

from __future__ import annotations

import math

import numpy as np

from nafae_torch.data.loader import (BatchLoader, epoch_batches,
                                     steps_over_epochs)

_M32 = 0xFFFFFFFF
_ROUNDS = 4             # the rounds ShuffleMapDataset asks index_shuffle for


def seed_seq_generate(seed: int, n: int) -> list[int]:
    """`std::seed_seq{seed}.generate` of n 32-bit words ([rand.util.seedseq]
    of the C++ standard)."""
    v = [seed & _M32]
    s = len(v)
    b = [0x8B8B8B8B] * n
    if n == 0:
        return b
    t = (11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7
         else (n - 1) // 2)
    p = (n - t) // 2
    q = p + t

    def mix(x):
        return x ^ (x >> 27)

    for k in range(max(s + 1, n)):
        r1 = 1664525 * mix(b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n]) & _M32
        r2 = r1 + (s if k == 0 else k % n + v[k - 1] if k <= s else k % n)
        r2 &= _M32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _M32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _M32
        b[k % n] = r2
    m = max(s + 1, n)
    for k in range(m, m + n):
        r3 = 1566083941 * mix((b[k % n] + b[(k + p) % n] + b[(k - 1) % n])
                              & _M32) & _M32
        r4 = (r3 - k % n) & _M32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def index_shuffle(n: int, seed: int) -> np.ndarray:
    """[index_shuffle(i, max_index=n-1, seed, rounds=_ROUNDS) for i in
    range(n)], grain's values bit for bit (int64)."""
    if n <= 1:
        return np.zeros(max(n, 0), np.int64)
    max_index = n - 1
    block = math.ceil(math.log2(max_index))
    block = max(block + block % 2, 16)
    h = block // 2
    mask = np.uint64((1 << h) - 1)
    keys = [np.uint64(k) & mask for k in seed_seq_generate(seed, _ROUNDS)]

    def rotl(y, s):
        return ((y >> np.uint64(h - s)) | (y << np.uint64(s))) & mask

    def f(y):
        return rotl(y, 2) ^ (rotl(y, 8) & rotl(y, 1))

    def encrypt(v):
        x, y = (v >> np.uint64(h)) & mask, v & mask
        for i in range(0, len(keys), 2):
            x = x ^ f(y) ^ keys[i]
            y = y ^ f(x) ^ keys[i + 1]
        return (x << np.uint64(h)) | y

    top = np.uint64(max_index)
    if block > 20:      # n > 2**19: a walk takes under 4 steps on average
        out = np.arange(n, dtype=np.uint64)
        todo = np.ones(n, bool)
        while todo.any():                    # cycle walking
            out[todo] = encrypt(out[todo])
            todo = out > top
        return out.astype(np.int64)
    # a small n walks far (2**16 / n steps on average): walk the whole
    # block's table by pointer jumping instead. to[x] is a point of the
    # walk from x, the first one <= max_index once it is one; jumping from
    # to[x] > max_index to to[to[x]] doubles the stride and skips only
    # points > max_index.
    to = encrypt(np.arange(1 << block, dtype=np.uint64)).astype(np.int64)
    start = np.arange(n) % (1 << block)   # grain keeps the block's bits
    while (to[start] > max_index).any():
        to = np.where(to > max_index, to[to], to)
    return to[start]


class GrainLoader:
    """The reference's GrainLoader order (shuffled, the last partial batch
    dropped), with BatchLoader's interface (`epoch(n, skip)`, `steps(...)`,
    `batches_per_epoch()`); batches are built on demand, one at a time."""

    def __init__(self, dataset, batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed

    def _index_lists(self, epoch: int) -> list:
        buckets = getattr(self.dataset, "frame_buckets", None)
        if buckets and len(buckets) > 1:
            return epoch_batches(self.dataset, self.batch_size, True,
                                 self.seed, True, epoch)
        n, bsz = len(self.dataset), self.batch_size
        seed = self.seed + epoch
        if not 0 <= seed < 2 ** 32:
            raise ValueError(f"seed {seed}: grain takes 0 <= seed < 2**32")
        order = index_shuffle(n, seed)
        return [order[b * bsz:(b + 1) * bsz] for b in range(n // bsz)]

    def batches_per_epoch(self) -> int:
        return len(self._index_lists(0))

    def epoch(self, epoch: int = 0, skip: int = 0):
        for idxs in self._index_lists(epoch)[skip:]:
            samples = [self.dataset[int(i)] for i in idxs]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def __iter__(self):
        return self.epoch(0)

    def steps(self, num_steps: int, start_epoch: int = 0, skip: int = 0):
        """See loader.steps_over_epochs (mid-epoch resume included)."""
        return steps_over_epochs(self, num_steps, start_epoch, skip)


def make_loader(cfg_data, dataset, seed: int = 0, pipeline: str = "thread"):
    """"grain" -> GrainLoader; otherwise the thread loader, packing with
    the C++ packer when data.use_native_io is on."""
    if pipeline == "grain":
        return GrainLoader(dataset, cfg_data.batch_size, seed=seed)
    return BatchLoader(dataset, cfg_data.batch_size, shuffle=True, seed=seed,
                       prefetch=cfg_data.prefetch,
                       use_native=cfg_data.use_native_io)
