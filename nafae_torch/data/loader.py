"""Batch loader: bucketing, seeded shuffling, background prefetch.

The port's copy of `nafae_tpu/data/loader.py`: the same
`np.random.RandomState(seed + epoch)` order, so both packages see the same
batches. Batches are dicts of numpy arrays with one [T,R,D] bucket each;
device transfer happens in the caller. `use_native=True` packs them with
the C++ packer (`utils/native_io.NativePacker`, bit for bit the Python
packer's batches), except where it cannot: video datasets, transfer dtypes
it cannot emit and int8 passthrough; a packer that cannot be built warns
and the Python packer takes over.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


def steps_over_epochs(loader, num_steps: int, start_epoch: int = 0,
                      skip: int = 0):
    """Yield exactly num_steps (i, batch) pairs, cycling loader.epoch(n).
    `skip` resumes mid-epoch: the first `skip` batches of `start_epoch` are
    skipped without being built."""
    done, epoch = 0, start_epoch
    while done < num_steps:
        made = 0
        for batch in loader.epoch(epoch, skip=skip):
            yield done, batch
            done += 1
            made += 1
            if done >= num_steps:
                return
        if made == 0 and skip == 0:
            raise ValueError(
                "epoch produced no batches: the dataset is smaller than one "
                "batch (drop_remainder) or every bucket is empty — shrink "
                "data.batch_size or add data")
        skip = 0
        epoch += 1


def epoch_batches(dataset, batch_size: int, shuffle: bool, seed: int,
                  drop_remainder: bool, epoch: int) -> list:
    """Batch index lists for one epoch; every batch is bucket-homogeneous."""
    def chunk(order):
        nb = (len(order) // batch_size if drop_remainder
              else -(-len(order) // batch_size))
        return [order[b * batch_size:(b + 1) * batch_size]
                for b in range(nb)]

    rng = np.random.RandomState(seed + epoch)
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    buckets = getattr(dataset, "frame_buckets", None)
    if buckets and len(buckets) > 1:
        keys = np.asarray([dataset.bucket_of(int(i)) for i in order])
        batches = []
        for b in buckets:
            batches += chunk(order[keys == b])
        if shuffle:
            rng.shuffle(batches)              # interleave buckets across steps
        return batches
    return chunk(order)


class BatchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_remainder: bool = True,
                 prefetch: int = 2, use_native: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        self._native = None
        # the packer packs feature-file datasets (.npz under dataset.dir)
        # into float batches: video datasets decode frames instead, and the
        # int8 passthrough (keep_int8) keeps its int8 feats
        if (use_native and hasattr(dataset, "dir")
                and str(getattr(dataset, "transfer_dtype", "float32"))
                in ("float32", "float16", "bfloat16")
                and not getattr(dataset, "keep_int8", False)):
            try:
                from nafae_torch.utils.native_io import NativePacker
                self._native = NativePacker(dataset)
            except Exception as e:
                # the Python packer gives the same batches; say so, since a
                # silent fallback reads as the packer engaged
                import warnings
                warnings.warn(f"native IO packer unavailable, using the "
                              f"Python loader: {type(e).__name__}: {e}")

    def _epoch_batches(self, epoch: int) -> list:
        return epoch_batches(self.dataset, self.batch_size, self.shuffle,
                             self.seed, self.drop_remainder, epoch)

    def _make_batch(self, idxs) -> dict[str, np.ndarray]:
        if self._native is not None:
            return self._native.pack(idxs)
        samples = [self.dataset[int(i)] for i in idxs]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def batches_per_epoch(self) -> int:
        """Constant across epochs: shuffling permutes within fixed buckets."""
        return len(self._epoch_batches(0))

    def epoch(self, epoch: int = 0, skip: int = 0):
        """Yield batches for one epoch, built ahead by a background thread.
        `skip` drops the first batches before building them. A worker's
        exception re-raises in the consumer."""
        batch_idxs = self._epoch_batches(epoch)[skip:]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_polling(item) -> bool:
            while not stop.is_set():  # never block forever on a full queue
                try:                  # after the consumer left
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            sentinel = None           # normal end of the epoch
            try:
                for idxs in batch_idxs:
                    if stop.is_set():
                        return
                    try:
                        item = self._make_batch(idxs)
                    except BaseException as e:  # propagate to the consumer
                        sentinel = e
                        return
                    if not put_polling(item):
                        return
            finally:
                put_polling(sentinel)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    def __iter__(self):
        return self.epoch(0)

    def steps(self, num_steps: int, start_epoch: int = 0, skip: int = 0):
        """See steps_over_epochs."""
        return steps_over_epochs(self, num_steps, start_epoch, skip)
