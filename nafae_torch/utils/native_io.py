"""The C++ batch packer (`csrc/host/packer.cpp`), bound with ctypes.

The port's copy of the packer half of `nafae_tpu/utils/native_io.py`:
`write_nbin` writes one segment in the flat `.nbin` cache format (version
3, byte for byte the reference's, so one `nbin_cache/` serves both
packages), and `NativePacker` packs batches from that cache in C++ worker
threads, bit for bit the batches of the Python packer (`SegmentDataset` +
`np.stack`) in float32, float16 and bfloat16. It plugs into
`data/loader.BatchLoader(use_native=True)`, which `fit` turns on with
`data.use_native_io`. The library is built by g++ at first use
(`ops/kernels/_build.load_host`) into the checkout's `build/`.
Video decoding is not here: the port decodes with `data/avi.py`.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_MAGIC = 0x4E414641
# transfer dtypes the packer can emit (codes of FeatDtype in packer.cpp)
_FEAT_DTYPE_CODES = {"float32": 0, "float16": 1, "bfloat16": 2}
_NUM_THREADS = 2        # C++ workers a handle (the reference's default)

# batches packed in C++ (packer_pack calls that returned a batch)
packs = {"packer_pack": 0}
_lib = None


def load_library() -> ctypes.CDLL:
    """The packer's library, built at first use; raises if it cannot be."""
    global _lib
    if _lib is not None:
        return _lib
    from nafae_torch.ops.kernels._build import load_host

    lib = load_host("packer")
    lib.packer_create2.restype = ctypes.c_void_p
    lib.packer_create2.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 7
    fptr = ctypes.POINTER(ctypes.c_float)
    lib.packer_pack.restype = ctypes.c_int
    lib.packer_pack.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                                ctypes.c_void_p, fptr,
                                ctypes.POINTER(ctypes.c_int32),
                                fptr, fptr, fptr, fptr, fptr]
    lib.packer_num_segments.restype = ctypes.c_int
    lib.packer_num_segments.argtypes = [ctypes.c_void_p]
    lib.packer_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _replace_atomically(path: str, write) -> None:
    """write(f) into a temporary file of this process and thread, then
    rename it onto `path`: a reader (or another writer) never sees half a
    file, and a process killed mid-write leaves no truncated file behind."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def write_nbin(path: str, feats: np.ndarray, boxes: np.ndarray,
               word_ids: np.ndarray, gt_boxes: np.ndarray | None = None,
               gt_mask: np.ndarray | None = None,
               region_mask: np.ndarray | None = None) -> None:
    """Writes one segment in the `.nbin` format (version 3: the optional
    region-mask block after word_ids, then the optional GT block)."""
    t, r, d = feats.shape
    k = len(word_ids)
    if (gt_boxes is None) != (gt_mask is None):
        raise ValueError("write_nbin: gt_boxes and gt_mask must be given "
                         "together (got exactly one)")
    with_gt = gt_boxes is not None

    def write(f):
        np.asarray([_MAGIC, 3, t, r, d, k], np.int32).tofile(f)
        feats.astype(np.float32).tofile(f)
        boxes.astype(np.float32).tofile(f)
        word_ids.astype(np.int32).tofile(f)
        np.asarray([1 if region_mask is not None else 0], np.int32).tofile(f)
        if region_mask is not None:
            region_mask.astype(np.float32).tofile(f)
        np.asarray([1 if with_gt else 0], np.int32).tofile(f)
        if with_gt:
            gt_boxes.astype(np.float32).tofile(f)
            gt_mask.astype(np.float32).tofile(f)

    _replace_atomically(path, write)


class NativePacker:
    """C++ threaded batch packer over the `.nbin` cache of `dataset` (a
    `SegmentDataset`).

    The cache is written next to the `.npz` files on first use
    (`<split>/nbin_cache/<id>.nbin`, rewritten when its `.npz` is newer)
    and is always float32; `dataset.transfer_dtype` (float16 and bfloat16
    halve the copy to the card) is converted at pack time in the workers.
    int8 feature files are cached dequantized, as the Python packer reads
    them. One C++ handle a frame bucket: every batch is bucket-homogeneous
    (`epoch_batches`), and the handle pads to its bucket's T."""

    def __init__(self, dataset):
        if not hasattr(dataset, "dir"):
            raise TypeError(
                f"NativePacker packs feature-file datasets (needs "
                f"`dataset.dir` holding the .npz features); got "
                f"{type(dataset).__name__}")
        self.ds = dataset
        self._feat_dtype = np.dtype(getattr(dataset, "transfer_dtype",
                                            "float32"))
        self._feat_code = _FEAT_DTYPE_CODES.get(str(self._feat_dtype))
        if self._feat_code is None:
            raise ValueError(f"native packer cannot emit transfer_dtype="
                             f"{self._feat_dtype} (supported: "
                             f"{sorted(_FEAT_DTYPE_CODES)})")
        lib = load_library()
        cache_dir = os.path.join(dataset.dir, "nbin_cache")
        os.makedirs(cache_dir, exist_ok=True)
        paths = []
        for meta in dataset.index:
            src = os.path.join(dataset.dir, meta["file"])
            dst = os.path.join(cache_dir, meta["id"] + ".nbin")
            if not os.path.exists(dst) or (os.path.getmtime(dst)
                                           < os.path.getmtime(src)):
                _cache_segment(src, dst, dataset.with_gt)
            paths.append(dst)
        self._manifest = os.path.join(cache_dir, "manifest.txt")
        text = ("\n".join(paths) + "\n").encode()
        _replace_atomically(self._manifest, lambda f: f.write(text))
        self._lib = lib
        # a single bucket may be smaller than max_frames
        self._buckets = tuple(getattr(dataset, "frame_buckets", ()) or ()) \
            or (dataset.max_frames,)
        self._handles: dict[int, int] = {}
        # the C++ handle keeps each call's output pointers: one pack at a
        # time (an abandoned epoch's prefetch thread may overlap a new one's)
        self._pack_lock = threading.Lock()
        self._handle(self._buckets[-1])       # fail here, not mid-epoch

    def _handle(self, t: int):
        h = self._handles.get(t)
        if h is None:
            ds = self.ds
            h = self._lib.packer_create2(
                self._manifest.encode(), t, ds.num_regions, ds.feat_dim,
                ds.max_words, 1 if ds.with_gt else 0, _NUM_THREADS,
                self._feat_code)
            if not h:
                raise RuntimeError("packer_create2 failed")
            self._handles[t] = h
        return h

    def _batch_t(self, idxs) -> int:
        """The frame bucket of a bucket-homogeneous batch."""
        if len(self._buckets) == 1:
            return self._buckets[0]
        ts = {self.ds.bucket_of(int(i)) for i in idxs}
        if len(ts) != 1:
            raise ValueError(
                f"native pack() needs a bucket-homogeneous batch; got "
                f"buckets {sorted(ts)} (epoch_batches never mixes buckets)")
        return ts.pop()

    def pack(self, idxs) -> dict[str, np.ndarray]:
        """The batch of segments `idxs`, as the Python packer gives it."""
        with self._pack_lock:
            return self._pack_locked(idxs)

    def _pack_locked(self, idxs) -> dict[str, np.ndarray]:
        ds = self.ds
        n = len(idxs)
        t, r, d, k = (self._batch_t(idxs), ds.num_regions, ds.feat_dim,
                      ds.max_words)
        feats = np.empty((n, t, r, d), self._feat_dtype)
        boxes = np.empty((n, t, r, 4), np.float32)
        word_ids = np.empty((n, k), np.int32)
        frame_mask = np.empty((n, t), np.float32)
        word_mask = np.empty((n, k), np.float32)
        region_mask = np.empty((n, t, r), np.float32)
        gt_boxes = np.empty((n, k, t, 4), np.float32) if ds.with_gt else None
        gt_mask = np.empty((n, k, t), np.float32) if ds.with_gt else None
        idx_arr = np.ascontiguousarray(idxs, dtype=np.int32)
        fptr = ctypes.POINTER(ctypes.c_float)

        def ptr(a):
            return None if a is None else a.ctypes.data_as(fptr)

        rc = self._lib.packer_pack(
            self._handle(t),
            idx_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
            ctypes.c_void_p(feats.ctypes.data), ptr(boxes),
            word_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ptr(frame_mask), ptr(word_mask), ptr(region_mask), ptr(gt_boxes),
            ptr(gt_mask))
        if rc != 0:
            raise IOError(f"packer_pack failed rc={rc}")
        packs["packer_pack"] += 1
        batch = {"feats": feats, "boxes": boxes, "word_ids": word_ids,
                 "frame_mask": frame_mask, "word_mask": word_mask,
                 "region_mask": region_mask, "segment_id": idx_arr.copy()}
        if ds.with_gt:
            batch["gt_boxes"] = gt_boxes
            batch["gt_mask"] = gt_mask
        return batch

    def __del__(self):
        try:
            for h in getattr(self, "_handles", {}).values():
                self._lib.packer_destroy(h)
        except Exception:
            pass


def _cache_segment(src: str, dst: str, with_gt: bool) -> None:
    """Writes the `.nbin` of one `.npz` segment file."""
    with np.load(src) as z:
        if with_gt and "gt_boxes" not in z:
            # the Python packer raises KeyError here; all-zero gt_mask
            # would drop the segment from eval's denominator
            raise KeyError(f"{src}: with_gt=True but no gt_boxes — merge "
                           "the ground truth into the features (or drop "
                           "with_gt)")
        raw = z["feats"]
        f = raw.astype(np.float32)
        if raw.dtype == np.int8 and "feats_scale" in z.files:
            # dequantized by the Python packer's own expression
            f = f * z["feats_scale"][..., None]
        write_nbin(dst, f, z["boxes"], z["word_ids"],
                   z["gt_boxes"] if "gt_boxes" in z else None,
                   z["gt_mask"] if "gt_mask" in z else None,
                   z["region_mask"] if "region_mask" in z else None)
