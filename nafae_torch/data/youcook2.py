"""YouCook2 segment dataset: per-segment feature files -> padded samples.

The port's copy of `nafae_tpu/data/youcook2.py`: `SegmentDataset` reads the
same index and `.npz` files and pads them with `pad_sample` (which the
serving path also uses on every request segment). All arrays are numpy;
device transfer happens in the caller.

On-disk layout (written by the JAX package's extractor or by
`data/synthetic.py`):
  root/split/index.jsonl   — one JSON per segment: id, file, num_frames, num_words
  root/split/<id>.npz      — feats [T,R,D] (f16/f32, or int8 + feats_scale
                             [T,R]), boxes [T,R,4], word_ids [K],
                             gt_boxes [K,T,4], gt_mask [K,T] (eval),
                             region_mask [T,R] (optional)
int8 feature files are dequantized on load, so one extraction serves
training and f32 eval; `keep_int8=True` (model.quantize=int8pre) passes
the int8 feats and their scales through instead, so that the device reads
a quarter of the feature bytes and projects them with an int8 product.
"""

from __future__ import annotations

import json
import os

import numpy as np


class SegmentDataset:
    def __init__(self, root: str, split: str, max_frames: int, num_regions: int,
                 feat_dim: int, max_words: int, with_gt: bool = False,
                 frame_buckets: tuple = (), transfer_dtype: str = "float32",
                 keep_int8: bool = False):
        self.transfer_dtype = np.dtype(transfer_dtype)
        self.keep_int8 = keep_int8
        self.dir = os.path.join(root, split)
        self.max_frames = max_frames
        # ascending UNIQUE bucket sizes; () = single bucket at max_frames
        self.frame_buckets = tuple(sorted({b for b in frame_buckets
                                           if b <= max_frames})) or (max_frames,)
        self.num_regions = num_regions
        self.feat_dim = feat_dim
        self.max_words = max_words
        self.with_gt = with_gt
        with open(os.path.join(self.dir, "index.jsonl")) as f:
            self.index = [json.loads(ln) for ln in f if ln.strip()]

    def __len__(self) -> int:
        return len(self.index)

    def bucket_of(self, i: int) -> int:
        """Smallest bucket T that fits segment i (last bucket if none do)."""
        t = self.index[i].get("num_frames", self.max_frames)
        for b in self.frame_buckets:
            if t <= b:
                return b
        return self.frame_buckets[-1]

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        meta = self.index[i]
        with np.load(os.path.join(self.dir, meta["file"])) as z:
            fz, fscale = z["feats"], None
            if fz.dtype == np.int8 and "feats_scale" in z.files:
                if self.keep_int8:
                    feats = fz
                    fscale = z["feats_scale"].astype(np.float32)
                else:
                    feats = (fz.astype(np.float32)
                             * z["feats_scale"][..., None]
                             ).astype(self.transfer_dtype)
            else:
                if self.keep_int8:
                    raise ValueError(
                        f"{meta['file']}: keep_int8 (model.quantize=int8pre)"
                        " needs int8 feature files — re-extract with "
                        "`nafae_torch.extract --quantize int8`")
                feats = fz.astype(self.transfer_dtype)
            sample = pad_sample(
                feats=feats,
                feats_scale=fscale,
                boxes=z["boxes"].astype(np.float32),
                word_ids=z["word_ids"].astype(np.int32),
                max_frames=self.bucket_of(i),
                num_regions=self.num_regions,
                max_words=self.max_words,
                gt_boxes=z["gt_boxes"].astype(np.float32) if self.with_gt else None,
                gt_mask=z["gt_mask"].astype(np.float32) if self.with_gt else None,
                region_mask=(z["region_mask"].astype(np.float32)
                             if "region_mask" in z.files else None),
            )
        sample["segment_id"] = np.int32(i)
        return sample


def pad_sample(feats: np.ndarray, boxes: np.ndarray, word_ids: np.ndarray,
               max_frames: int, num_regions: int, max_words: int,
               gt_boxes: np.ndarray | None = None,
               gt_mask: np.ndarray | None = None,
               region_mask: np.ndarray | None = None,
               feats_scale: np.ndarray | None = None) -> dict[str, np.ndarray]:
    """Pad/truncate one segment to fixed [T,R,D]/[K] buckets with masks.

    feats_scale [T,R] (int8pre path only): padded slots get scale 0, which
    dequantizes padded regions to exactly the zero vector the f32 path
    pads with. The key is emitted ONLY when given, so the batch keys of
    the standard path are unchanged."""
    t, r, d = feats.shape
    tt, rr = min(t, max_frames), min(r, num_regions)
    k = min(len(word_ids), max_words)

    out_f = np.zeros((max_frames, num_regions, d), feats.dtype)
    out_f[:tt, :rr] = feats[:tt, :rr]
    out_b = np.zeros((max_frames, num_regions, 4), np.float32)
    out_b[:tt, :rr] = boxes[:tt, :rr]
    out_w = np.zeros((max_words,), np.int32)
    out_w[:k] = word_ids[:k]
    fm = np.zeros((max_frames,), np.float32)
    fm[:tt] = 1.0
    wm = np.zeros((max_words,), np.float32)
    wm[:k] = 1.0
    rm = np.zeros((max_frames, num_regions), np.float32)
    rm[:tt, :rr] = region_mask[:tt, :rr] if region_mask is not None else 1.0
    sample = {"feats": out_f, "boxes": out_b, "word_ids": out_w,
              "frame_mask": fm, "word_mask": wm, "region_mask": rm}
    if feats_scale is not None:
        out_s = np.zeros((max_frames, num_regions), np.float32)
        out_s[:tt, :rr] = feats_scale[:tt, :rr]
        sample["feats_scale"] = out_s
    if gt_boxes is not None:
        gb = np.zeros((max_words, max_frames, 4), np.float32)
        gm = np.zeros((max_words, max_frames), np.float32)
        gb[:k, :tt] = gt_boxes[:k, :tt]
        gm[:k, :tt] = gt_mask[:k, :tt]
        sample["gt_boxes"] = gb
        sample["gt_mask"] = gm
    return sample
