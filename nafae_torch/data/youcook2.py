"""Segment padding: one ragged segment -> fixed [T,R,D]/[K] buckets + masks.

The port's copy of `pad_sample` from `nafae_tpu/data/youcook2.py`; the
serving path pads every request segment with it, exactly as the JAX
server does. All arrays are numpy; device transfer happens in the caller.
"""

from __future__ import annotations

import numpy as np


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
