"""Video-backed dataset: samples carry raw frames, not precomputed features
(the port of `nafae_tpu/data/video_dataset.py`).

The config-5 inline path: each sample decodes its annotated segment
(`extract.decode_segment`, trimmed to [start, end]) inside the loader's
worker thread, and the training step runs the frozen detector on the
frames (`train.compute_losses(..., extractor=...)`).

Annotations: the segments.jsonl the extract CLI reads:
{"id", "video", "sentence", "start"?, "end"?}.
"""

from __future__ import annotations

import json

import numpy as np

from nafae_torch.data.vocab import Vocab


class VideoSegmentDataset:
    """Random-access segments decoded from video on demand: __len__,
    __getitem__, one frame bucket, and fixed-shape sample dicts with
    "frames" [T,S,S,3] instead of "feats"/"boxes"."""

    def __init__(self, annotations: str | list[dict], max_frames: int,
                 image_size: int, max_words: int, frame_rate: float = 1.0,
                 vocab: Vocab | None = None):
        if isinstance(annotations, str):
            with open(annotations) as f:
                annotations = [json.loads(ln) for ln in f if ln.strip()]
        self.annotations = list(annotations)
        self.max_frames = max_frames
        self.image_size = image_size
        self.max_words = max_words
        self.frame_rate = frame_rate
        self.vocab = vocab or Vocab()
        self.frame_buckets = (max_frames,)

    def __len__(self) -> int:
        return len(self.annotations)

    def bucket_of(self, i: int) -> int:
        return self.max_frames

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        from nafae_torch.extract import decode_segment
        ann = self.annotations[i]
        frames = decode_segment(ann["video"], self.frame_rate,
                                self.max_frames, self.image_size,
                                start=float(ann.get("start") or 0.0),
                                end=float(ann.get("end") or -1.0))
        t = frames.shape[0]
        if t == 0:
            # training on an all-zero sample would inject junk gradients
            raise IOError(
                f"segment {ann.get('id', i)!r} decoded 0 frames from "
                f"{ann['video']!r} (start={ann.get('start')}, "
                f"end={ann.get('end')}); fix or drop the annotation")
        out = np.zeros((self.max_frames, self.image_size, self.image_size, 3),
                       np.float32)
        out[:t] = frames[:self.max_frames]
        fm = np.zeros((self.max_frames,), np.float32)
        fm[:min(t, self.max_frames)] = 1.0
        word_ids = np.asarray(self.vocab.extract(ann["sentence"],
                                                 self.max_words), np.int32)
        k = min(len(word_ids), self.max_words)
        wids = np.zeros((self.max_words,), np.int32)
        wids[:k] = word_ids[:k]
        wm = np.zeros((self.max_words,), np.float32)
        wm[:k] = 1.0
        return {"frames": out, "word_ids": wids, "frame_mask": fm,
                "word_mask": wm, "segment_id": np.int32(i)}
