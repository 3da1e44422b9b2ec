"""Deterministic synthetic YouCook2-style fixtures.

The PyTorch port's own copy of `nafae_tpu/data/synthetic.py` (same seeds,
same files, bit for bit).

Tests and smoke runs use a planted-signal synthetic dataset with the
exact on-disk layout the real pipeline produces (SURVEY.md §5 item 1: "tiny
fixture of ... precomputed region features + boxes (synthesized deterministic
stand-ins)").

Planted signal: every object class c has a fixed random unit direction u_c in
feature space. For each segment, each mentioned word's GT region (one per
frame, at a known slot) has feature `signal*u_c + noise`; distractor regions
are pure noise. A correct model therefore ranks the GT region top-1, and box
accuracy separates trained from untrained models.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _class_directions(num_classes: int, feat_dim: int, seed: int = 1234) -> np.ndarray:
    rng = np.random.RandomState(seed)
    u = rng.randn(num_classes, feat_dim).astype(np.float32)
    return u / np.linalg.norm(u, axis=1, keepdims=True)


def generate_synthetic_dataset(
    root: str,
    split: str = "train",
    num_segments: int = 32,
    num_classes: int = 67,
    feat_dim: int = 2048,
    num_regions: int = 20,
    min_frames: int = 4,
    max_frames: int = 20,
    max_words: int = 4,
    signal: float = 3.0,
    noise: float = 1.0,
    image_size: int = 640,
    seed: int = 0,
    class_pool: int | None = None,
) -> str:
    """Write `root/split/index.jsonl` + per-segment `.npz`. Returns index path.

    class_pool: sample object words from only the first `class_pool` classes so
    each class recurs across segments (needed for learnability on tiny sets —
    with all 67 classes and few segments, ranking can be satisfied by
    memorizing segment-specific noise instead of the planted directions).
    """
    # distinct offset per split — "val" and "test" must not be bit-identical
    split_off = {"train": 0, "val": 10_000, "test": 20_000}
    rng = np.random.RandomState(
        seed + split_off.get(split, 10_000 + sum(map(ord, split))))
    pool = min(class_pool or num_classes, num_classes)
    dirs = _class_directions(num_classes, feat_dim)
    seg_dir = os.path.join(root, split)
    os.makedirs(seg_dir, exist_ok=True)
    index_path = os.path.join(seg_dir, "index.jsonl")
    with open(index_path, "w") as idx:
        for n in range(num_segments):
            t = int(rng.randint(min_frames, max_frames + 1))
            # cannot draw more distinct classes than the pool holds
            k = int(rng.randint(1, min(max_words, pool) + 1))
            words = rng.choice(pool, size=k, replace=False).astype(np.int32)
            feats = rng.randn(t, num_regions, feat_dim).astype(np.float32) * noise
            boxes = _random_boxes(rng, (t, num_regions), image_size)
            gt_boxes = np.zeros((k, t, 4), np.float32)
            gt_mask = np.zeros((k, t), np.float32)
            for ki, c in enumerate(words):
                # GT region slot varies per frame; annotate ~80% of frames
                for ti in range(t):
                    slot = int(rng.randint(num_regions))
                    feats[ti, slot] += signal * dirs[c]
                    if rng.rand() < 0.8:
                        gt_boxes[ki, ti] = boxes[ti, slot]
                        gt_mask[ki, ti] = 1.0
            name = f"seg_{split}_{n:05d}"
            np.savez(
                os.path.join(seg_dir, name + ".npz"),
                feats=feats.astype(np.float16),       # on-disk f16, like real exports
                boxes=boxes,
                word_ids=words,
                gt_boxes=gt_boxes,
                gt_mask=gt_mask,
            )
            idx.write(json.dumps({
                "id": name, "file": name + ".npz", "num_frames": t,
                "num_words": k, "split": split,
            }) + "\n")
    return index_path


def _random_boxes(rng: np.random.RandomState, shape: tuple, image_size: int
                  ) -> np.ndarray:
    x1 = rng.uniform(0, image_size * 0.7, shape).astype(np.float32)
    y1 = rng.uniform(0, image_size * 0.7, shape).astype(np.float32)
    w = rng.uniform(image_size * 0.1, image_size * 0.3, shape).astype(np.float32)
    h = rng.uniform(image_size * 0.1, image_size * 0.3, shape).astype(np.float32)
    return np.stack([x1, y1, np.minimum(x1 + w, image_size),
                     np.minimum(y1 + h, image_size)], axis=-1)
