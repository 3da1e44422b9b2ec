"""Parsers of the YouCook2, YouCook2-BoundingBox and RoboWatch annotation
files (the port of `nafae_tpu/data/annotations.py`; pure numpy over the
port's own `data/vocab.Vocab`).

* youcookii_annotations_trainval.json (YouCook2 release):
    {"database": {video_id: {"duration": float, "subset": "training"|...,
        "annotations": [{"id": int, "segment": [start,end], "sentence": str}]}}}
  -> the extract CLI's segment dicts (`nafae_torch.extract`).

* yc2_bb annotations (YouCook2-BoundingBox release, val/test only):
    {"database": {video_id: {"rwidth": int, "rheight": int,
        "segments": {seg_id: {"objects": [{"label": str,
            "boxes": [{"x1","y1","x2","y2","outside","occluded"} per frame]}]}}}}}
  -> per-segment ground truth merged into extracted .npz feature files.

* RoboWatch transfer annotations: box annotations over RoboWatch videos
  for cross-dataset transfer eval (config 5). Both the YC2-BB-style
  "database" wrapper and a bare {video: ...} mapping are accepted, and a
  video without a "segments" dict is one whole-video segment.

The parsers are lenient by default (a missing key skips rather than
raises). strict=True (the extract CLI's --strict) raises SchemaError on an
unknown or missing field instead: run the official files through strict
mode once to see schema drift before trusting a lenient pass.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nafae_torch.data.vocab import Vocab

_SUBSET_TO_SPLIT = {"training": "train", "validation": "val", "testing": "test"}


class SchemaError(ValueError):
    """Strict-mode schema violation: a missing/unknown field that the
    lenient default would silently skip. Strict mode exists so that
    when the REAL release files arrive, schema drift from these reconstructed
    parsers fails loudly instead of quietly dropping segments/GT tracks."""


def _is_span(seg) -> bool:
    """True iff seg is a [start, end] pair. isinstance-gated: a scalar or a
    2-char string also survives a bare len()==2 check (or TypeErrors out of
    it) — strict mode must raise SchemaError, not TypeError, on those."""
    return isinstance(seg, (list, tuple)) and len(seg) == 2


def segments_from_youcook2(ann_path: str, video_dir: str,
                           ext: str = ".mp4",
                           subset: str | None = None,
                           strict: bool = False) -> list[dict]:
    """YouCook2 annotations -> extract-CLI segment list.

    strict: every video must carry a known "subset" and an "annotations"
    list; every annotation must have "id", "sentence", and a 2-element
    "segment" — SchemaError otherwise (lenient default: fall back / skip).
    """
    with open(ann_path) as f:
        db = json.load(f)["database"]
    out = []
    for vid, meta in sorted(db.items()):
        if strict and meta.get("subset") not in _SUBSET_TO_SPLIT:
            raise SchemaError(f"{vid}: subset {meta.get('subset')!r} not in "
                              f"{sorted(_SUBSET_TO_SPLIT)}")
        split = _SUBSET_TO_SPLIT.get(meta.get("subset", ""), "train")
        if subset and split != subset:
            continue
        if strict and not isinstance(meta.get("annotations"), list):
            raise SchemaError(f"{vid}: missing 'annotations' list")
        video = os.path.join(video_dir, vid + ext)
        for ann in meta.get("annotations", []):
            if strict:
                missing = {"id", "segment", "sentence"} - set(ann)
                if missing:
                    raise SchemaError(f"{vid}: annotation missing "
                                      f"{sorted(missing)}: {ann}")
                if not _is_span(ann["segment"]):
                    raise SchemaError(f"{vid}: segment {ann['segment']!r} "
                                      "is not [start, end]")
            seg = ann.get("segment", [None, None])
            if not _is_span(seg):      # lenient: malformed span -> whole video
                seg = [None, None]
            out.append({
                "id": f"{vid}_{ann.get('id', len(out))}",
                "video": video,
                "sentence": ann.get("sentence", ""),
                "split": split,
                "start": seg[0],
                "end": seg[1],
            })
    return out


def gt_from_youcook2bb(bb_path: str, vocab: Vocab | None = None,
                       max_words: int = 8, max_frames: int = 20,
                       strict: bool = False) -> dict:
    """YouCook2-BB annotations -> {segment_id: {gt_boxes, gt_mask, word_ids}}.

    gt_boxes [K, T, 4] xyxy NORMALIZED to [0,1] via the release's annotation
    resolution (per-video rwidth/rheight) when present — predicted boxes live
    in the detector's square image_size space, so the two coordinate systems
    must be reconciled before IoU (merge_gt_into_features rescales by the
    extraction image size). Without rwidth/rheight the raw coordinates are
    kept and "normalized" is False. gt_mask [K, T] = 1 where the object is
    visible (not outside) and a box exists; word_ids [K] from the 67-class
    vocab (unknown labels skipped). Multiple instances of one class occupy
    separate K slots (per-annotation-track protocol).

    strict: rwidth/rheight, "segments", and per-segment "objects" must be
    present; unknown labels, track overflow past max_words, and malformed
    box entries raise SchemaError instead of being skipped.
    """
    vocab = vocab or Vocab()
    with open(bb_path) as f:
        db = json.load(f)["database"]
    out = {}
    for vid, meta in sorted(db.items()):
        scale = _resolution_scale(meta)
        if strict and scale is None:
            raise SchemaError(f"{vid}: missing rwidth/rheight (annotation "
                              "resolution) — GT cannot be normalized")
        if strict and not isinstance(meta.get("segments"), dict):
            raise SchemaError(f"{vid}: missing 'segments' dict")
        for seg_id, seg in sorted(meta.get("segments", {}).items()):
            where = f"{vid}/segments/{seg_id}"
            if strict and not seg.get("objects"):
                raise SchemaError(f"{where}: missing/empty 'objects'")
            g = _objects_gt(seg.get("objects", []), vocab, max_words,
                            max_frames, scale, strict=strict, where=where)
            if g is not None:
                out[f"{vid}_{seg_id}"] = g
    return out


def _resolution_scale(meta: dict) -> np.ndarray | None:
    """Per-video [w,h,w,h] normalizer from the annotation resolution."""
    rw = float(meta.get("rwidth", 0) or 0)
    rh = float(meta.get("rheight", 0) or 0)
    return (np.asarray([rw, rh, rw, rh], np.float32)
            if rw > 0 and rh > 0 else None)


def _objects_gt(objects: list, vocab: Vocab, max_words: int, max_frames: int,
                scale: np.ndarray | None, strict: bool = False,
                where: str = "") -> dict | None:
    """Object tracks -> {gt_boxes, gt_mask, word_ids, normalized} or None.

    Shared by the YC2-BB and RoboWatch parsers (identical per-track layout).
    Boxes may be {'x1','y1','x2','y2','outside'} dicts or bare
    [x1,y1,x2,y2(,outside)] lists (lenient across release variants). strict:
    unknown labels, overflow past max_words (a silently-dropped GT track
    would distort eval), and malformed box entries raise SchemaError.
    """
    gt_boxes = np.zeros((max_words, max_frames, 4), np.float32)
    gt_mask = np.zeros((max_words, max_frames), np.float32)
    word_ids = []
    for obj in objects:
        cls = vocab.lookup(str(obj.get("label", "")))
        if cls is None:
            if strict:
                raise SchemaError(f"{where}: unknown label "
                                  f"{obj.get('label')!r} (not in the vocab; "
                                  "check data.classes_file)")
            continue
        if len(word_ids) >= max_words:
            if strict:
                raise SchemaError(f"{where}: more than max_words={max_words} "
                                  "object tracks — raise data.max_words")
            continue
        k = len(word_ids)
        word_ids.append(cls)
        for t, box in enumerate(obj.get("boxes", [])[:max_frames]):
            coords = _box_coords(box, strict=strict,
                                 where=f"{where}/{obj.get('label')}[{t}]")
            if coords is None:
                continue
            gt_boxes[k, t] = coords
            gt_mask[k, t] = 1.0
    if not word_ids:
        return None
    if scale is not None:
        gt_boxes = gt_boxes / scale
    return {"gt_boxes": gt_boxes, "gt_mask": gt_mask,
            "word_ids": np.asarray(word_ids, np.int32),
            "normalized": scale is not None}


def _box_coords(box, strict: bool = False, where: str = "") -> tuple | None:
    """One per-frame box entry -> (x1,y1,x2,y2) or None (absent/outside).

    strict: a PRESENT but malformed entry (not a dict/4-list, or a visible
    dict missing a coordinate) raises SchemaError; empty/outside stays None
    (a legitimately absent box, not schema drift).
    """
    if not box:
        return None
    if isinstance(box, dict):
        if box.get("outside", 0):
            return None
        coords = (box.get("x1"), box.get("y1"), box.get("x2"), box.get("y2"))
    elif isinstance(box, (list, tuple)) and len(box) >= 4:
        if len(box) >= 5 and box[4]:          # trailing outside flag
            return None
        coords = tuple(box[:4])
    else:
        if strict:
            raise SchemaError(f"{where}: malformed box entry {box!r}")
        return None
    if None in coords:
        if strict:
            raise SchemaError(f"{where}: box missing coordinates {box!r}")
        return None
    return coords


def segments_from_robowatch(ann_path: str, video_dir: str,
                            ext: str = ".mp4",
                            strict: bool = False) -> list[dict]:
    """RoboWatch transfer annotations -> extract-CLI segment list (eval-only).

    The NAFAE authors annotated a RoboWatch subset with boxes for
    cross-dataset transfer (config 5). Schema handled leniently: an optional
    "database" wrapper, per-video optional "segments" (otherwise the whole
    video is one segment), optional "segment"/"sentence" keys. Without a
    sentence the object labels are joined so word extraction still yields
    the annotated classes. All segments land in the "val" split.

    strict: each segment must carry a sentence or a non-empty object list
    (else word extraction yields nothing and the segment silently evals as
    empty), and a present "segment" span must be [start, end].
    """
    with open(ann_path) as f:
        raw = json.load(f)
    db = raw.get("database", raw)
    out = []
    for vid, meta in sorted(db.items()):
        segments = meta.get("segments") or {"0": meta}
        if not isinstance(segments, dict):   # e.g. a list release variant
            segments = {str(i): s for i, s in enumerate(segments)}
        for seg_id, seg in sorted(segments.items()):
            # `or` (not a .get default): a present-but-null "segment" must
            # also fall back, per the lenient-parsing contract
            span = seg.get("segment") or [None, None]
            if not strict and not _is_span(span):   # lenient: malformed ->
                span = [None, None]                 # whole video
            sentence = seg.get("sentence") or " ".join(
                str(o.get("label", "")) for o in seg.get("objects") or [])
            if strict:
                if not sentence.strip():
                    raise SchemaError(f"{vid}/{seg_id}: no 'sentence' and no "
                                      "object labels — nothing to ground")
                if not _is_span(span):
                    raise SchemaError(f"{vid}/{seg_id}: segment {span!r} is "
                                      "not [start, end]")
            out.append({
                "id": f"{vid}_{seg_id}",
                "video": os.path.join(video_dir, vid + ext),
                "sentence": sentence,
                "split": "val",
                "start": span[0],
                "end": span[1],
            })
    return out


def gt_from_robowatch(ann_path: str, vocab: Vocab | None = None,
                      max_words: int = 8, max_frames: int = 20,
                      strict: bool = False) -> dict:
    """RoboWatch transfer annotations -> GT dict (gt_from_youcook2bb contract).

    Same per-track tensor layout as YC2-BB; accepts the "database" wrapper or
    a bare mapping, per-video "segments" or a flat whole-video object list,
    and dict- or list-form boxes. Merge with merge_gt_into_features. strict:
    segments without objects, unknown labels, track overflow, and malformed
    boxes raise SchemaError (the structural wrapper variants stay accepted —
    they ARE the schema, per the authors'-release docs).
    """
    vocab = vocab or Vocab()
    with open(ann_path) as f:
        raw = json.load(f)
    db = raw.get("database", raw)
    out = {}
    for vid, meta in sorted(db.items()):
        scale = _resolution_scale(meta)
        segments = meta.get("segments") or {"0": meta}
        for seg_id, seg in sorted(segments.items()):
            where = f"{vid}/{seg_id}"
            if strict and not seg.get("objects"):
                raise SchemaError(f"{where}: missing/empty 'objects'")
            g = _objects_gt(seg.get("objects", []), vocab, max_words,
                            max_frames, scale, strict=strict, where=where)
            if g is not None:
                out[f"{vid}_{seg_id}"] = g
    return out


def merge_gt_into_features(feature_dir: str, gt: dict,
                           image_size: int | None = None) -> int:
    """Write GT tensors into extracted .npz segment files (in place).

    Matches by segment id; also overwrites word_ids with the BB labels so
    eval classes == annotation classes. Normalized GT boxes (see
    gt_from_youcook2bb) require image_size — the extraction frame size — to
    rescale into the prediction coordinate space (the extract CLI passes
    cfg.detector.image_size). Returns #segments updated. The index.jsonl is
    untouched (same files, new keys)."""
    index_path = os.path.join(feature_dir, "index.jsonl")
    with open(index_path) as f:
        index = [json.loads(ln) for ln in f if ln.strip()]
    updated = 0
    for meta in index:
        g = gt.get(meta["id"])
        if g is None:
            continue
        path = os.path.join(feature_dir, meta["file"])
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
        t = data["feats"].shape[0]
        k = len(g["word_ids"])
        boxes = g["gt_boxes"][:k]
        if g.get("normalized"):
            if not image_size:
                # inferring the frame size from predicted-box extents is
                # silently wrong (zero/under-reach collapses or shrinks GT)
                raise ValueError(
                    "merge_gt_into_features: GT boxes are normalized "
                    "(annotation rwidth/rheight present) — pass image_size "
                    "(the extraction detector.image_size)")
            boxes = boxes * float(image_size)
        data["word_ids"] = g["word_ids"]
        data["gt_boxes"] = _fit(boxes, (k, t, 4))
        data["gt_mask"] = _fit(g["gt_mask"][:k], (k, t))
        np.savez(path, **data)
        updated += 1
    return updated


def _fit(arr: np.ndarray, shape: tuple) -> np.ndarray:
    """Crop/zero-pad arr to `shape`."""
    out = np.zeros(shape, arr.dtype)
    sl = tuple(slice(0, min(a, b)) for a, b in zip(arr.shape, shape))
    out[sl] = arr[sl]
    return out
