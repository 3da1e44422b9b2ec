"""Grounding visualization: the argmax-similarity region of each word.

The port of `nafae_tpu/visualize.py`:

  python -m nafae_torch.visualize --preset config1 \\
      --override data.root=feats --checkpoint ckpt_dir|params.npz \\
      --out viz/ [--no-render] [--device cpu]

* always writes `viz/predictions.jsonl` — one record per (segment, word,
  frame): predicted box + similarity score (+ GT box / IoU / hit when the
  dataset has GT), the JAX package's records;
* renders one PNG per frame under `viz/<segment>/`. Without video access
  the boxes are drawn on a neutral canvas (the feature files carry no
  pixels); --annotations segments.jsonl (the extract CLI's input, id ->
  video path) draws onto the decoded frames.

Green box = hit (IoU > thresh), red = miss, white = no GT; thin gray = GT.
The boxes are drawn with numpy, pixel for pixel as `cv2.rectangle` draws
them, and frames are written as PNG through zlib: the GPU machine has no
cv2. Unlike the reference, the word-and-score label is not drawn on the
frame; it stays in predictions.jsonl.

The predictions run on `device` (cuda unless "cpu" is asked for).
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np
import torch

from nafae_torch.config import Config
from nafae_torch.device import resolve_device
from nafae_torch.models.grounding import params_from_jax
from nafae_torch.ops import grounding as G

# BGR, as the reference draws them with cv2
_COLORS = {"hit": (80, 200, 80), "miss": (60, 60, 230), "nogt": (255, 255, 255)}
_GT_COLOR = (180, 180, 180)


def _iou_np(a, b) -> float:
    """Host-side scalar IoU, same semantics as ops.iou.box_iou (xyxy,
    degenerate boxes -> 0)."""
    lt = np.maximum(a[:2], b[:2])
    rb = np.minimum(a[2:], b[2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = float(wh[0] * wh[1])
    area_a = max(a[2] - a[0], 0.0) * max(a[3] - a[1], 0.0)
    area_b = max(b[2] - b[0], 0.0) * max(b[3] - b[1], 0.0)
    union = float(area_a + area_b - inter)
    return inter / max(union, 1e-12) if union > 0 else 0.0


def predict_segment(params: dict, sample: dict) -> dict:
    """Argmax-region predictions for one padded sample (the eval path's
    argmax), on the device of params' tensors. Returns numpy arrays keyed
    r_star / score [K,T]."""
    dev = params["word_emb"].device

    def put(x, dtype=None):
        return torch.as_tensor(np.asarray(x)[None], dtype=dtype).to(dev)

    with torch.inference_mode():
        w_emb = G.embed_words(put(sample["word_ids"]), params["word_emb"],
                              m_sim=params.get("m_sim"))
        v_emb = G.project_params(params, put(sample["feats"], torch.float32))
        s = G.mask_regions(G.similarity_tensor(w_emb, v_emb),
                           put(sample["region_mask"])
                           if "region_mask" in sample else None)[0]
        r_star = torch.argmax(s, dim=-1)                         # [K,T]
        score = torch.amax(s, dim=-1)
    return {"r_star": r_star.cpu().numpy(), "score": score.cpu().numpy()}


def segment_records(sample: dict, pred: dict, vocab, seg_id: str,
                    iou_thresh: float = 0.5) -> list[dict]:
    """Flatten one segment's predictions into JSONL records."""
    recs = []
    word_ids = sample["word_ids"]
    wm = sample["word_mask"]
    fm = sample["frame_mask"]
    boxes = sample["boxes"]                                      # [T,R,4]
    has_gt = "gt_boxes" in sample
    for k, wid in enumerate(word_ids):
        if wm[k] == 0:
            continue
        rm = sample.get("region_mask")
        for t in range(len(fm)):
            if fm[t] == 0:
                continue
            if rm is not None and not np.any(rm[t] > 0):
                # frame kept zero proposals: the argmax over all-NEG scores
                # would emit a degenerate region-0 [0,0,0,0] box at -1e9
                continue
            r = int(pred["r_star"][k, t])
            rec = {
                "segment": seg_id,
                "word": vocab.classes[int(wid)],
                "frame": t,
                "region": r,
                "box": [round(float(x), 2) for x in boxes[t, r]],
                "score": round(float(pred["score"][k, t]), 4),
            }
            if has_gt and sample["gt_mask"][k, t] > 0:
                gt = sample["gt_boxes"][k, t]
                i = _iou_np(boxes[t, r], gt)
                rec.update(gt_box=[round(float(x), 2) for x in gt],
                           iou=round(i, 4), hit=bool(i > iou_thresh))
            recs.append(rec)
    return recs


def _fill(img: np.ndarray, x0: int, x1: int, y0: int, y1: int,
          color) -> None:
    """Paint the pixels x0..x1, y0..y1 (inclusive, clipped to img)."""
    h, w = img.shape[:2]
    xa, xb = max(x0, 0), min(x1, w - 1)
    ya, yb = max(y0, 0), min(y1, h - 1)
    if xa <= xb and ya <= yb:
        img[ya:yb + 1, xa:xb + 1] = color


def draw_rectangle(img: np.ndarray, p0: tuple[int, int],
                   p1: tuple[int, int], color, thickness: int = 1) -> None:
    """The outline `cv2.rectangle(img, p0, p1, color, thickness)` draws
    with its default 8-connected lines, for thickness 1 or 2, in place:
    each edge a band of `thickness - 1` pixels either side of it, the
    horizontal bands from x0 to x1 and the vertical ones from y0 to y1
    (so a thickness-2 outline has its outer corner pixels cut off, as
    cv2's round caps leave them), clipped to the image."""
    if thickness not in (1, 2):
        raise ValueError(f"draw_rectangle draws thickness 1 or 2, got "
                         f"{thickness}")
    x0, x1 = sorted((int(p0[0]), int(p1[0])))
    y0, y1 = sorted((int(p0[1]), int(p1[1])))
    h = thickness - 1
    for y in (y0, y1):
        _fill(img, x0, x1, y - h, y + h, color)
    for x in (x0, x1):
        _fill(img, x - h, x + h, y0, y1, color)


def render_frame(canvas: np.ndarray, frame_recs: list[dict]) -> np.ndarray:
    """Draw one frame's records onto a copy of an HxWx3 uint8 BGR canvas:
    the GT box thin gray, the predicted box in its hit / miss / no-GT
    colour, 2 pixels thick (the reference's boxes; its text label is not
    drawn)."""
    img = np.array(canvas, np.uint8, copy=True)
    for rec in frame_recs:
        if "gt_box" in rec:
            x0, y0, x1, y1 = (int(round(v)) for v in rec["gt_box"])
            draw_rectangle(img, (x0, y0), (x1, y1), _GT_COLOR, 1)
        color = _COLORS["nogt" if "hit" not in rec
                        else ("hit" if rec["hit"] else "miss")]
        x0, y0, x1, y1 = (int(round(v)) for v in rec["box"])
        draw_rectangle(img, (x0, y0), (x1, y1), color, 2)
    return img


def write_png(path: str, bgr: np.ndarray) -> None:
    """An HxWx3 uint8 BGR image as an 8-bit RGB PNG (zlib, no filter)."""
    rgb = np.ascontiguousarray(bgr[..., ::-1], np.uint8)
    h, w = rgb.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def _canvas_size(recs: list[dict], default: int = 640) -> int:
    hi = 0.0
    for r in recs:
        hi = max(hi, *r["box"], *(r.get("gt_box") or [0]))
    return max(64, min(4096, int(np.ceil(hi)))) if hi > 0 else default


def _dataset(cfg: Config, split: str):
    """The split with ground truth when its archives carry it, else
    without (e.g. fresh extract output)."""
    from nafae_torch.data.youcook2 import SegmentDataset

    args = (cfg.data.root, split, cfg.data.max_frames, cfg.data.num_regions,
            cfg.data.feat_dim, cfg.data.max_words)
    try:
        ds = SegmentDataset(*args, with_gt=True)
        if len(ds):
            ds[0]   # the constructor reads only index.jsonl: loading one
                    # sample probes the archives for gt_boxes (KeyError)
        return ds
    except (KeyError, OSError):
        return SegmentDataset(*args, with_gt=False)


def visualize_config(cfg: Config, out_dir: str, params: dict,
                     split: str = "val", num_segments: int = 8,
                     annotations: str = "", iou_thresh: float = 0.5,
                     render: bool = True,
                     device: str | torch.device | None = None) -> str:
    """Run the tool on `device`; returns the predictions.jsonl path."""
    from nafae_torch.data.vocab import vocab_from_config

    dev = resolve_device(device)
    params = params_from_jax(params, dev)
    ds = _dataset(cfg, split)
    videos = {}
    if annotations:
        with open(annotations) as f:
            for ln in f:
                ann = json.loads(ln)
                videos[str(ann["id"])] = ann
    vocab = vocab_from_config(cfg.data)
    os.makedirs(out_dir, exist_ok=True)
    jsonl_path = os.path.join(out_dir, "predictions.jsonl")
    n = min(num_segments, len(ds))
    with open(jsonl_path, "w") as out:
        for i in range(n):
            sample = ds[i]
            seg_id = str(ds.index[i].get("id", i))
            recs = segment_records(sample, predict_segment(params, sample),
                                   vocab, seg_id, iou_thresh)
            for r in recs:
                out.write(json.dumps(r) + "\n")
            if not render or not recs:
                continue
            frames = None
            if seg_id in videos:
                from nafae_torch.extract import decode_segment
                ann = videos[seg_id]
                frames = decode_segment(
                    ann["video"], cfg.detector.frame_rate,
                    cfg.data.max_frames, cfg.detector.image_size,
                    start=float(ann.get("start") or 0.0),
                    end=float(ann.get("end") or -1.0))
            size = _canvas_size(recs, cfg.detector.image_size)
            seg_dir = os.path.join(out_dir, seg_id)
            os.makedirs(seg_dir, exist_ok=True)
            for t in sorted({r["frame"] for r in recs}):
                if frames is not None and t < len(frames):
                    canvas = (frames[t] * 255).clip(0, 255).astype(
                        np.uint8)[..., ::-1]                     # RGB->BGR
                else:
                    canvas = np.full((size, size, 3), 40, np.uint8)
                img = render_frame(canvas,
                                   [r for r in recs if r["frame"] == t])
                write_png(os.path.join(seg_dir, f"frame{t:03d}.png"), img)
    return jsonl_path


def _load_params(cfg: Config, checkpoint: str | None, device) -> dict:
    from nafae_torch.utils.checkpoint import load_eval_params

    params = load_eval_params(cfg, checkpoint, device=device)
    if params is None:
        raise FileNotFoundError(
            f"no checkpoint found in {checkpoint or cfg.train.ckpt_dir!r}")
    return params


def main(argv=None) -> int:
    import argparse

    from nafae_torch.config import load_config

    p = argparse.ArgumentParser("nafae_torch.visualize")
    p.add_argument("--preset", default="config1")
    p.add_argument("--config", default=None)
    p.add_argument("--override", nargs="*", action="extend", default=None)
    p.add_argument("--split", default="val")
    p.add_argument("--checkpoint", default=None,
                   help=".npz, a port checkpoint directory, or an orbax "
                        "checkpoint directory of the JAX package (default: "
                        "train.ckpt_dir)")
    p.add_argument("--out", default="viz")
    p.add_argument("--num-segments", type=int, default=8)
    p.add_argument("--annotations", default="",
                   help="segments.jsonl with video paths — draw onto the "
                        "decoded frames instead of a neutral canvas")
    p.add_argument("--iou-thresh", type=float, default=0.5)
    p.add_argument("--no-render", action="store_true",
                   help="predictions.jsonl only, no images")
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    cfg = load_config(args.config, args.preset, args.override or [])
    device = resolve_device(args.device)
    path = visualize_config(cfg, args.out,
                            _load_params(cfg, args.checkpoint, device),
                            split=args.split,
                            num_segments=args.num_segments,
                            annotations=args.annotations,
                            iou_thresh=args.iou_thresh,
                            render=not args.no_render, device=device)
    with open(path) as f:
        n = sum(1 for _ in f)
    print(json.dumps({"predictions": path, "records": n,
                      "out_dir": args.out}))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
