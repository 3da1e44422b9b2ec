"""Feature extraction: video -> sampled frames -> Faster R-CNN RoI features
(the port of `nafae_tpu/extract.py`).

- `decode_segment`: a segment's frames, sampled at `frame_rate`, as RGB
  float32 in [0, 1]. Uncompressed AVI goes through the numpy reader of
  `data/avi.py`, which runs where neither OpenCV's native library nor `cv2`
  is installed (the machine with the card); every other format goes through
  `cv2`. Both give the reference's native decoder's frames bit for bit: the
  same frame selection, and bytes times float32(1/255) (OpenCV's
  convertTo; the reference's `cv2` fallback divides by 255, which differs
  in the last bit for about half the byte values).
- `extract_segments` / the CLI: decode each annotated segment, run the
  detector, write per-segment .npz files and an index.jsonl that
  `data.youcook2.SegmentDataset` reads.

    python -m nafae_torch.extract --annotations segments.jsonl --out feats \\
        [--quantize int8] [--override detector.image_size=...] [--device cpu]

Annotations: segments.jsonl, one JSON per line: {"id", "video",
"sentence", "split"?, "start"?, "end"?}. Detector weights are random from
train.seed; the annotation parsers (`--youcook2-json`, `--robowatch-json`,
`--yc2bb-json`) and `--ckpt` are not ported yet.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from nafae_torch.config import Config
from nafae_torch.data import avi
from nafae_torch.data.vocab import Vocab

INV_255 = np.float32(1.0 / 255.0)


def _frame_indices(n_frames: int, fps: float, frame_rate: float,
                   max_frames: int, start: float, end: float) -> list[int]:
    """The reference's frame selection (native decoder and cv2 loop alike):
    fps <= 1e-3 reads as 25, first = int(start·fps + 0.5), a frame is
    taken when i + 1e-9 >= next, next advancing by fps / frame_rate, and
    `end` (seconds, > 0) trims the segment."""
    if not fps or fps <= 1e-3:
        fps = 25.0
    first = int(start * fps + 0.5)
    last = int(end * fps + 0.5) if end > 0 else -1
    step = fps / (frame_rate if frame_rate > 0 else 1.0)
    picked, nxt, i = [], 0.0, 0
    while len(picked) < max_frames:
        if last >= 0 and first + i > last:
            break
        if first + i >= n_frames:
            break
        if i + 1e-9 >= nxt:
            nxt += step
            picked.append(first + i)
        i += 1
    return picked


def _to_float(rgb: np.ndarray, image_size: int) -> np.ndarray:
    """uint8 RGB [h,w,3] -> [S,S,3] f32; resized with cv2 (INTER_LINEAR)
    when its size differs."""
    if rgb.shape[:2] != (image_size, image_size):
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                f"a {rgb.shape[1]}x{rgb.shape[0]} frame needs resizing to "
                f"{image_size}x{image_size}, which takes cv2 (not "
                "installed); write the video at detector.image_size") from e
        rgb = cv2.resize(rgb, (image_size, image_size))
    return rgb.astype(np.float32) * INV_255


def decode_segment(video_path: str, frame_rate: float, max_frames: int,
                   image_size: int, start: float = 0.0,
                   end: float = -1.0) -> np.ndarray:
    """[n, S, S, 3] float32 RGB frames of the segment [start, end] seconds
    (end <= 0 reads to the end). The backend follows the file's format:
    uncompressed AVI through the numpy reader, anything else through cv2
    (an ImportError naming the format when cv2 is missing)."""
    if not os.path.exists(video_path):
        raise IOError(f"cannot open {video_path}")
    fmt = avi.sniff_format(video_path)
    if fmt == "avi-raw":
        fps, n, frame = avi.read_avi(video_path)
        idx = _frame_indices(n, fps, frame_rate, max_frames, start, end)
        frames = [_to_float(frame(i), image_size) for i in idx]
    else:
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                f"{video_path} is {fmt} (not an uncompressed AVI); decoding "
                "it takes cv2, which is not installed") from e
        frames = _decode_cv2(cv2, video_path, frame_rate, max_frames,
                             image_size, start, end)
    return np.stack(frames) if frames else np.zeros(
        (0, image_size, image_size, 3), np.float32)


def _decode_cv2(cv2, video_path, frame_rate, max_frames, image_size, start,
                end) -> list[np.ndarray]:
    """The reference's cv2 loop (seek to the first frame, grab, retrieve
    the selected ones, resize, BGR -> RGB)."""
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"cannot open {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS)
    if not fps or fps <= 1e-3:
        fps = 25.0
    first = int(start * fps + 0.5)
    if first > 0:
        cap.set(cv2.CAP_PROP_POS_FRAMES, first)
    last = int(end * fps + 0.5) if end > 0 else -1
    step = fps / (frame_rate if frame_rate > 0 else 1.0)
    frames, nxt, i = [], 0.0, 0
    while len(frames) < max_frames:
        if last >= 0 and first + i > last:
            break
        if not cap.grab():
            break
        if i + 1e-9 >= nxt:
            nxt += step
            ok, frame = cap.retrieve()
            if ok:
                frame = cv2.resize(frame, (image_size, image_size))
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                              .astype(np.float32) * INV_255)
        i += 1
    cap.release()
    return frames


def make_extract_fn(cfg: Config, model=None,
                    device: str | torch.device | None = None):
    """Returns (frames [B,S,S,3] numpy -> {boxes, feats, scores,
    region_valid} numpy, the detector). Without `model`, the detector has
    random weights from train.seed. `detector.weights` is not ported yet."""
    from nafae_torch.device import resolve_device
    from nafae_torch.models.detector.faster_rcnn import init_detector

    if cfg.detector.weights:
        raise NotImplementedError(
            "detector.weights (torch detector checkpoints) is not ported yet")
    device = resolve_device(device)
    if model is None:
        model = init_detector(cfg.detector,
                              torch.Generator().manual_seed(cfg.train.seed),
                              device=device)

    def fn(frames: np.ndarray) -> dict[str, np.ndarray]:
        out = model(torch.from_numpy(np.ascontiguousarray(frames, np.float32))
                    .to(device))
        return {k: v.float().cpu().numpy() if v.is_floating_point()
                else v.cpu().numpy() for k, v in out.items()}

    return fn, model


def quantize_feats_np(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """feats [T,R,D] -> (int8 [T,R,D], per-region scales f32 [T,R]):
    symmetric per row, s = max|f| / 127, round half to even."""
    f = feats.astype(np.float32)
    sf = np.maximum(np.abs(f).max(axis=-1), 1e-12) / 127.0      # [T,R]
    q = np.clip(np.round(f / sf[..., None]), -127, 127).astype(np.int8)
    return q, sf.astype(np.float32)


def extract_segments(cfg: Config, annotations: list[dict], out_dir: str,
                     model=None, vocab: Vocab | None = None,
                     frame_batch: int = 8, quantize: str = "",
                     device: str | torch.device | None = None) -> str:
    """Run the extraction pipeline; returns the index.jsonl path. Frames go
    through the detector frame_batch at a time (the last batch zero-padded,
    its padding dropped). quantize="int8" stores int8 features and
    per-region scales; otherwise f16."""
    if quantize not in ("", "int8"):
        raise ValueError(f"quantize must be '' or 'int8', got {quantize!r}")
    from nafae_torch.data.vocab import vocab_from_config
    vocab = vocab or vocab_from_config(cfg.data)
    os.makedirs(out_dir, exist_ok=True)
    fn, _ = make_extract_fn(cfg, model, device)
    dc = cfg.detector
    index_path = os.path.join(out_dir, "index.jsonl")
    with open(index_path, "w") as idx:
        for ann in annotations:
            frames = decode_segment(ann["video"], dc.frame_rate,
                                    cfg.data.max_frames, dc.image_size,
                                    start=float(ann.get("start") or 0.0),
                                    end=float(ann.get("end") or -1.0))
            t = frames.shape[0]
            if t == 0:
                continue
            boxes, feats, rvalid = [], [], []
            for lo in range(0, t, frame_batch):
                real = min(frame_batch, t - lo)
                chunk = frames[lo:lo + real]
                if real < frame_batch:
                    chunk = np.concatenate(
                        [chunk, np.zeros((frame_batch - real,)
                                         + chunk.shape[1:], np.float32)])
                out = fn(chunk)
                boxes.append(out["boxes"][:real])
                feats.append(out["feats"][:real])
                rvalid.append(out["region_valid"][:real])
            word_ids = np.asarray(
                vocab.extract(ann["sentence"], cfg.data.max_words), np.int32)
            name = str(ann["id"])
            arrays = {
                "boxes": np.concatenate(boxes).astype(np.float32),
                "region_mask": np.concatenate(rvalid).astype(np.float32),
                "word_ids": word_ids,
            }
            if quantize == "int8":
                q, sf = quantize_feats_np(np.concatenate(feats))
                arrays["feats"], arrays["feats_scale"] = q, sf
            else:
                arrays["feats"] = np.concatenate(feats).astype(np.float16)
            np.savez(os.path.join(out_dir, name + ".npz"), **arrays)
            idx.write(json.dumps({
                "id": name, "file": name + ".npz", "num_frames": t,
                "num_words": int(word_ids.size),
                "split": ann.get("split", "train"),
            }) + "\n")
    return index_path


def main(argv=None):
    import argparse

    from nafae_torch.config import load_config

    p = argparse.ArgumentParser("nafae_torch.extract")
    p.add_argument("--preset", default="config5")
    p.add_argument("--config", default=None)
    p.add_argument("--override", nargs="*", action="extend", default=None)
    p.add_argument("--annotations",
                   help="segments.jsonl (id, video, sentence, split)")
    p.add_argument("--quantize", default="", choices=["", "int8"],
                   help="int8: store features as int8 + per-region scales")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a card) or cpu")
    for flag in ("--youcook2-json", "--robowatch-json", "--yc2bb-json",
                 "--ckpt"):
        p.add_argument(flag, default=None, help="not ported yet")
    args = p.parse_args(argv)
    todo = [f for f, v in (("--youcook2-json", args.youcook2_json),
                           ("--robowatch-json", args.robowatch_json),
                           ("--yc2bb-json", args.yc2bb_json),
                           ("--ckpt", args.ckpt)) if v]
    if todo:
        raise NotImplementedError(
            f"{', '.join(todo)}: not ported yet (the annotation parsers and "
            "checkpoint conversion come in a later slice); use --annotations")
    if not args.annotations:
        p.error("--annotations is required")
    cfg = load_config(args.config, args.preset, args.override or [])
    with open(args.annotations) as f:
        anns = [json.loads(ln) for ln in f if ln.strip()]
    index = extract_segments(cfg, anns, args.out, quantize=args.quantize,
                             device=args.device)
    print(json.dumps({"index": index, "segments": len(anns)}))


if __name__ == "__main__":
    main()
