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
    python -m nafae_torch.extract --youcook2-json ann.json --video-dir vids \\
        --video-ext .avi [--subset val] --yc2bb-json bb.json \\
        --ckpt frcnn_vgg16.pth --override detector.backbone=vgg16 \\
        detector.rpn_channels=512 model.feat_dim=4096 --out feats

Segments come from segments.jsonl (one JSON per line: {"id", "video",
"sentence", "split"?, "start"?, "end"?}), the official YouCook2 release
(`--youcook2-json`) or the RoboWatch transfer annotations
(`--robowatch-json`), in that order of precedence (`data/annotations.py`;
`--strict` raises on schema drift). Ground truth from `--yc2bb-json` (or
else `--robowatch-json`) is merged into the written features, which then
evaluate (`python -m nafae_torch.evaluate --preset config1`). The detector
has random weights from train.seed, or a torch checkpoint's (`--ckpt`,
shorthand for detector.weights; `utils/torch_convert`).
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
    region_valid} numpy, the detector). Without `model`, the detector is
    the one cfg.detector describes (`init_detector`: random weights from
    train.seed, then detector.weights when set, then the BN fold when
    detector.fold_bn).

    On the card the detector is one device program, as the reference's
    `jax.jit(model.apply)`: a CUDA graph of it for each frame batch shape
    (`utils/cuda_graph.Graphed`), replayed; on the CPU it runs eagerly."""
    from nafae_torch.device import resolve_device
    from nafae_torch.models.detector.faster_rcnn import init_detector
    from nafae_torch.utils.cuda_graph import Graphed

    device = resolve_device(device)
    if model is None:
        model = init_detector(cfg.detector,
                              torch.Generator().manual_seed(cfg.train.seed),
                              device=device)
    program = Graphed(model, device)

    def fn(frames: np.ndarray) -> dict[str, np.ndarray]:
        out = program(np.ascontiguousarray(frames, np.float32))
        return {k: v.to("cpu", torch.float32 if v.is_floating_point()
                        else v.dtype, copy=True).numpy()
                for k, v in out.items()}

    fn.program = program
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


def main(argv=None) -> int:
    import argparse

    from nafae_torch.config import load_config
    from nafae_torch.data import annotations as A

    p = argparse.ArgumentParser("nafae_torch.extract")
    p.add_argument("--preset", default="config5")
    p.add_argument("--config", default=None)
    p.add_argument("--override", nargs="*", action="extend", default=None)
    p.add_argument("--annotations",
                   help="segments.jsonl (id, video, sentence, split)")
    p.add_argument("--youcook2-json",
                   help="official youcookii_annotations_trainval.json")
    p.add_argument("--video-dir", default=".",
                   help="video directory for --youcook2-json/"
                        "--robowatch-json")
    p.add_argument("--video-ext", default=".mp4",
                   help="video filename extension for --youcook2-json/"
                        "--robowatch-json (the release ids carry none)")
    p.add_argument("--subset", default=None,
                   help="train|val|test filter for --youcook2-json")
    p.add_argument("--yc2bb-json",
                   help="YouCook2-BB box annotations: merge their ground "
                        "truth into --out after extraction (enables eval)")
    p.add_argument("--robowatch-json",
                   help="RoboWatch transfer annotations: the segment list "
                        "(without --annotations/--youcook2-json) and the "
                        "ground truth merged into --out")
    p.add_argument("--ckpt", default=None,
                   help="torch detector .pth to convert and load "
                        "(faster-rcnn.pytorch lineage, or torchvision "
                        "resnet50/101 or vgg16; shorthand for "
                        "detector.weights)")
    p.add_argument("--quantize", default="", choices=["", "int8"],
                   help="int8: store features as int8 + per-region scales")
    p.add_argument("--strict", action="store_true",
                   help="annotation parsers raise SchemaError on unknown/"
                        "missing fields instead of skipping them")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    cfg = load_config(args.config, args.preset, args.override or [])
    if args.ckpt:
        cfg.detector.weights = args.ckpt
    if args.youcook2_json:
        anns = A.segments_from_youcook2(args.youcook2_json, args.video_dir,
                                        ext=args.video_ext,
                                        subset=args.subset,
                                        strict=args.strict)
    elif args.annotations:
        with open(args.annotations) as f:
            anns = [json.loads(ln) for ln in f if ln.strip()]
    elif args.robowatch_json:
        anns = A.segments_from_robowatch(args.robowatch_json, args.video_dir,
                                         ext=args.video_ext,
                                         strict=args.strict)
    else:
        p.error("one of --annotations / --youcook2-json / --robowatch-json "
                "is required")
    index = extract_segments(cfg, anns, args.out, quantize=args.quantize,
                             device=args.device)
    result = {"index": index, "segments": len(anns)}
    from nafae_torch.data.vocab import vocab_from_config
    vocab = vocab_from_config(cfg.data)
    gt = None
    if args.yc2bb_json:
        gt = A.gt_from_youcook2bb(args.yc2bb_json, vocab=vocab,
                                  max_words=cfg.data.max_words,
                                  max_frames=cfg.data.max_frames,
                                  strict=args.strict)
    elif args.robowatch_json:
        gt = A.gt_from_robowatch(args.robowatch_json, vocab=vocab,
                                 max_words=cfg.data.max_words,
                                 max_frames=cfg.data.max_frames,
                                 strict=args.strict)
    if gt is not None:
        result["gt_merged"] = A.merge_gt_into_features(
            args.out, gt, image_size=cfg.detector.image_size)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
