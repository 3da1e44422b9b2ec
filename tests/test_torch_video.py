"""The port's frame decoding and feature extraction (nafae_torch.extract,
nafae_torch.data.avi, nafae_torch.data.video_dataset) against the JAX
package's `extract.decode_segment` (OpenCV's native library here, or cv2)
and `extract.extract_segments`, on the same videos and detector weights.

Held: frames bit for bit, through the cv2 route (an MJPG file) and the
numpy AVI reader (a rawvideo AVI written by cv2 with fourcc RGBA, one
written by `data.avi.write_avi`, which chip_smoke.py uses and which OpenCV
reads back exactly, and a 24-bit BI_RGB one), with start/end trimming and
resizing; without cv2 the
reader still decodes uncompressed AVI and raises, naming the format, on the
rest. extract_segments writes the reference's keys, shapes and dtypes, its
f16 features agree with the reference's at f16 rounding, and the files load
through the port's SegmentDataset. The CLI extracts from YouCook2 and
YC2-BB files with a faster-rcnn.pytorch checkpoint (`--ckpt`), its output
equal to the reference's parsers, converter, extraction and merge.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from nafae_tpu.extract import decode_segment as j_decode  # noqa: E402
from nafae_torch.data import avi  # noqa: E402
from nafae_torch.extract import decode_segment  # noqa: E402


def _frames(n, h, w, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3), np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("videos")
    out = {}
    for name, fourcc, fps in (("mjpg", "MJPG", 10.0), ("rgba", "RGBA", 10.0)):
        path = str(d / f"{name}.avi")
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps,
                             (48, 40))
        for f in _frames(30, 40, 48, 1):
            wr.write(f)                                   # BGR frames
        wr.release()
        out[name] = path
    path = str(d / "own.avi")
    out["own_frames"] = _frames(25, 32, 36, 2)            # RGB frames
    avi.write_avi(path, out["own_frames"], 5.0)
    out["own"] = path
    path = str(d / "own64.avi")
    avi.write_avi(path, _frames(6, 64, 64, 3), 1.0)
    out["own64"] = path
    path = str(d / "bgr24.avi")                       # BI_RGB, bottom-up
    avi.write_avi(path, _frames(12, 30, 34, 4), 4.0, bits=24)
    out["bgr24"] = path
    return out


CASES = [  # frame_rate, max_frames, image_size, start, end
    (10.0, 40, 32, 0.0, -1.0),
    (2.0, 8, 48, 0.0, -1.0),
    (3.0, 40, 32, 1.0, 2.0),
    (10.0, 40, 40, 0.5, 1.2),
    (25.0, 5, 32, 2.5, -1.0),
    (1.0, 40, 32, 9.0, -1.0),          # past the end: no frame
]


@pytest.mark.parametrize("name", ["mjpg", "rgba", "own", "bgr24"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_decode_matches_reference_bitwise(videos, name, case):
    fr, mx, size, start, end = CASES[case]
    want = j_decode(videos[name], fr, mx, size, start=start, end=end)
    got = decode_segment(videos[name], fr, mx, size, start=start, end=end)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_formats_are_told_apart(videos):
    assert avi.sniff_format(videos["rgba"]) == "avi-raw"
    assert avi.sniff_format(videos["own"]) == "avi-raw"
    assert avi.sniff_format(videos["bgr24"]) == "avi-raw"
    assert avi.sniff_format(videos["mjpg"]) == "avi-MJPG"


def test_own_writer_is_what_opencv_reads(videos):
    cap = cv2.VideoCapture(videos["own"])
    assert cap.get(cv2.CAP_PROP_FPS) == 5.0
    got = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        got.append(f[..., ::-1])
    assert len(got) == len(videos["own_frames"])
    for a, b in zip(got, videos["own_frames"]):
        np.testing.assert_array_equal(a, b)
    fps, n, frame = avi.read_avi(videos["own"])
    assert (fps, n) == (5.0, 25)
    np.testing.assert_array_equal(frame(7), videos["own_frames"][7])


def test_without_cv2(videos, monkeypatch):
    """The GPU machine's case: raw AVI at image_size decodes, the rest
    raises ImportError naming what it is."""
    want = decode_segment(videos["own64"], 1.0, 10, 64)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(decode_segment(videos["own64"], 1.0, 10,
                                                 64), want)
    with pytest.raises(ImportError, match="avi-MJPG"):
        decode_segment(videos["mjpg"], 1.0, 10, 64)
    with pytest.raises(ImportError, match="resizing"):
        decode_segment(videos["own64"], 1.0, 10, 32)


def test_video_dataset_sample(videos, tmp_path):
    from nafae_torch.data.video_dataset import VideoSegmentDataset
    from nafae_tpu.data.video_dataset import \
        VideoSegmentDataset as JVideoSegmentDataset
    anns = [{"id": "a", "video": videos["own"], "sentence": "cut the onion",
             "start": 1.0, "end": 3.0},
            {"id": "b", "video": videos["rgba"], "sentence": "oil in a pan"}]
    got = VideoSegmentDataset(anns, 6, 32, 4, frame_rate=2.0)
    want = JVideoSegmentDataset(anns, 6, 32, 4, frame_rate=2.0)
    assert len(got) == 2 and got.frame_buckets == (6,)
    for i in range(2):
        g, w = got[i], want[i]
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    bad = VideoSegmentDataset([{"id": "c", "video": videos["own"],
                                "sentence": "x", "start": 50.0}], 6, 32, 4)
    with pytest.raises(IOError, match="0 frames"):
        bad[0]


@pytest.fixture(scope="module")
def extracted(videos, tmp_path_factory):
    """Both packages' extract_segments on the same two videos and weights."""
    import nafae_tpu.config as jcfg
    import nafae_torch.config as tcfg
    from nafae_tpu.extract import extract_segments as j_extract
    from nafae_tpu.models.detector.faster_rcnn import init_detector as j_init
    from nafae_torch.extract import extract_segments
    from nafae_torch.models.detector.faster_rcnn import (
        FasterRCNNExtractor, detector_params_from_jax)

    ov = ["detector.image_size=64", "detector.num_proposals=5",
          "detector.rpn_pre_nms_topk=32", "detector.anchor_scales=[16,32]",
          "detector.frame_rate=2.0", "data.max_frames=5", "data.max_words=4"]
    jc = jcfg.load_config(preset_name="config5", overrides=ov)
    tc = tcfg.load_config(preset_name="config5", overrides=ov)
    _, params = j_init(jax.random.PRNGKey(3), jc.detector)
    model = FasterRCNNExtractor(tc.detector).eval()
    model.load_state_dict(detector_params_from_jax(
        jax.tree.map(np.asarray, params)))
    anns = [{"id": "seg0", "video": videos["rgba"],
             "sentence": "heat the oil in a pan and add onions",
             "split": "train"},
            {"id": "seg1", "video": videos["own"], "sentence": "cut a tomato",
             "split": "train", "start": 1.0}]
    root = tmp_path_factory.mktemp("extract")
    out = {}
    for tag, q in (("", ""), ("_int8", "int8")):
        jdir, tdir = str(root / f"jax{tag}"), str(root / f"torch{tag}")
        j_extract(jc, anns, jdir, params=params, frame_batch=4, quantize=q)
        extract_segments(tc, anns, tdir, model=model, frame_batch=4,
                         quantize=q, device="cpu")
        out[tag] = (jdir, tdir)
    return out, tc


@pytest.mark.parametrize("tag", ["", "_int8"])
def test_extract_segments_matches_reference(extracted, tag):
    (jdir, tdir), _ = extracted[0][tag], extracted[1]
    with open(os.path.join(jdir, "index.jsonl")) as f:
        jidx = [json.loads(ln) for ln in f]
    with open(os.path.join(tdir, "index.jsonl")) as f:
        tidx = [json.loads(ln) for ln in f]
    assert tidx == jidx
    for meta in jidx:
        with np.load(os.path.join(jdir, meta["file"])) as jz, \
                np.load(os.path.join(tdir, meta["file"])) as tz:
            assert sorted(tz.files) == sorted(jz.files)
            for k in jz.files:
                assert tz[k].shape == jz[k].shape, k
                assert tz[k].dtype == jz[k].dtype, k
            np.testing.assert_array_equal(tz["word_ids"], jz["word_ids"])
            np.testing.assert_array_equal(tz["region_mask"],
                                          jz["region_mask"])
            np.testing.assert_allclose(tz["boxes"], jz["boxes"], rtol=0,
                                       atol=64 * 1e-4)
            if tag:                   # int8: within one quantization step
                f_t = tz["feats"].astype(np.float32) * tz["feats_scale"][
                    ..., None]
                f_j = jz["feats"].astype(np.float32) * jz["feats_scale"][
                    ..., None]
                np.testing.assert_allclose(f_t, f_j, rtol=0, atol=1.01 *
                                           jz["feats_scale"].max())
            else:                     # f16: within its rounding
                np.testing.assert_allclose(
                    tz["feats"].astype(np.float32),
                    jz["feats"].astype(np.float32), rtol=2 ** -10,
                    atol=1e-6)


@pytest.mark.parametrize("tag", ["", "_int8"])
def test_extracted_files_load(extracted, tag):
    from nafae_torch.data.youcook2 import SegmentDataset
    jdir, tdir = extracted[0][tag]
    ds = SegmentDataset(os.path.dirname(tdir), os.path.basename(tdir), 5, 5,
                        2048, 4)
    want = SegmentDataset(os.path.dirname(jdir), os.path.basename(jdir), 5,
                          5, 2048, 4)
    assert len(ds) == len(want) == 2
    for i in range(2):
        s, w = ds[i], want[i]
        assert s["feats"].shape == (5, 5, 2048)
        assert s["boxes"].shape == (5, 5, 4)
        assert np.isfinite(s["feats"]).all()
        np.testing.assert_array_equal(s["frame_mask"], w["frame_mask"])
        np.testing.assert_array_equal(s["region_mask"], w["region_mask"])


def test_extract_cli(videos, tmp_path, capsys):
    from nafae_torch.extract import main
    anns = tmp_path / "segments.jsonl"
    anns.write_text(json.dumps({"id": "s", "video": videos["own64"],
                                "sentence": "add salt"}) + "\n")
    out = tmp_path / "feats"
    ov = ["detector.image_size=64", "detector.num_proposals=4",
          "detector.anchor_scales=[16,32]", "data.max_frames=3"]
    main(["--annotations", str(anns), "--out", str(out), "--device", "cpu",
          "--override", *ov])
    with np.load(out / "s.npz") as z:
        assert z["feats"].shape == (3, 4, 2048)

    # the release's files and a faster-rcnn.pytorch checkpoint: the output
    # carries the YC2-BB ground truth, as the reference's parsers, loader
    # and merge give it on the reference's extraction
    from nafae_tpu.data import annotations as JA
    from nafae_tpu.extract import extract_segments as j_extract
    from nafae_tpu.models.detector.faster_rcnn import init_detector as j_init
    from nafae_tpu.utils.torch_convert import load_detector_weights
    from tests.test_torch_convert_frcnn import make_frcnn_sd
    import nafae_tpu.config as jcfg

    vid = os.path.splitext(os.path.basename(videos["own64"]))[0]
    yc2 = tmp_path / "yc2.json"
    yc2.write_text(json.dumps({"database": {vid: {
        "subset": "validation", "annotations": [
            {"id": 0, "segment": [0, 4], "sentence": "add salt to the pan"},
            {"id": 1, "segment": [1, 3], "sentence": "stir the bowl"}]}}}))
    bb = tmp_path / "bb.json"
    bb.write_text(json.dumps({"database": {vid: {
        "rwidth": 128, "rheight": 96, "segments": {"0": {"objects": [
            {"label": "pan", "boxes": [
                {"x1": 8 * i, "y1": 4, "x2": 8 * i + 40, "y2": 60,
                 "outside": int(i == 2)} for i in range(5)]}]}}}}}))
    ckpt = tmp_path / "frcnn.pth"
    torch.save({"model": {"module." + k: torch.from_numpy(v) for k, v in
                          make_frcnn_sd(np.random.RandomState(9)).items()}},
               ckpt)
    ov = ov + ["detector.rpn_channels=512", "data.max_frames=5"]
    out = tmp_path / "feats_yc2"
    main(["--youcook2-json", str(yc2), "--video-dir",
          os.path.dirname(videos["own64"]), "--video-ext", ".avi",
          "--subset", "val", "--yc2bb-json", str(bb), "--ckpt", str(ckpt),
          "--out", str(out), "--device", "cpu", "--override", *ov])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["segments"] == 2 and printed["gt_merged"] == 1

    jc = jcfg.load_config(preset_name="config5", overrides=ov)
    anns = JA.segments_from_youcook2(str(yc2), os.path.dirname(
        videos["own64"]), ext=".avi", subset="val")
    _, p0 = j_init(jax.random.PRNGKey(0), jc.detector)
    jdir = str(tmp_path / "feats_jax")
    j_extract(jc, anns, jdir, params=load_detector_weights(
        str(ckpt), p0, num_scales=2, num_ratios=3))
    assert JA.merge_gt_into_features(jdir, JA.gt_from_youcook2bb(
        str(bb), max_words=jc.data.max_words, max_frames=5),
        image_size=64) == 1
    for a in anns:
        with np.load(out / f"{a['id']}.npz") as tz, \
                np.load(os.path.join(jdir, f"{a['id']}.npz")) as jz:
            assert sorted(tz.files) == sorted(jz.files)
            for k in ("word_ids", "region_mask", "gt_boxes", "gt_mask"):
                if k in jz.files:
                    np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
            np.testing.assert_allclose(tz["boxes"], jz["boxes"], rtol=0,
                                       atol=64 * 1e-4)
            np.testing.assert_allclose(
                tz["feats"].astype(np.float32),
                jz["feats"].astype(np.float32), rtol=2 ** -10, atol=1e-6)
    with np.load(out / f"{vid}_0.npz") as z:
        assert z["gt_mask"].sum() == 4 and z["gt_boxes"].shape == (1, 5, 4)
