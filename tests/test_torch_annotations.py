"""The port's annotation parsers (nafae_torch.data.annotations) and
RoboWatchDataset against the JAX package's, on the CPU, on the schema
fixtures of tests/test_annotations.py and its strict-mode drift cases.

Held exactly: every parser's output (segment lists; ground-truth boxes,
masks, word ids and the normalised flag), lenient and strict; the same
SchemaError (class name and message) where the reference raises one;
`merge_gt_into_features` on extracted files (the rewritten .npz equal key
by key, the same count); and the samples of the port's RoboWatchDataset
against the reference's on the merged files.
"""

import json

import numpy as np
import pytest

from nafae_tpu.data import annotations as J
from nafae_tpu.data.vocab import Vocab as JVocab
from nafae_torch.data import annotations as T
from nafae_torch.data.vocab import Vocab as TVocab
from tests.test_annotations import ROBOWATCH, YC2, YC2BB

CLEAN_BB = json.loads(json.dumps(YC2BB))
del CLEAN_BB["database"]["vidB"]["segments"]["0"]["objects"][1]

# (parser, fixture, kwargs): the fixtures and drift cases of
# tests/test_annotations.py, each run by both packages
CASES = [
    ("segments_from_youcook2", YC2, {}),
    ("segments_from_youcook2", YC2, {"subset": "val"}),
    ("segments_from_youcook2", YC2, {"strict": True, "ext": ".avi"}),
    ("segments_from_youcook2", {"database": {"v": {
        "subset": "train", "annotations": []}}}, {"strict": True}),
    ("segments_from_youcook2", {"database": {"v": {
        "subset": "train", "annotations": []}}}, {}),
    ("segments_from_youcook2", {"database": {"v": {"subset": "training"}}},
     {"strict": True}),
    ("segments_from_youcook2", {"database": {"v": {
        "subset": "training", "annotations": [
            {"id": 0, "segment": [1], "sentence": "x"}]}}}, {"strict": True}),
    ("segments_from_youcook2", {"database": {"v": {
        "subset": "training", "annotations": [
            {"id": 0, "segment": [1, 2]}]}}}, {"strict": True}),
    ("segments_from_youcook2", {"database": {"v": {
        "subset": "training", "annotations": [
            {"id": 0, "segment": [1, 2]}]}}}, {}),
    ("segments_from_youcook2", {"database": {"v": {
        "subset": "training", "annotations": [
            {"id": 0, "segment": 12.5, "sentence": "x"}]}}}, {"strict": True}),
    ("segments_from_youcook2", {"database": {"v": {
        "subset": "training", "annotations": [
            {"id": 0, "segment": "12", "sentence": "x"}]}}}, {}),
    ("gt_from_youcook2bb", YC2BB, {"max_words": 4, "max_frames": 5}),
    ("gt_from_youcook2bb", YC2BB, {"strict": True}),
    ("gt_from_youcook2bb", CLEAN_BB, {"strict": True}),
    ("gt_from_youcook2bb", {"database": {"v": {"segments": {"0": {
        "objects": [{"label": "pan", "boxes": [[1, 2, 3, 4]]}]}}}}},
     {"strict": True}),
    ("gt_from_youcook2bb", {"database": {"v": {"segments": {"0": {
        "objects": [{"label": "pan", "boxes": [[1, 2, 3, 4]]}]}}}}}, {}),
    ("gt_from_youcook2bb", {"database": {"v": {
        "rwidth": 10, "rheight": 10, "segments": {"0": {"objects": [
            {"label": "pan", "boxes": []},
            {"label": "bowl", "boxes": []}]}}}}},
     {"max_words": 1, "strict": True}),
    ("gt_from_youcook2bb", {"database": {"v": {
        "rwidth": 10, "rheight": 10, "segments": {"0": {"objects": [
            {"label": "pan", "boxes": [{"x1": 1, "y1": 2, "x2": 3}]}]}}}}},
     {"strict": True}),
    ("gt_from_youcook2bb", {"database": {"v": {
        "rwidth": 10, "rheight": 10, "segments": {"0": {"objects": [
            {"label": "pan", "boxes": [{"x1": 1, "y1": 2, "x2": 3}]}]}}}}},
     {}),
    ("segments_from_robowatch", ROBOWATCH, {}),
    ("segments_from_robowatch", {"database": ROBOWATCH}, {"ext": ".avi"}),
    ("segments_from_robowatch", ROBOWATCH, {"strict": True}),
    ("segments_from_robowatch", {
        "vidE": {"segments": {"0": {"segment": None, "objects": None,
                                    "sentence": "stir the soup"}}},
        "vidF": {"segments": [{"segment": [1, 4],
                               "objects": [{"label": "Cup"}]}]}}, {}),
    ("segments_from_robowatch", {"v": {"segments": {"0": {}}}},
     {"strict": True}),
    ("segments_from_robowatch", {"v": {"segments": {"0": {
        "segment": 3.0, "sentence": "x"}}}}, {"strict": True}),
    ("segments_from_robowatch", {"v": {"segments": {"0": {
        "segment": 3.0, "sentence": "x"}}}}, {}),
    ("gt_from_robowatch", ROBOWATCH, {"max_words": 4, "max_frames": 5}),
    ("gt_from_robowatch", ROBOWATCH, {"strict": True}),
    ("gt_from_robowatch", {"v": {"segments": {"0": {"sentence": "x"}}}},
     {"strict": True}),
]


def _run(mod, name, path, kw):
    fn = getattr(mod, name)
    try:
        if name.startswith("segments_"):
            return fn(path, "/videos", **kw)
        return fn(path, **kw)
    except mod.SchemaError as e:
        return ("SchemaError", str(e))


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_parser_matches_jax(tmp_path, i):
    name, obj, kw = CASES[i]
    path = tmp_path / "ann.json"
    path.write_text(json.dumps(obj))
    want = _run(J, name, str(path), kw)
    got = _run(T, name, str(path), kw)
    _assert_same(got, want)


def test_vocab_is_the_references():
    tv, jv = TVocab(), JVocab()
    assert tv.classes == jv.classes and tv.word_to_id == jv.word_to_id


def _features(d, ids, t=3, r=4, feat=8, seed=0):
    """Extracted-feature files as extract_segments writes them."""
    rng = np.random.RandomState(seed)
    d.mkdir(parents=True)
    lines = []
    for i, sid in enumerate(ids):
        np.savez(d / f"{sid}.npz",
                 feats=rng.randn(t + i, r, feat).astype(np.float16),
                 boxes=rng.uniform(0, 160, (t + i, r, 4)).astype(np.float32),
                 region_mask=np.ones((t + i, r), np.float32),
                 word_ids=np.asarray([0], np.int32))
        lines.append(json.dumps({"id": sid, "file": f"{sid}.npz",
                                 "num_frames": t + i, "num_words": 1,
                                 "split": "val"}))
    (d / "index.jsonl").write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("source", ["yc2bb", "robowatch"])
def test_merge_and_robowatch_dataset_match_jax(tmp_path, source):
    from nafae_tpu.data.robowatch import RoboWatchDataset as JRW
    from nafae_torch.data.robowatch import RoboWatchDataset as TRW

    if source == "yc2bb":
        obj, ids, parser, size = YC2BB, ["vidB_0", "vidA_0"], \
            "gt_from_youcook2bb", 160
    else:
        obj, ids, parser, size = ROBOWATCH, ["vidC_2", "vidD_0", "vidX_0"], \
            "gt_from_robowatch", 160
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps(obj))
    for tag in ("j", "t"):
        _features(tmp_path / tag / "val", ids)
    gj = getattr(J, parser)(str(ann), max_words=4, max_frames=5)
    gt = getattr(T, parser)(str(ann), max_words=4, max_frames=5)
    nj = J.merge_gt_into_features(str(tmp_path / "j" / "val"), gj,
                                  image_size=size)
    nt = T.merge_gt_into_features(str(tmp_path / "t" / "val"), gt,
                                  image_size=size)
    assert nt == nj >= 1
    for sid in ids:
        with np.load(tmp_path / "j" / "val" / f"{sid}.npz") as jz, \
                np.load(tmp_path / "t" / "val" / f"{sid}.npz") as tz:
            assert sorted(tz.files) == sorted(jz.files)
            for k in jz.files:
                assert tz[k].dtype == jz[k].dtype, k
                np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
    args = dict(max_frames=5, num_regions=4, feat_dim=8, max_words=4)
    jds, tds = JRW(str(tmp_path / "j"), **args), TRW(str(tmp_path / "t"),
                                                      **args)
    assert len(tds) == len(jds) == len(ids)
    for i in range(len(ids)):
        if "gt_mask" not in np.load(tmp_path / "j" / "val" /
                                    f"{ids[i]}.npz").files:
            continue      # no ground truth for this segment: eval skips it
        _assert_same(tds[i], jds[i])
    with pytest.raises(ValueError, match="image_size"):
        T.merge_gt_into_features(str(tmp_path / "t" / "val"),
                                 {ids[0]: dict(gt[ids[0]], normalized=True)})
