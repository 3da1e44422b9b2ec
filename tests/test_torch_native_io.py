"""The port's C++ batch packer (nafae_torch.utils.native_io, built by g++
from nafae_torch/csrc/host/packer.cpp) against its Python packer and the
JAX package's NativePacker, on the CPU: batches bit for bit equal in
float32, float16 and bfloat16 (special values included), a single frame
bucket smaller than max_frames, several buckets through the loader, the
v3 layout with ragged region masks and ground truth, a damaged cache
rejected; each package reads the `.nbin` cache the other wrote; the
loader's fallback when the packer cannot be built, and fit packing
natively by default (data.use_native_io)."""

import json
import os
import shutil
import warnings

import numpy as np
import pytest

from nafae_tpu.data import SegmentDataset as JSegmentDataset
from nafae_tpu.utils import native_io as J
from nafae_torch.data.loader import BatchLoader
from nafae_torch.data.youcook2 import SegmentDataset
from nafae_torch.utils import native_io as N


def _python_batch(ds, idxs):
    samples = [ds[i] for i in idxs]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if str(got[k].dtype) in ("float16", "bfloat16"):
            np.testing.assert_array_equal(got[k].view(np.uint16),
                                          want[k].view(np.uint16), err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _copy_split(root, split, dst):
    """A private copy of root/split (no cache) under dst; returns dst."""
    shutil.copytree(os.path.join(root, split), os.path.join(dst, split),
                    ignore=shutil.ignore_patterns("nbin_cache"))
    return str(dst)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_packer_matches_python_and_jax(synth_root, tmp_path, dtype):
    root = _copy_split(synth_root, "val", tmp_path)
    ds = SegmentDataset(root, "val", 8, 6, 64, 3, with_gt=True,
                        transfer_dtype=dtype)
    idxs = [0, 3, 5, 1]
    before = N.packs["packer_pack"]
    got = N.NativePacker(ds).pack(idxs)
    assert N.packs["packer_pack"] == before + 1
    assert got["feats"].dtype == np.dtype(dtype)
    _equal(got, _python_batch(ds, idxs))
    jds = JSegmentDataset(root, "val", 8, 6, 64, 3, with_gt=True,
                          transfer_dtype=dtype)
    _equal(got, J.NativePacker(jds).pack(idxs))


def test_single_bucket_below_max_frames(synth_root, tmp_path):
    root = _copy_split(synth_root, "val", tmp_path)
    ds = SegmentDataset(root, "val", 8, 6, 64, 3, with_gt=True,
                        frame_buckets=(5,))
    got = N.NativePacker(ds).pack([0, 3, 5, 1])
    assert got["feats"].shape[1] == 5
    _equal(got, _python_batch(ds, [0, 3, 5, 1]))


def test_loader_packs_every_bucket(synth_root, tmp_path):
    """Several buckets through BatchLoader(use_native=True): every batch
    of an epoch equals the Python loader's, at its bucket's T; a batch
    that mixes buckets raises."""
    root = _copy_split(synth_root, "train", tmp_path)
    ds = SegmentDataset(root, "train", 8, 6, 64, 3, frame_buckets=(4, 8))
    py = BatchLoader(ds, 4, seed=3)
    nat = BatchLoader(ds, 4, seed=3, use_native=True)
    assert nat._native is not None
    seen = set()
    for a, b in zip(py.epoch(0), nat.epoch(0)):
        _equal(b, a)
        seen.add(a["feats"].shape[1])
    assert seen == {4, 8}
    small = next(i for i in range(len(ds)) if ds.bucket_of(i) == 4)
    big = next(i for i in range(len(ds)) if ds.bucket_of(i) == 8)
    with pytest.raises(ValueError, match="homogeneous"):
        nat._native.pack([small, big])


def test_ragged_region_mask_and_ground_truth(tmp_path):
    """The v3 layout with a region-mask block and a GT block in one file,
    at ragged frame counts."""
    split = tmp_path / "rm" / "val"
    split.mkdir(parents=True)
    rng = np.random.RandomState(0)
    lines = []
    for n, t in enumerate((5, 3, 8)):
        np.savez(split / f"s{n}.npz",
                 feats=rng.randn(t, 6, 16).astype(np.float32),
                 boxes=rng.rand(t, 6, 4).astype(np.float32),
                 word_ids=rng.randint(0, 67, (3,)).astype(np.int32),
                 region_mask=(rng.rand(t, 6) > 0.4).astype(np.float32),
                 gt_boxes=rng.rand(3, t, 4).astype(np.float32),
                 gt_mask=(rng.rand(3, t) > 0.5).astype(np.float32))
        lines.append({"id": f"s{n}", "file": f"s{n}.npz", "num_frames": t,
                      "num_words": 3})
    (split / "index.jsonl").write_text(
        "\n".join(json.dumps(x) for x in lines) + "\n")
    ds = SegmentDataset(str(tmp_path / "rm"), "val", 8, 6, 16, 3,
                        with_gt=True)
    _equal(N.NativePacker(ds).pack([2, 0, 1]), _python_batch(ds, [2, 0, 1]))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_special_values_convert_as_numpy_does(tmp_path, dtype):
    """inf, NaN payloads, subnormal edges, ties and overflow: feats bit for
    bit numpy's (ml_dtypes') astype."""
    split = tmp_path / "sv" / "val"
    split.mkdir(parents=True)
    bits = np.asarray([
        0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001, 0x7F801FFF,
        0xFFB46FEB, 0x7FC00001, 0x33800000, 0x33800001, 0x38000000,
        0x477FF000, 0x477FF001, 0xC77FF000, 0x3F800001, 0x3F807FFF,
        0x3F808000, 0x00000001, 0x80000001, 0x00000000, 0x80000000],
        np.uint32)
    pad = np.random.RandomState(7).randint(0, 2 ** 32, 4 * 6 * 16 - bits.size,
                                           np.uint64).astype(np.uint32)
    feats = np.concatenate([bits, pad]).view(np.float32).reshape(4, 6, 16)
    np.savez(split / "s0.npz", feats=feats,
             boxes=np.zeros((4, 6, 4), np.float32),
             word_ids=np.zeros((2,), np.int32))
    (split / "index.jsonl").write_text(json.dumps(
        {"id": "s0", "file": "s0.npz", "num_frames": 4, "num_words": 2})
        + "\n")
    ds = SegmentDataset(str(tmp_path / "sv"), "val", 4, 6, 16, 2,
                        transfer_dtype=dtype)
    got = N.NativePacker(ds).pack([0])["feats"][0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = feats.astype(np.dtype(dtype))
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


def test_damaged_cache_is_rejected(synth_root, tmp_path):
    """A .nbin cut inside its GT block, or whose feature width disagrees
    with the dataset's, raises instead of packing zeros or a prefix."""
    root = _copy_split(synth_root, "val", tmp_path)
    ds = SegmentDataset(root, "val", 8, 6, 64, 3, with_gt=True)
    packer = N.NativePacker(ds)
    packer.pack([0])
    victim = os.path.join(ds.dir, "nbin_cache", ds.index[0]["id"] + ".nbin")
    blob = open(victim, "rb").read()
    t, r, d, k = np.frombuffer(blob[8:24], np.int32)
    open(victim, "wb").write(blob[:len(blob) - (4 + 4 * (k * t * 4 + k * t))])
    with pytest.raises(IOError):
        packer.pack([0])
    hdr = np.frombuffer(blob[:24], np.int32).copy()
    hdr[4] = d * 2
    open(victim, "wb").write(hdr.tobytes() + blob[24:])
    with pytest.raises(IOError):
        packer.pack([0])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_cache(synth_root, tmp_path, writer):
    """The .nbin files are the reference's byte for byte: a cache written
    by one package is read, unchanged, by the other."""
    root = _copy_split(synth_root, "val", tmp_path)
    ds = SegmentDataset(root, "val", 8, 6, 64, 3, with_gt=True)
    jds = JSegmentDataset(root, "val", 8, 6, 64, 3, with_gt=True)
    first, second = ((J.NativePacker(jds), lambda: N.NativePacker(ds))
                     if writer == "jax" else
                     (N.NativePacker(ds), lambda: J.NativePacker(jds)))
    cache = os.path.join(root, "val", "nbin_cache")
    written = {f: open(os.path.join(cache, f), "rb").read()
               for f in os.listdir(cache) if f.endswith(".nbin")}
    stamps = {f: os.stat(os.path.join(cache, f)).st_mtime_ns
              for f in written}
    reader = second()
    for f in written:     # not rewritten by the reader
        assert os.stat(os.path.join(cache, f)).st_mtime_ns == stamps[f]
    idxs = [4, 0, 7]
    _equal(reader.pack(idxs), first.pack(idxs))
    _equal(reader.pack(idxs), _python_batch(ds, idxs))
    # ... and what the other package would have written is the same bytes
    other = tmp_path / "other"
    _copy_split(synth_root, "val", other)
    (J.NativePacker if writer == "port" else N.NativePacker)(
        (JSegmentDataset if writer == "port" else SegmentDataset)(
            str(other), "val", 8, 6, 64, 3, with_gt=True))
    for f, blob in written.items():
        assert (other / "val" / "nbin_cache" / f).read_bytes() == blob, f


def test_loader_falls_back_when_the_packer_cannot_build(synth_root,
                                                        monkeypatch):
    def broken():
        raise RuntimeError("no g++")

    monkeypatch.setattr(N, "load_library", broken)
    ds = SegmentDataset(synth_root, "train", 8, 6, 64, 3)
    with pytest.warns(UserWarning, match="native IO packer unavailable"):
        loader = BatchLoader(ds, 4, seed=3, use_native=True)
    assert loader._native is None
    _equal(next(iter(loader)), next(iter(BatchLoader(ds, 4, seed=3))))


def test_fit_packs_natively_by_default(synth_root, tmp_path):
    from nafae_torch import train as TT
    from tests.test_torch_train import _cfgs

    _, tc = _cfgs(synth_root, "config4", [f"train.ckpt_dir={tmp_path}/n",
                                          "train.steps=2"])
    assert tc.data.use_native_io
    before = N.packs["packer_pack"]
    TT.fit(tc, device="cpu")
    assert N.packs["packer_pack"] >= before + 2
