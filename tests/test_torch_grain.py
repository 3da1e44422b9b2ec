"""`data.pipeline=grain` in the port (nafae_torch.data.grain_loader), which
cannot import grain, against grain itself and the JAX package's
GrainLoader, on the CPU: the numpy `index_shuffle` equals grain's C++
`index_shuffle` for every n in 1..300 under several seeds (and at a few
sizes of wider blocks), the loader's batches equal the reference
GrainLoader's over epochs and a mid-epoch resume, with one bucket and
with two, and fit with the grain pipeline ends at the JAX package's
params (1e-5)."""

from dataclasses import replace

import numpy as np
import pytest

from nafae_torch.data import grain_loader as GL
from nafae_torch.data.youcook2 import SegmentDataset

ism = pytest.importorskip(
    "grain._src.python.experimental.index_shuffle.python."
    "index_shuffle_module")

SEEDS = (0, 7, 2 ** 31 + 5, 2 ** 32 - 1)


def _grain(n, seed, idx=None):
    idx = range(n) if idx is None else idx
    return [ism.index_shuffle(int(i), max_index=n - 1, seed=seed, rounds=4)
            for i in idx]


def _walks(cipher, ns):
    """For each n of ns, grain's cycle walk along `cipher` (a permutation)
    from every i < n: the first value < n after i on i's cycle."""
    order, cycle, seen = [], [], np.zeros(len(cipher), bool)
    for start in range(len(cipher)):
        x = start
        while not seen[x]:
            seen[x] = True
            order.append(x)
            cycle.append(start)
            x = cipher[x]
    order, cycle = np.asarray(order), np.asarray(cycle)
    for n in ns:
        keep = order < n
        vals, cid = order[keep], cycle[keep]
        _, first = np.unique(cid, return_index=True)
        nxt = np.empty_like(vals)
        nxt[:-1] = vals[1:]
        last = np.r_[first[1:], len(vals)] - 1     # each cycle's last point
        nxt[last] = vals[first]                    # ... wraps to its first
        same = np.r_[cid[1:] == cid[:-1], False]
        nxt[~same] = vals[first][np.searchsorted(first, np.nonzero(~same)[0],
                                                 side="right") - 1]
        out = np.empty(n, np.int64)
        out[vals] = nxt
        yield n, out


@pytest.mark.parametrize("seed", SEEDS)
def test_index_shuffle_matches_grain(seed):
    """Every n of 1..300 shuffles in grain's 16-bit block: its cipher is
    grain's values at max_index 2**16 - 1 (no walk), and grain's walk from
    i is the first value below n after i on i's cycle of that cipher.
    Held: the port's values against those walks for every n, against
    grain's own index_shuffle at eight n (the walk included), and at three
    sizes of wider blocks (18 and 20 bits, and 22 past the port's table)."""
    cipher = np.asarray(_grain(1 << 16, seed), np.int64)
    np.testing.assert_array_equal(GL.index_shuffle(1 << 16, seed), cipher)
    for n, walked in _walks(cipher, range(1, 301)):
        assert GL.index_shuffle(n, seed).tolist() == walked.tolist(), n
    for n in (1, 2, 3, 4, 17, 100, 256, 300):
        assert GL.index_shuffle(n, seed).tolist() == _grain(n, seed), n
    for n in (70001, 300000, 3 << 20):
        idx = np.random.RandomState(n).randint(0, n, 64)
        assert GL.index_shuffle(n, seed)[idx].tolist() == \
            _grain(n, seed, idx), n


@pytest.mark.parametrize("buckets", [(), (4, 8)], ids=["one-bucket",
                                                        "two-buckets"])
def test_loader_matches_the_reference_grain_loader(synth_root, buckets):
    from nafae_tpu.data import SegmentDataset as JSegmentDataset
    from nafae_tpu.data.grain_loader import GrainLoader as JGrainLoader

    ds = SegmentDataset(synth_root, "train", 8, 6, 64, 3,
                        frame_buckets=buckets)
    jds = JSegmentDataset(synth_root, "train", 8, 6, 64, 3,
                          frame_buckets=buckets)
    mine, ref = GL.GrainLoader(ds, 4, seed=3), JGrainLoader(jds, 4, seed=3)
    assert mine.batches_per_epoch() == ref.batches_per_epoch()
    n = mine.batches_per_epoch() + 3
    for start, skip in ((0, 0), (1, 2)):
        got = [b for _, b in mine.steps(n, start, skip)]
        want = [b for _, b in ref.steps(n, start, skip)]
        assert len(got) == len(want) == n
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_fit_with_grain_matches_jax(synth_root, tmp_path, monkeypatch):
    from nafae_tpu import train as JT
    from nafae_torch import train as TT
    from nafae_torch.models.grounding import state_from_jax
    from tests.test_torch_train import _cfgs, _start

    jc, tc = _cfgs(synth_root, "config4", [
        "data.pipeline=grain", "train.steps=3", "loss.kmeans_interval=2"])
    jc = replace(jc, train=replace(jc.train, ckpt_dir=str(tmp_path / "j")))
    tc = replace(tc, train=replace(tc.train, ckpt_dir=str(tmp_path / "t")))
    js, _ = _start(jc)
    monkeypatch.setattr(TT.TrainState, "create",
                        classmethod(lambda cls, cfg, device=None, seed=None:
                                    state_from_jax(js, "cpu")))
    jstate, _ = JT.fit(jc, None)
    tstate, _ = TT.fit(tc, device="cpu")
    assert tstate.step == int(jstate.step) == 3
    for k, v in jstate.params.items():
        np.testing.assert_allclose(tstate.params[k].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
