"""The port's greedy NMS (nafae_torch.ops.nms, the plain version of the NMS
kernel K2, and its wrapper nafae_torch.ops.kernels.nms) against the JAX
package's `ops/nms.batched_nms` and the TPU kernel `nms_pallas` (interpret
mode, as tests/test_pallas.py runs it), on the same numpy boxes.

Held exactly: valid equal, and idx equal where valid (and 0 where not),
on random rows, ties of equal score, duplicate boxes, zero-area boxes, rows
with fewer survivors than num_keep, and boxes placed at IoU just above and
just below the threshold; and at the edges of the kernel's tiered walk
(`TIER_BOXES` candidates a tier): more copies of the top box than a tier
holds, equal scores straddling a tier's last candidate, rows that exhaust
beside boxes at or below -1e9, and a row shorter than a tier. The CUDA
kernel runs only on a GPU: the `cuda` test skips here, and chip_smoke.py
holds it against the plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafae_tpu.ops.nms import batched_nms as j_batched_nms
from nafae_tpu.ops.pallas.nms import nms_pallas
from nafae_torch.ops import nms as P
from nafae_torch.ops.kernels import nms as K


def _random(rng, b, n, size=80.0):
    xy = rng.rand(b, n, 2) * size
    wh = rng.rand(b, n, 2) * 40 + 2
    return (np.concatenate([xy, xy + wh], -1).astype(np.float32),
            rng.rand(b, n).astype(np.float32))


def _ties(rng):
    boxes, scores = _random(rng, 3, 60)
    scores = np.round(scores * 4) / 4            # 5 distinct values
    return boxes, scores.astype(np.float32)


def _duplicates(rng):
    boxes, scores = _random(rng, 3, 40)
    boxes[:, 10:20] = boxes[:, :10]              # exact copies, other scores
    scores[:, 20:25] = scores[:, 0:5]            # and exact score ties
    boxes[:, 20:25] = boxes[:, 0:5]
    return boxes, scores


def _zero_area(rng):
    boxes, scores = _random(rng, 2, 30)
    boxes[:, ::3, 2] = boxes[:, ::3, 0]          # zero width
    boxes[:, 1::5, 3] = boxes[:, 1::5, 1]        # zero height
    boxes[1] = 0.0                               # a row of all-zero boxes
    return boxes, scores


def _few_survivors(rng):
    base = np.array([10, 10, 50, 50], np.float32)
    boxes = np.tile(base, (2, 12, 1))
    boxes += rng.rand(2, 12, 4).astype(np.float32) * 0.5   # all overlap
    boxes[0, 6:] += 100.0                        # row 0: two clusters
    return boxes, rng.rand(2, 12).astype(np.float32)


def _threshold():
    """Row r: a winner [0,0,10,10] and a box [0,0,10,h] whose IoU with it is
    h / 10, for h one f32 step below, at and above 7 (IoU 0.7), plus far
    away filler boxes."""
    hs = [np.nextafter(np.float32(7), np.float32(0)), np.float32(7),
          np.nextafter(np.float32(7), np.float32(20)), np.float32(7.0001),
          np.float32(6.9999)]
    boxes = np.zeros((len(hs), 6, 4), np.float32)
    scores = np.zeros((len(hs), 6), np.float32)
    for r, h in enumerate(hs):
        boxes[r, 0] = [0, 0, 10, 10]
        boxes[r, 1] = [0, 0, 10, h]
        for j in range(2, 6):
            boxes[r, j] = [30 * j, 30 * j, 30 * j + 5, 30 * j + 5]
        scores[r] = [0.9, 0.8, 0.5, 0.4, 0.3, 0.2]
    return boxes, scores


def _over_tier_duplicates(rng):
    """More copies of the top box than a tier holds: the first winner kills
    the whole first tier, and the walk goes on in the next."""
    n = K.TIER_BOXES + 476
    boxes, scores = _random(rng, 2, n, size=300.0)
    copies = K.TIER_BOXES + 76
    at = rng.permutation(n)[:copies]
    boxes[:, at] = boxes[:, at[:1]]
    scores[:, at] = 2.0
    return boxes, scores


def _ties_at_tier_cut(rng):
    """More boxes share the top score than a tier holds, so the kernel cuts
    its tier inside the tie, by index: 100 more than a tier, copies of 10
    boxes spread over the row, then the rest below them."""
    n = 3 * K.TIER_BOXES
    boxes, scores = _random(rng, 2, n, size=300.0)
    tied = rng.permutation(n)[:K.TIER_BOXES + 100]
    boxes[:, tied] = boxes[:, tied[rng.randint(0, 10, size=tied.size)]]
    scores[:, tied] = 1.5
    return boxes, scores


def _exhausted_low(rng):
    """Rows that run out of boxes above -1e9 beside boxes at -1e9, below
    it and at -inf (box 0 always dies or reads -1e9, so the slot of the
    first invalid step holds index 0)."""
    boxes, scores = _random(rng, 3, 40)
    scores[0, 5:] = -1e9
    scores[1] = -2e9
    scores[1, 0] = -1e9
    scores[2, 1::2] = -np.inf
    scores[2, 2::4] = -3e9
    return boxes, scores


def _short_row(rng):
    """N below a tier: 400 boxes in 5 tight clusters, so the row exhausts
    after its first tier."""
    centres = rng.rand(5, 2).astype(np.float32) * 500
    pick = rng.randint(0, 5, size=(2, 400))
    xy = centres[pick] + rng.rand(2, 400, 2).astype(np.float32)
    boxes = np.concatenate([xy, xy + 60], -1).astype(np.float32)
    return boxes, rng.rand(2, 400).astype(np.float32)


CASES = {
    "random": lambda rng: _random(rng, 4, 200),
    "ties": _ties,
    "duplicates": _duplicates,
    "zero_area": _zero_area,
    "few_survivors": _few_survivors,
    "threshold": lambda rng: _threshold(),
    "over_tier_duplicates": _over_tier_duplicates,
    "ties_at_tier_cut": _ties_at_tier_cut,
    "exhausted_low": _exhausted_low,
    "short_row": _short_row,
}


def _check(got, want):
    gi, gv = (x.numpy() for x in got)
    wi, wv = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(np.where(wv > 0, gi, 0),
                                  np.where(wv > 0, wi, 0))
    np.testing.assert_array_equal(gi[wv == 0], 0)


@pytest.mark.parametrize("num_keep", [5, 20])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax(case, num_keep):
    boxes, scores = CASES[case](np.random.RandomState(3))
    iou = 0.7 if case == "threshold" else 0.5
    want_p = nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), num_keep,
                        iou)
    want_j = j_batched_nms(jnp.asarray(boxes), jnp.asarray(scores), num_keep,
                           iou)
    got = P.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                        num_keep, iou)
    _check(got, want_p)
    _check(got, want_j)
    # the wrapper takes the plain version for CPU tensors, planes or boxes
    _check(K.nms_boxes(torch.from_numpy(boxes), torch.from_numpy(scores),
                       num_keep, iou), want_p)


def test_threshold_cases_go_both_ways():
    """The threshold rows really sit on both sides of IoU 0.7: the box at
    IoU exactly 0.7 (and below) survives, the one a step above dies."""
    boxes, scores = _threshold()
    idx, valid = P.batched_nms(torch.from_numpy(boxes),
                               torch.from_numpy(scores), 6, 0.7)
    survived = [(1 in idx[r][valid[r] > 0].tolist()) for r in range(5)]
    assert survived == [True, True, False, False, True]


def test_threshold_compared_in_f32():
    """iou > thresh compares in f32 as JAX does: at thresh 0.1 (whose f32
    value is above 0.1) a box at IoU exactly float32(0.1) survives."""
    boxes = torch.tensor([[[0, 0, 10, 10], [0, 0, 10, 1]]], dtype=torch.float32)
    scores = torch.tensor([[0.9, 0.8]])
    got = P.batched_nms(boxes, scores, 2, 0.1)
    want = nms_pallas(jnp.asarray(boxes.numpy()), jnp.asarray(scores.numpy()),
                      2, 0.1)
    _check(got, want)
    assert got[1].tolist() == [[1.0, 1.0]]


def test_single_row_form():
    boxes, scores = _random(np.random.RandomState(0), 1, 50)
    idx, valid = P.nms(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]),
                       10, 0.5)
    want = j_batched_nms(jnp.asarray(boxes), jnp.asarray(scores), 10, 0.5)
    _check((idx[None], valid[None]), want)


def test_launch_rejects_what_the_kernel_does_not_take():
    z = torch.zeros(2, 5)
    with pytest.raises(ValueError, match="1 <= N"):
        K.launch(*(torch.zeros(2, 0),) * 5, 3)
    with pytest.raises(ValueError, match="x1 must be"):
        K.launch(z, z, z, z, torch.zeros(2, 6), 3)
    with pytest.raises(TypeError, match="float32"):
        K.launch(z, z, z, z, z.double(), 3)
    with pytest.raises(ValueError, match="num_keep"):
        K.launch(z, z, z, z, z, -1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.nms_planes(*(torch.zeros(2, 5, device="meta"),) * 5, 3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on "
                    "the GPU")
    return torch.device("cuda")


def _odd_scores(rng):
    """Scores the JAX functions disagree on among themselves, held only
    against the plain version: NaN (dead from the start, as -inf), -0 tied
    with +0, and an exhausted row whose first invalid slot is not 0: box 2,
    scored below -1e9, reads -1e9 once winner 11's IoU kills it."""
    boxes, scores = _random(rng, 3, 50)
    scores[0, ::3] = np.nan
    scores[1, ::2] = 0.0
    scores[1, 1::4] = -0.0
    scores[2] = -5e9
    scores[2, 7] = -1e9
    scores[2, 11:14] = 0.5
    boxes[2, 2] = boxes[2, 11]
    return boxes, scores


@pytest.mark.cuda
def test_kernel_matches_plain_on_gpu(cuda_device):
    """Every case above, NaN and signed-zero scores, a row of 60,000 boxes
    (past the keys a block keeps in registers) and one of 30,000 with ties
    across a tier's cut: survivors equal, one launch a call; the over-tier
    rows take more than one tier."""
    rng = np.random.RandomState(5)
    cases = {c: CASES[c](rng) for c in sorted(CASES)}
    cases["odd_scores"] = _odd_scores(rng)
    cases["60000"] = _random(rng, 2, 60_000, size=600.0)
    boxes, scores = _random(rng, 1, 30_000, size=600.0)
    tied = rng.permutation(30_000)[:K.TIER_BOXES + 76]
    boxes[:, tied] = boxes[:, tied[rng.randint(0, 10, size=tied.size)]]
    scores[:, tied] = 1.5
    cases["long_ties_at_tier_cut"] = boxes, scores
    for name, (boxes, scores) in cases.items():
        b = torch.from_numpy(boxes).to(cuda_device)
        s = torch.from_numpy(scores).to(cuda_device)
        before = K.launches["nms"]
        tiers = torch.zeros(s.shape[0], dtype=torch.int32, device=cuda_device)
        got = K.launch(*(b[..., c].contiguous() for c in range(4)), s, 20,
                       0.7, tiers=tiers)
        torch.cuda.synchronize()
        assert K.launches["nms"] == before + 1
        want = P.batched_nms(b, s, 20, 0.7)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            name
        if name in ("over_tier_duplicates", "ties_at_tier_cut",
                    "long_ties_at_tier_cut"):
            assert (tiers > 1).all(), (name, tiers)
