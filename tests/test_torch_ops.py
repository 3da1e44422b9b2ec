"""The port's grounding ops (nafae_torch.ops) against the JAX reference.

The same numpy inputs, made from a seed, go through each JAX function and
its PyTorch counterpart on the CPU. f32 is held at rtol 1e-5 / atol 1e-6
(the reference runs f32 at Precision.HIGHEST; only summation order
differs); bf16 at 2e-2 (both sides round the same operands to bf16 and sum
in f32, so the gap is rounding-boundary flips, far inside the bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafae_tpu.ops import grounding as G
from nafae_tpu.ops import iou as I
from nafae_torch.ops import grounding as TG
from nafae_torch.ops import iou as TI

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}
B, T, R, D, E, K, V = 3, 7, 5, 16, 8, 3, 11


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), err_msg=msg,
                               **tol)


def _inputs(seed=0, similarity="cosine", pool="attention"):
    rng = np.random.RandomState(seed)
    params = {"word_emb": rng.randn(V, E).astype(np.float32),
              "w_v": (rng.randn(D, E) / 4).astype(np.float32),
              "b_v": (rng.randn(E) * 0.1).astype(np.float32)}
    if similarity == "bilinear":
        params["m_sim"] = (np.eye(E) + 0.1 * rng.randn(E, E)).astype(
            np.float32)
    if pool == "learned":
        params["attn_w"] = rng.randn(E).astype(np.float32)
    fm = (rng.rand(B, T) > 0.3).astype(np.float32)
    fm[:, 0] = 1.0
    wm = (rng.rand(B, K) > 0.3).astype(np.float32)
    wm[:, 0] = 1.0
    rm = (rng.rand(B, T, R) > 0.3).astype(np.float32)
    rm[0, 1, :] = 0.0                 # a valid frame with no valid region
    fm[0, 1] = 1.0
    return dict(params=params,
                feats=rng.randn(B, T, R, D).astype(np.float32),
                ids=rng.randint(0, V, (B, K)).astype(np.int32),
                fm=fm, wm=wm, rm=rm)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("similarity", ["cosine", "bilinear"])
@pytest.mark.parametrize("pool", ["attention", "mean", "context", "learned"])
def test_ground_forward_matches_jax(pool, similarity, dtype):
    """Every output of the serving forward, per pool and similarity form,
    with a region mask that empties one valid frame."""
    jdt, tdt, tol = DTYPES[dtype]
    x = _inputs(1, similarity, pool)
    kw = dict(pool=pool, temp=0.1,
              ctx_window=2 if pool == "context" else 0, ctx_temp=0.1)
    want = G.ground_forward(
        {k: jnp.asarray(v) for k, v in x["params"].items()},
        jnp.asarray(x["feats"]), jnp.asarray(x["ids"]), jnp.asarray(x["fm"]),
        jnp.asarray(x["wm"]), compute_dtype=jdt,
        region_mask=jnp.asarray(x["rm"]), **kw)
    got = TG.ground_forward(
        {k: _t(v) for k, v in x["params"].items()}, _t(x["feats"]),
        _t(x["ids"]), _t(x["fm"]), _t(x["wm"]), compute_dtype=tdt,
        region_mask=_t(x["rm"]), **kw)
    expect = {"w_emb", "v_emb", "s", "a", "score", "beta"}
    if pool == "context":
        expect |= {"u", "nbr_valid", "shat", "ahat"}
    assert set(got) == expect
    for k in expect:
        _close(got[k], want[k], tol, k)


@pytest.mark.parametrize("m_sim", [False, True])
def test_embed_words_matches_jax(m_sim):
    x = _inputs(2, "bilinear" if m_sim else "cosine")
    emb, ids = x["params"]["word_emb"], x["ids"]
    ms = x["params"].get("m_sim")
    want = G.embed_words(jnp.asarray(ids), jnp.asarray(emb),
                         None if ms is None else jnp.asarray(ms))
    got = TG.embed_words(_t(ids), _t(emb), None if ms is None else _t(ms))
    _close(got, want, F32)


def test_embed_words_take_semantics():
    """Out-of-range ids follow jnp.take: [-V, 0) wraps, anything else is a
    NaN row (never a clamp, never an indexing error)."""
    emb = np.random.RandomState(3).randn(V, E).astype(np.float32)
    ids = np.array([[-1, V, V + 3, -V, -V - 1, 0]], np.int32)
    want = np.asarray(G.embed_words(jnp.asarray(ids), jnp.asarray(emb)))
    got = TG.embed_words(_t(ids), _t(emb)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0, 1:3]).all() and np.isnan(got[0, 4]).all()
    np.testing.assert_allclose(got, want, equal_nan=True, **F32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_project_and_similarity_match_jax(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x = _inputs(4)
    p = x["params"]
    v_j = G.project_regions(jnp.asarray(x["feats"]), jnp.asarray(p["w_v"]),
                            jnp.asarray(p["b_v"]), dtype=jdt)
    v_t = TG.project_regions(_t(x["feats"]), _t(p["w_v"]), _t(p["b_v"]),
                             dtype=tdt)
    _close(v_t, v_j, tol, "v_emb")
    w = np.asarray(G.embed_words(jnp.asarray(x["ids"]),
                                 jnp.asarray(p["word_emb"])))
    v = np.asarray(v_j)
    cdt_j, cdt_t = (None, None) if dtype == "float32" else (jdt, tdt)
    s_j = G.similarity_tensor(jnp.asarray(w), jnp.asarray(v), dtype=cdt_j)
    s_t = TG.similarity_tensor(_t(w), _t(v), dtype=cdt_t)
    assert s_t.dtype == torch.float32          # f32 output in bf16 mode too
    _close(s_t, s_j, tol, "s")


def test_project_params_refuses_int8():
    """int8 features need the quantized params and their scales, as in the
    JAX package (which asserts); with both, the int8pre projection runs
    and matches JAX's (tests/test_torch_int8.py holds the other forms)."""
    x = _inputs(5)
    p = {k: _t(v) for k, v in x["params"].items()}
    q, s = TG.quantize_feats_int8(_t(x["feats"]))
    with pytest.raises(ValueError, match="int8 features need quantized"):
        TG.project_params(p, q, feats_scale=s)
    qp = TG.quantize_params_int8(p)
    with pytest.raises(ValueError, match="int8 features need quantized"):
        TG.project_params(qp, q)
    jq = G.quantize_params_int8({k: jnp.asarray(v)
                                 for k, v in x["params"].items()})
    want = G.project_params(jq, jnp.asarray(q.numpy()),
                            feats_scale=jnp.asarray(s.numpy()))
    _close(TG.project_params(qp, q, feats_scale=s), want, F32)


def test_masking_pooling_and_scores_match_jax():
    """mask_regions (diag and 5-D cross layouts), frame_mil_max,
    frame_attention (mean and softmax), _masked_word_mean,
    learned_frame_logits (with and without a region mask), video_scores
    and extend_for_window."""
    rng = np.random.RandomState(6)
    x = _inputs(6)
    s = rng.randn(B, K, T, R).astype(np.float32)
    cross = rng.randn(B, 2, K, T, R).astype(np.float32)
    rm, fm, wm = x["rm"], x["fm"], x["wm"]
    for arr in (s, cross):
        _close(TG.mask_regions(_t(arr), _t(rm)),
               G.mask_regions(jnp.asarray(arr), jnp.asarray(rm)), F32)
    s_t = _t(s)
    assert TG.mask_regions(s_t, None) is s_t
    a_j = G.frame_mil_max(G.mask_regions(jnp.asarray(s), jnp.asarray(rm)),
                          jnp.asarray(fm))
    a_t = TG.frame_mil_max(TG.mask_regions(_t(s), _t(rm)), _t(fm))
    _close(a_t, a_j, F32, "a")
    g = rng.randn(B, T).astype(np.float32)
    for pool in ("mean", "attention"):
        _close(TG.frame_attention(_t(g), _t(fm), 0.1, pool),
               G.frame_attention(jnp.asarray(g), jnp.asarray(fm), 0.1, pool),
               F32, pool)
    _close(TG._masked_word_mean(a_t, _t(wm)),
           G._masked_word_mean(a_j, jnp.asarray(wm)), F32)
    v = rng.randn(B, T, R, E).astype(np.float32)
    attn = rng.randn(E).astype(np.float32)
    for m in (rm, None):
        _close(TG.learned_frame_logits(_t(v), _t(fm),
                                       None if m is None else _t(m),
                                       _t(attn)),
               G.learned_frame_logits(jnp.asarray(v), jnp.asarray(fm),
                                      None if m is None else jnp.asarray(m),
                                      jnp.asarray(attn)), F32, "learned")
    for pool in ("attention", "mean", "context"):
        fl = g if pool == "context" else None
        got = TG.video_scores(a_t, _t(wm), _t(fm), 0.1, pool,
                              None if fl is None else _t(fl))
        want = G.video_scores(a_j, jnp.asarray(wm), jnp.asarray(fm), 0.1,
                              pool, None if fl is None else jnp.asarray(fl))
        for gt, wt in zip(got, want):
            _close(gt, wt, F32, pool)
    ext_t = TG.extend_for_window(_t(v), _t(fm), _t(rm), 3)
    ext_j = G.extend_for_window(jnp.asarray(v), jnp.asarray(fm),
                                jnp.asarray(rm), 3)
    for gt, wt in zip(ext_t, ext_j):
        np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    assert TG.extend_for_window(_t(v), _t(fm), None, 3)[2] is None


def _boxes(rng, shape):
    xy = rng.uniform(0, 50, shape + (2,))
    wh = rng.uniform(0, 30, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_box_iou_matches_jax():
    rng = np.random.RandomState(7)
    a, b = _boxes(rng, (40,)), _boxes(rng, (40,))
    b[:5] = a[:5]                                    # identical boxes
    a[5:8, 2:] = a[5:8, :2]                          # zero-area boxes
    b[8:10] = b[8:10] + 1000.0                       # disjoint boxes
    got = TI.box_iou(_t(a), _t(b))
    want = I.box_iou(jnp.asarray(a), jnp.asarray(b))
    _close(got, want, F32)
    np.testing.assert_array_equal(got[5:10].numpy(), 0.0)
    _close(TI.box_iou(_t(a[:, None]), _t(b[None])),
           I.pairwise_iou(jnp.asarray(a), jnp.asarray(b)), F32, "pairwise")


def test_grounding_hits_matches_jax():
    """Argmax region (first index on exact ties), the exact box of that
    region (non-finite coordinates in other slots read as 0), IoU > 0.5."""
    rng = np.random.RandomState(8)
    s = rng.randn(B, K, T, R).astype(np.float32)
    s[..., 3] = s[..., 1] = s.max(-1) + 1.0          # exact ties: 1 wins
    s[0, 0, 0] = rng.randn(R)
    boxes = _boxes(rng, (B, T, R))
    boxes[0, 0, 4] = [np.nan, np.inf, -np.inf, 3.0]  # dead slot
    gt = boxes[:, None, :, 1] + rng.uniform(-4, 4, (B, K, T, 4)).astype(
        np.float32)
    gm = (rng.rand(B, K, T) > 0.2).astype(np.float32)
    got = TI.grounding_hits(_t(s), _t(boxes), _t(gt), _t(gm))
    want = I.grounding_hits(jnp.asarray(s), jnp.asarray(boxes),
                            jnp.asarray(gt), jnp.asarray(gm))
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    assert 0 < got[0].sum() < got[1].sum()
    best = torch.argmax(_t(s), -1)
    picked = TI.select_boxes(best, _t(boxes)).numpy()
    ref = np.take_along_axis(boxes[:, None], best.numpy()[..., None, None]
                             .repeat(4, -1), 3)[..., 0, :]
    np.testing.assert_array_equal(picked[1:], ref[1:])
