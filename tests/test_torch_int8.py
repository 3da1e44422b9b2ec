"""The port's int8 inference compute against the JAX package.

The same numpy inputs and parameters, made from seeds, go through
`nafae_tpu.ops.grounding`'s int8 functions and their counterparts in
`nafae_torch.ops.grounding` on the CPU: quantized weights, features and
scales must be equal bit for bit, the int8 x int8 -> int32 products
exactly equal (also at D = 2048, where an f32 sum of the same products is
not exact), and the projections within rtol 1e-5 / atol 1e-6 (JAX at
Precision.HIGHEST). Also: `project_params`' three-way dispatch, the
quantized pair held by GroundingModel, SegmentDataset(keep_int8=True)
batches, and `evaluate_config` with model.quantize=int8 / int8pre (the
JAX package's dict; the golden counts of tests/test_e2e.py).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nafae_torch.config as tcfg
from nafae_tpu.data import BatchLoader as JLoader
from nafae_tpu.data import SegmentDataset as JDataset
from nafae_tpu.extract import quantize_feats_np as j_quantize_feats_np
from nafae_tpu.ops import grounding as G
from nafae_torch.data.loader import BatchLoader as TLoader
from nafae_torch.data.youcook2 import SegmentDataset as TDataset
from nafae_torch.extract import quantize_feats_np
from nafae_torch.models.grounding import (QUANT_BUFFERS, GroundingModel,
                                          inference_params, params_from_jax)
from nafae_torch.ops import grounding as TG

F32 = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _weights(seed, d, e):
    rng = np.random.RandomState(seed)
    w = (rng.randn(d, e) / np.sqrt(d)).astype(np.float32)
    w[:, 0] = 0.0                       # an all-zero channel: scale 1e-12/127
    w[3 % d, 1] = 0.5                   # a channel whose max is exact
    return w


def _feats(seed, shape):
    rng = np.random.RandomState(seed)
    f = (rng.randn(*shape) * 2).astype(np.float32)
    f[0, 0, 0] = 0.0                    # an all-zero region row
    # values at .5 steps of their row's scale: round half to even decides
    f[0, 0, 1] = np.linspace(-127, 127, shape[-1]).astype(np.float32)
    return f


@pytest.mark.parametrize("d,e,seed", [(16, 8, 0), (64, 32, 1),
                                      (2048, 256, 2)])
def test_quantize_weight_int8_is_jax_bit_for_bit(d, e, seed):
    w = _weights(seed, d, e)
    q, s = TG.quantize_weight_int8(_t(w))
    jq, js = G.quantize_weight_int8(jnp.asarray(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.stride() == (1, d)         # column-major for cuBLASLt


@pytest.mark.parametrize("shape,seed", [((2, 3, 4, 16), 0),
                                        ((1, 2, 5, 2048), 1)])
def test_quantize_feats_int8_is_jax_bit_for_bit(shape, seed):
    f = _feats(seed, shape)
    q, s = TG.quantize_feats_int8(_t(f))
    jq, js = G.quantize_feats_int8(jnp.asarray(f))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # the host-side ingest quantizer (extract.quantize_feats_np) gives the
    # same values, per segment, in both packages
    for b in range(shape[0]):
        nq, ns = quantize_feats_np(f[b])
        jnq, jns = j_quantize_feats_np(f[b])
        np.testing.assert_array_equal(nq, q[b].numpy())
        np.testing.assert_array_equal(ns, s[b, ..., 0].numpy())
        np.testing.assert_array_equal(nq, jnq)
        np.testing.assert_array_equal(ns, jns)


@pytest.mark.parametrize("m,k,n", [(5, 16, 8), (40, 2048, 24), (5, 2048, 50)])
def test_int8_matmul_is_exact(m, k, n):
    """Equal to JAX's int8 x int8 -> int32 dot_general and to numpy's int64
    product. At K = 2048 with operands near ±127 one sum is an odd number
    past 2^24, which no f32 holds."""
    rng = np.random.RandomState(k)
    a = rng.randint(-127, 128, (m, k)).astype(np.int8)
    b = rng.randint(-127, 128, (k, n)).astype(np.int8)
    if k >= 2048:
        a[0] = 127
        b[:, 0] = 127
        b[1, 0] = 126                   # an odd sum past 2^24
    got = TG.int8_matmul(_t(a), _t(b))
    want = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b),
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))
    if k >= 2048:
        exact = int(a[0].astype(np.int64) @ b[:, 0].astype(np.int64))
        assert exact > 2 ** 24 and exact % 2    # no f32 holds it
        assert int(got[0, 0]) == exact
    # a column-major weight gives the same product
    np.testing.assert_array_equal(
        TG.int8_matmul(_t(a), TG.int8_weight(_t(b))).numpy(), got.numpy())


def test_int8_matmul_refuses_what_it_cannot_take():
    a = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        TG.int8_matmul(a.float(), torch.zeros(8, 8, dtype=torch.int8))
    with pytest.raises(ValueError, match="K"):
        TG.int8_matmul(a, torch.zeros(7, 8, dtype=torch.int8))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on "
                    "the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_int8_matmul_on_gpu(cuda_device):
    """torch._int_mm on the card equals the plain int64 product, also at
    shapes it does not take itself (M <= 16, N = 50), which int8_matmul
    zero-pads."""
    rng = np.random.RandomState(0)
    a = _t(rng.randint(-127, 128, (400, 2048)).astype(np.int8))
    for n in (256, 50):
        b = _t(rng.randint(-127, 128, (2048, n)).astype(np.int8))
        for rows in (a, a[:5], a[:16]):
            want = TG.int8_matmul(rows, b)
            for w in (b, TG.int8_weight(b)):
                got = TG.int8_matmul(rows.to(cuda_device), w.to(cuda_device))
                assert torch.equal(got.cpu(), want)


def _proj_inputs(seed, b=2, t=3, r=4, d=64, e=32):
    rng = np.random.RandomState(seed)
    return (_feats(seed, (b, t, r, d)), _weights(seed, d, e),
            (rng.randn(e) * 0.1).astype(np.float32))


@pytest.mark.parametrize("seed,d,e", [(0, 64, 32), (1, 2048, 256)])
def test_project_regions_int8_matches_jax(seed, d, e):
    f, w, bv = _proj_inputs(seed, d=d, e=e)
    q, s = TG.quantize_weight_int8(_t(w))
    jq, js = G.quantize_weight_int8(jnp.asarray(w))
    got = TG.project_regions_int8(_t(f), q, s, _t(bv))
    want = G.project_regions_int8(jnp.asarray(f), jq, js, jnp.asarray(bv))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # the dtype argument is ignored: the product is int8, the output f32
    assert torch.equal(TG.project_regions_int8(_t(f), q, s, _t(bv),
                                               dtype=torch.bfloat16), got)
    fq, fs = TG.quantize_feats_int8(_t(f))
    jfq, jfs = G.quantize_feats_int8(jnp.asarray(f))
    got_pre = TG.project_regions_int8_pre(fq, fs, q, s, _t(bv))
    want_pre = G.project_regions_int8_pre(jfq, jfs, jq, js, jnp.asarray(bv))
    np.testing.assert_allclose(got_pre.numpy(), np.asarray(want_pre), **F32)
    # [B,T,R] scales (the batch layout) read as [B,T,R,1]
    assert torch.equal(TG.project_regions_int8_pre(fq, fs[..., 0], q, s,
                                                   _t(bv)), got_pre)


def test_quantize_params_int8_matches_jax():
    f, w, bv = _proj_inputs(3)
    params = {"word_emb": np.ones((5, 32), np.float32), "w_v": w, "b_v": bv}
    got = TG.quantize_params_int8({k: _t(v) for k, v in params.items()})
    want = G.quantize_params_int8({k: jnp.asarray(v)
                                   for k, v in params.items()})
    assert set(got) == set(want) == {"word_emb", "b_v", "w_v.q8",
                                     "w_v.scale8"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("form", ["int8pre", "int8", "float32"])
def test_project_params_dispatch_matches_jax(form):
    f, w, bv = _proj_inputs(4)
    params = {"w_v": w, "b_v": bv}
    if form != "float32":
        params = {k: np.asarray(v) for k, v in
                  G.quantize_params_int8({k: jnp.asarray(v) for k, v in
                                          params.items()}).items()}
    feats, scale = f, None
    if form == "int8pre":
        q, s = G.quantize_feats_int8(jnp.asarray(f))
        feats, scale = np.asarray(q), np.asarray(s)[..., 0]
    want = G.project_params({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(feats),
                            feats_scale=None if scale is None
                            else jnp.asarray(scale))
    got = TG.project_params({k: _t(v) for k, v in params.items()}, _t(feats),
                            feats_scale=None if scale is None else _t(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_model_holds_the_quantized_pair():
    """GroundingModel takes the int8 pair in place of w_v (buffers under
    dot-free names, mapped back by param_dict), forwards feats_scale, and
    params_from_jax carries the int8 arrays unchanged."""
    cfg = tcfg.load_config(preset_name="config4", overrides=[
        "model.feat_dim=64", "model.embed_dim=32", "loss.ctx_window=2"])
    f, w, bv = _proj_inputs(5)
    rng = np.random.RandomState(5)
    qp = G.quantize_params_int8({"word_emb": jnp.asarray(
        rng.randn(67, 32).astype(np.float32)), "w_v": jnp.asarray(w),
        "b_v": jnp.asarray(bv)})
    params = params_from_jax(qp, "cpu")
    assert params["w_v.q8"].dtype == torch.int8
    np.testing.assert_array_equal(params["w_v.q8"].numpy(),
                                  np.asarray(qp["w_v.q8"]))
    model = GroundingModel.from_config(cfg, params)
    assert dict(model.named_buffers()).keys() == set(QUANT_BUFFERS.values())
    held = model.param_dict()
    assert set(held) == set(qp)
    for k in qp:
        np.testing.assert_array_equal(held[k].numpy(), np.asarray(qp[k]))
    with pytest.raises(KeyError, match="w_v"):
        GroundingModel.from_config(cfg, {k: v for k, v in params.items()
                                         if k != "w_v.scale8"})
    fq, fs = TG.quantize_feats_int8(_t(f))
    ids = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    fm, wm = torch.ones(2, 3), torch.ones(2, 2)
    out = model(fq, ids, fm, wm, feats_scale=fs[..., 0])
    want = G.ground_forward(qp, jnp.asarray(fq.numpy()), jnp.asarray(ids),
                            jnp.asarray(fm), jnp.asarray(wm),
                            temp=cfg.model.frame_attn_temp,
                            pool=cfg.model.frame_pool, ctx_window=2,
                            ctx_temp=cfg.loss.ctx_temp,
                            feats_scale=jnp.asarray(fs.numpy()))
    for k in ("v_emb", "s", "u", "score", "beta"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **F32)
    # inference_params quantizes once, and passes a quantized dict through
    cfg.model.quantize = "int8"
    once = inference_params(cfg, {"w_v": _t(w), "b_v": _t(bv)})
    assert set(once) == {"b_v", "w_v.q8", "w_v.scale8"}
    assert inference_params(cfg, once) is once


def _int8_root(synth_root, tmp_path):
    """The val fixture rewritten as `extract --quantize int8` files."""
    root8 = str(tmp_path / "synth8")
    shutil.copytree(synth_root, root8)
    val = os.path.join(root8, "val")
    for name in os.listdir(val):
        if name.endswith(".npz"):
            p = os.path.join(val, name)
            with np.load(p) as z:
                arrays = {k: z[k] for k in z.files}
            arrays["feats"], arrays["feats_scale"] = quantize_feats_np(
                arrays["feats"].astype(np.float32))
            np.savez(p, **arrays)
    return root8


def test_keep_int8_batches_match_jax(synth_root, tmp_path):
    """int8 files pass through as int8 with their scales (padded slots at
    scale 0), batch for batch equal to the JAX package's loader; a float
    file raises the reference's error."""
    root8 = _int8_root(synth_root, tmp_path)
    args = (root8, "val", 8, 6, 64, 3)
    tl = TLoader(TDataset(*args, with_gt=True, keep_int8=True), 5,
                 shuffle=False, drop_remainder=False)
    jl = JLoader(JDataset(*args, with_gt=True, keep_int8=True), 5,
                 shuffle=False, drop_remainder=False)
    n = 0
    for got, want in zip(tl, jl):
        assert got["feats"].dtype == np.int8
        assert got["feats_scale"].shape == got["feats"].shape[:3]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        pad = got["frame_mask"] == 0
        assert not got["feats_scale"][pad].any()
        n += 1
    assert n == 3
    with pytest.raises(ValueError, match="needs int8 feature files"):
        TDataset(synth_root, "val", 8, 6, 64, 3, keep_int8=True)[0]
