"""The fused route's kernels (K3, K4f, K4b), RoIAlign (K5) and the
detector at float16 in the port against the JAX package run at float16.

The JAX package trains with train.kernels=pallas at model.dtype=float16
(its fused kernels take the operands' dtype and run their dots at HIGHEST
there, fused_ground.py:74-79) and runs detector.dtype=float16 (every conv,
FrozenBN and head cast to it; its RoIAlign kernel rounds its weights to the
feature's dtype). JAX's CPU backend runs f16 dots and convolutions and
interprets the Pallas kernels at f16, so the port's f16 is held to JAX's
f16. Every limit comes with a control, the port's bf16 on the same inputs,
that must fall outside it.

- K3 (`cross_mil`, its plain version here) against `fused_ground.cross_mil`
  interpreted at f16: a within rtol 1e-5 / atol 1e-5 (f16 products are exact
  in f32, both sides sum them in f32), idx equal where the top two scores
  are clear of ties (1e-4); CrossMil's gradients, rounded to f16 by both
  sides, ||err|| / ||want|| within 2e-4 and max |err| within 2e-3 of the
  largest entry.
- K4f / K4b (`diag_epilogue`) against `fused_diag.diag_epilogue_pallas`
  interpreted at f16: ctx, clu and f, and dw, dv of a masked weighted sum
  of ctx and clu, with the cotangents as they come and scaled by 2e-5, the
  config-4 step's scale, where ds = 2·dctx·d is an f16 subnormal:
  ||err|| / ||want|| within 1e-5 and max |err| within 1e-4 of the largest
  entry (both round where the TPU kernel rounds).
- K5 (`roi_align_plain`) against `roi_align_pallas` interpreted at f16, on
  tests/test_torch_roi_align.py's edge cases (but its banded map, the
  largest, whose banding only the CUDA kernel has): ||err|| / ||want||
  within 2e-4, max |err| within 1e-3 of the largest entry, and 90% of the
  outputs within rtol 1e-5 / atol 1e-5 (as at bf16, a weight near an f16
  midpoint may round the other way where XLA contracts a multiply-add).
- The detector at tests/test_torch_detector.py's SMALL size, at f16, with
  the same weights (drawn by the port, carried to JAX's tree by
  `_jax_tree`): C4 features within 4e-3 of the largest entry, the RPN
  scores of the survivors within 3e-3, the survivors equal and their boxes
  within 1e-3 of the image size, the pooled RoIs within 4e-3 and the head's
  features within 2e-3, each where JAX's surviving scores are clear of
  ties. f16 rounds every layer's output, in another order on each side:
  the port's f32 detector is as far from JAX's f16 one (1.5e-3 at C4).
- One inline config-5 training step at detector.dtype=float16 and
  model.dtype=float16 (tests/test_torch_inline.py's harness, the auto
  route): every metric within rtol 1e-3, l_ctx and score_pos within 1e-2
  (each small against the scores it is made of: a mean of squared
  differences of nearly equal scores, a mean of matched-pair scores near
  zero at random weights; the detector's f16 rounding moves them by 1.8e-3
  and 2.1e-3 of themselves, 5.5e-5 at most for the others); the port's
  bf16 step falls outside (l_ctx 1.9e-2, score_pos 8.0e-2, l_rank 1.1e-3).

The f16 CUDA kernels run only on a GPU: the `cuda` tests skip here, and
chip_smoke.py's phase 21 holds them on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nafae_tpu.config as jcfg
import nafae_torch.config as tcfg
from nafae_tpu import train as JT
from nafae_tpu.config import DetectorConfig as JDC
from nafae_tpu.models.detector.faster_rcnn import \
    FasterRCNNExtractor as JFRCNN
from nafae_tpu.models.detector.faster_rcnn import init_detector as j_init
from nafae_tpu.ops.pallas import fused_ground as FG
from nafae_tpu.ops.pallas.fused_diag import diag_epilogue_pallas
from nafae_tpu.ops.pallas.roi_align import roi_align_pallas
from nafae_torch import train as TT
from nafae_torch.config import DetectorConfig as TDC
from nafae_torch.models.detector.faster_rcnn import (FasterRCNNExtractor,
                                                     init_detector)
from nafae_torch.models.grounding import state_from_jax
from nafae_torch.ops.kernels import cross_mil as K3
from nafae_torch.ops.kernels import diag as D
from nafae_torch.ops.kernels import roi_align as K5
from tests import test_torch_cross_mil as CX
from tests import test_torch_detector as DT
from tests import test_torch_diag as DG
from tests import test_torch_inline as IL
from tests import test_torch_roi_align as RA

A_TOL = dict(rtol=1e-5, atol=1e-5)          # K3's a
K3_GRAD = (2e-4, 2e-3)                      # ||err||/||want||, max / max
K4_TOL = (1e-5, 1e-4)
K5_TOL = (2e-4, 1e-3)
STEP_DCTX = 2e-5                            # the config-4 step's dctx scale
DET_TOL = {"c4": 4e-3, "scores": 3e-3, "pooled": 4e-3, "feats": 2e-3}
BOX_TOL = 1e-3                              # of the image size
METRIC_RTOL = 1e-3
SMALL_METRIC_RTOL = 1e-2                    # l_ctx and score_pos
DTYPES = (torch.float16, torch.bfloat16)    # the port's f16, its control


def _gap(got, want):
    """(||got - want|| / ||want||, max |got - want| / max |want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return (np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30),
            np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _held(got, want, tol):
    rel, top = _gap(got, want)
    return rel <= tol[0] and top <= tol[1]


def _np(x):
    return x.detach().float().numpy()


@pytest.mark.parametrize("case", ["R20", "R33"])
def test_cross_mil_matches_the_tpu_kernel_at_f16(case):
    """R = 20 takes the TPU's roll-max kernel (K3b), R = 33 its lane-grouped
    one (K3a)."""
    w, v, fm, rm = CX._inputs(CX.SHAPES[case], True, seed=3)
    jfm, jrm = jnp.asarray(fm), jnp.asarray(rm)

    def loss_j(w_, v_):
        return jnp.sum(jnp.sin(FG.cross_mil(w_, v_, jfm, jrm,
                                            dtype=jnp.float16) * 1.7))

    a_j = np.asarray(FG.cross_mil(jnp.asarray(w), jnp.asarray(v), jfm, jrm,
                                  dtype=jnp.float16))
    g_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(v))
    got = {}
    for dt in DTYPES:
        wt = torch.from_numpy(w).requires_grad_()
        vt = torch.from_numpy(v).requires_grad_()
        a = K3.cross_mil(wt, vt, torch.from_numpy(fm), torch.from_numpy(rm),
                         dtype=dt)
        got[dt] = (_np(a), *(_np(g) for g in torch.autograd.grad(
            torch.sum(torch.sin(a * 1.7)), (wt, vt))))
    a16, gw, gv = got[torch.float16]
    np.testing.assert_allclose(a16, a_j, **A_TOL)
    assert not np.allclose(got[torch.bfloat16][0], a_j, **A_TOL)
    for g, want, ctrl in zip((gw, gv), g_j, got[torch.bfloat16][1:]):
        assert _held(g, want, K3_GRAD), _gap(g, want)
        assert _gap(ctrl, want)[0] > K3_GRAD[0]
    i, j, k, t, r, e = CX.SHAPES[case]
    w16 = torch.from_numpy(w).half().reshape(j * k, e)
    v16 = torch.from_numpy(v).half()
    _, idx = K3.cross_mil_plain(w16, v16, torch.from_numpy(fm),
                                torch.from_numpy(rm))
    _, idx_j = FG._cross_mil_fwd_impl(
        jnp.asarray(w16.numpy()), jnp.asarray(v16.numpy()), jfm, jrm)
    s = torch.where(torch.from_numpy(rm)[:, None] > 0, torch.einsum(
        "me,itre->imtr", w16.float(), v16.float()), K3.NEG)
    top = s.topk(2, dim=-1).values
    clear = (top[..., 0] - top[..., 1] > 1e-4).numpy()
    np.testing.assert_array_equal(idx.numpy()[clear],
                                  np.asarray(idx_j)[clear])


@pytest.mark.parametrize("case", ["ties_dead_video"])
def test_diag_epilogue_matches_the_tpu_kernel_at_f16(case):
    """Forward and backward (R = 36: two chunks of 32 regions, exact
    region and center ties across them, a video with no valid frame); the
    backward with the cotangents as they come and at the step's scale (ds
    an f16 subnormal: a kernel or a plain version that flushes it to zero
    loses all of dw and dv's ctx part)."""
    w, v, u, centers, fm, rm, hc, wm = DG._inputs(case, seed=len(case))
    args = [jnp.asarray(x) for x in (u, centers, fm, rm, hc)]

    def parts(w_, v_):
        return diag_epilogue_pallas(w_, v_, *args, dtype=jnp.float16)

    jw, jv = jnp.asarray(w), jnp.asarray(v)
    want = [np.asarray(x) for x in jax.jit(parts)(jw, jv)]
    for scale in (1.0, STEP_DCTX):
        want_g = jax.jit(jax.grad(lambda w_, v_: scale * DG._total(
            *parts(w_, v_)[:2], jnp.asarray(wm), args[2], jnp),
            argnums=(0, 1)))(jw, jv)
        got = {}
        for dt in DTYPES:
            wt = torch.from_numpy(w).requires_grad_()
            vt = torch.from_numpy(v).requires_grad_()
            out = D.diag_epilogue(wt, vt, *(torch.from_numpy(x) for x in
                                           (u, centers, fm, rm, hc)),
                                  dtype=dt)
            g = torch.autograd.grad(scale * DG._total(
                out[0], out[1], torch.from_numpy(wm), torch.from_numpy(fm),
                torch), (wt, vt))
            got[dt] = [_np(x) for x in (*out, *g)]
        for name, g, c, x in zip(("ctx", "clu", "f", "dw", "dv"),
                                 got[torch.float16], got[torch.bfloat16],
                                 [*want, *want_g]):
            assert _held(g, x, K4_TOL), (name, scale, _gap(g, x))
            assert _gap(c, x)[0] > K4_TOL[0], (name, scale)


@pytest.mark.parametrize("case", [c for c in RA.EDGE_CASES
                                  if c != "row_bands"])
def test_roi_align_matches_the_tpu_kernel_at_f16(case):
    """Every edge case but the banded map (the largest, 7 s here; nothing
    in the plain version depends on the kernel's banding)."""
    feat, boxes, scale, sr = RA._edge_case(case)
    jf = np.asarray(jnp.asarray(feat, jnp.float16))
    want = RA._jax_per_frame(roi_align_pallas, jf, boxes, scale,
                             sampling_ratio=sr)
    got = {dt: K5.roi_align(torch.from_numpy(feat).to(dt),
                            torch.from_numpy(boxes), 7, scale, sr).numpy()
           for dt in DTYPES}
    f16 = got[torch.float16]
    assert _held(f16, want, K5_TOL), _gap(f16, want)
    assert np.isclose(f16, want, rtol=1e-5, atol=1e-5).mean() >= 0.9
    assert _gap(got[torch.bfloat16], want)[0] > K5_TOL[0]


def _jax_tree(model, cfg: JDC) -> dict:
    """The flax params tree of the JAX detector for cfg, filled from the
    port's detector `model` (the inverse of detector_params_from_jax: OIHW
    conv kernels to HWIO, dense kernels transposed); its shapes from
    jax.eval_shape, so JAX draws no weights (its init runs the model)."""
    shapes = jax.eval_shape(lambda k: j_init(k, cfg)[1],
                            jax.random.PRNGKey(0))
    sd = model.state_dict()

    def leaf(path, sds):
        names = [p.key for p in path if p.key != "params"]
        *mod, key = names
        x = sd[".".join(mod) + "." + ("weight" if key == "kernel"
                                      else key)].numpy()
        if key == "kernel":
            x = x.transpose(2, 3, 1, 0) if x.ndim == 4 else x.T
        assert x.shape == sds.shape, (names, x.shape, sds.shape)
        return jnp.asarray(x)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_detector_matches_jax_at_f16():
    """The config-5 preset's routes (the full pool, greedy NMS and RoIAlign
    through the TPU kernels in JAX, their plain versions here)."""
    ov = dict(full_pool_nms=True, nms_impl="auto", roi_impl="pallas")
    jcfg_ = JDC(**DT.SMALL, **ov, dtype="float16")
    port32 = init_detector(TDC(**DT.SMALL, **ov),
                           torch.Generator().manual_seed(0), device="cpu")
    params = _jax_tree(port32, jcfg_)
    jm = JFRCNN(jcfg_, use_pallas_nms=True, use_pallas_roi_align=True)
    frames = np.random.RandomState(0).rand(3, 64, 64, 3).astype(np.float32)

    @jax.jit
    def run_j(p, x):
        c4 = jm.apply(p, x, method=lambda m, im: m.backbone(im))
        out = jm.apply(p, x)
        pooled = jax.vmap(lambda f, b: roi_align_pallas(f, b, 7, 1 / 16))(
            c4, out["boxes"])
        return c4, out, pooled

    c4_j, out_j, pooled_j = jax.tree.map(
        lambda x: np.asarray(x, np.float32 if x.dtype == jnp.float16
                             else x.dtype), run_j(params, jnp.asarray(frames)))
    pooled_j = pooled_j.reshape(-1, *pooled_j.shape[2:])
    clear = DT._clear_of_ties(out_j["scores"], out_j["region_valid"])
    assert clear.any()
    pooled_clear = np.repeat(clear, out_j["boxes"].shape[1])
    off = {}
    for dt in ("float16", "bfloat16"):
        tm = FasterRCNNExtractor(TDC(**DT.SMALL, **ov, dtype=dt)).eval()
        tm.load_state_dict(port32.state_dict())
        x = torch.from_numpy(frames)
        with torch.no_grad():
            c4 = tm.backbone(x)
            out = {k: v.numpy() for k, v in tm(x).items()}
            pooled = K5.roi_align(c4, torch.from_numpy(out["boxes"]), 7,
                                  1 / 16).numpy()
        assert c4.dtype == getattr(torch, dt)
        assert np.array_equal(out["region_valid"], out_j["region_valid"])
        gaps = {"c4": _gap(_np(c4), c4_j)[1],
                "scores": _gap(out["scores"][clear],
                               out_j["scores"][clear])[1],
                "pooled": _gap(pooled[pooled_clear],
                               pooled_j[pooled_clear])[1],
                "feats": _gap(out["feats"][clear], out_j["feats"][clear])[1]}
        box = np.abs(out["boxes"][clear] - out_j["boxes"][clear]).max() / 64
        off[dt] = [k for k, g in gaps.items() if g > DET_TOL[k]] + (
            ["boxes"] if box > BOX_TOL else [])
    assert not off["float16"], off
    assert set(off["bfloat16"]) == {*DET_TOL, "boxes"}, off


def test_inline_step_matches_jax_at_f16():
    d16 = ["detector.dtype=float16", "model.dtype=float16"]
    jc = jcfg.load_config(preset_name="config5", overrides=IL.OV + d16)
    port32 = init_detector(tcfg.load_config(preset_name="config5",
                                            overrides=IL.OV).detector,
                           torch.Generator().manual_seed(1), device="cpu")
    jm = JFRCNN(jc.detector)
    ext = (jm.apply, _jax_tree(port32, jc.detector))
    rng = np.random.RandomState(0)
    batch = {"frames": rng.rand(2, 3, 64, 64, 3).astype(np.float32),
             "word_ids": rng.randint(0, 67, (2, 3)).astype(np.int32),
             "frame_mask": np.array([[1, 1, 1], [1, 1, 0]], np.float32),
             "word_mask": np.array([[1, 1, 1], [1, 1, 0]], np.float32),
             "segment_id": np.arange(2, dtype=np.int32)}
    js = jax.tree.map(np.asarray, JT.TrainState.create(
        jax.random.PRNGKey(0), jc))
    _, mj = JT.build_train_fn(jc, None, extractor=ext)(
        jax.tree.map(jnp.asarray, js), {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    off = {}
    for dt in ("float16", "bfloat16"):
        tc = tcfg.load_config(preset_name="config5", overrides=IL.OV + [
            f"detector.dtype={dt}", f"model.dtype={dt}"])
        tdet = FasterRCNNExtractor(tc.detector).eval()
        tdet.load_state_dict(port32.state_dict())
        new, mt = TT.train_step(state_from_jax(js, "cpu"),
                                TT.batch_to_device(batch,
                                                   torch.device("cpu")),
                                tc, extractor=tdet)
        assert set(mt) == set(mj) and new.step == 1
        off[dt] = [k for k in mj if not np.isclose(
            float(mt[k]), float(mj[k]), atol=0,
            rtol=SMALL_METRIC_RTOL if k in ("l_ctx", "score_pos")
            else METRIC_RTOL)]
    assert not off["float16"], off
    assert off["bfloat16"], off


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py's phase 21 runs "
                    "this check on the GPU")
    return torch.device("cuda")


def _rel(x, y):
    return ((x.float() - y.float()).norm() / y.float().norm()).item()


@pytest.mark.cuda
def test_f16_cross_mil_matches_plain_on_gpu(cuda_device):
    """K3 on f16 operands (cross_mil_mma, and cross_mil_any at E = 50)
    against cross_mil_plain at f16: a within rtol 1e-5 / atol 1e-5, idx
    where clear of ties."""
    for shape in ((16, 128, 20, 20, 256), (4, 40, 6, 36, 50)):
        i, m, t, r, e = shape
        gen = torch.Generator().manual_seed(r)
        w = torch.nn.functional.normalize(torch.randn(m, e, generator=gen),
                                          dim=-1).half().to(cuda_device)
        v = torch.nn.functional.normalize(
            torch.randn(i, t, r, e, generator=gen), dim=-1
        ).half().to(cuda_device)
        fm = torch.ones(i, t, device=cuda_device)
        rm = (torch.rand(i, t, r, generator=gen) > 0.3).float().to(
            cuda_device)
        before = K3.launches["cross_mil"]
        a, idx = K3.launch(w, v, fm, rm)
        torch.cuda.synchronize()
        assert K3.launches["cross_mil"] == before + 1
        ap, idxp = K3.cross_mil_plain(w, v, fm, rm)
        torch.testing.assert_close(a, ap, **A_TOL)
        s = torch.where(rm[:, None] > 0, torch.einsum(
            "me,itre->imtr", w.float(), v.float()), K3.NEG)
        top = s.topk(2, dim=-1).values
        clear = top[..., 0] - top[..., 1] > 1e-4
        assert torch.equal(idx[clear], idxp[clear])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["config4_like", "k40", "e50"])
def test_f16_diag_matches_plain_on_gpu(cuda_device, case):
    """K4f against diag_fwd_plain and K4b against diag_bwd_plain on K4f's
    residuals, on f16 operands, dctx as drawn and at the step's scale:
    ||err|| / ||want|| within 1e-4 (chip_smoke.py's F16B_REL_CTX), the
    bf16 plain versions outside that."""
    w, v, u, centers, fm, rm, hc, _ = (
        torch.from_numpy(x).to(cuda_device)
        for x in DG._inputs(case, seed=len(case)))
    x16 = [x.half() for x in (w, v, u)]
    xbf = [x.bfloat16() for x in (w, v, u)]
    fwd = D.launch_fwd(*x16, centers, fm, hc, rm)
    torch.cuda.synchronize()
    want = D.diag_fwd_plain(*x16, centers, fm, hc, rm)
    ctrl = D.diag_fwd_plain(*xbf, centers, fm, hc, rm)
    for n in (0, 3):                             # ctx, d
        assert _rel(fwd[n], want[n]) <= 1e-4
        assert _rel(ctrl[n], want[n]) > 1e-4
    dctx = torch.rand(fwd[0].shape, device=cuda_device)
    dclu = torch.rand(fwd[1].shape, device=cuda_device)
    for scale in (1.0, STEP_DCTX):
        args = (centers, fwd[3], fwd[4], fwd[5], fwd[2], dctx * scale, dclu)
        got = D.launch_bwd(*x16[:2], *args)
        torch.cuda.synchronize()
        for g, p, c in zip(got, D.diag_bwd_plain(*x16[:2], *args),
                           D.diag_bwd_plain(*xbf[:2], *args)):
            assert _rel(g, p) <= 1e-4
            assert _rel(c, p) > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", RA.EDGE_CASES)
def test_f16_roi_align_matches_plain_on_gpu(cuda_device, case):
    """K5 on an f16 map against roi_align_plain at f16 (rtol 1e-5 / atol
    1e-6: the same f16 weights, f32 sums in another order)."""
    feat, boxes, scale, sr = RA._edge_case(case)
    tf = torch.from_numpy(feat).to(cuda_device, torch.float16)
    tb = torch.from_numpy(boxes).to(cuda_device)
    before = K5.launches["roi_align"]
    got = K5.roi_align(tf, tb, 7, scale, sr)
    torch.cuda.synchronize()
    assert K5.launches["roi_align"] == before + 1
    torch.testing.assert_close(got, K5.roi_align_plain(tf, tb, 7, scale, sr),
                               rtol=1e-5, atol=1e-6)
