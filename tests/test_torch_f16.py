"""model.dtype=float16 in the port against the JAX package run at float16.

The JAX package trains in f16 (its step computes in jnp.dtype(model.dtype))
and serves, exports and evaluates in f32 at float16 (its serve.py computes
in bf16 only at bfloat16). Its CPU backend runs f16 dots, so the port's f16
is held to JAX's f16, far tighter than bf16 can be (tests/test_torch_train.py
holds bf16 to JAX's f32 at 2e-2). Every f16 limit here comes with a control,
the port's bf16 on the same inputs, that must fall outside it.

- The context mix (K1f/K1fr's plain version): u against JAX's
  `context_mix` at f16 (rtol 1e-4 / atol 5e-5) and `ctx_mix_pallas` in
  interpret mode, which rounds u to f16 (rtol 1e-3 / atol 5e-4).
- Its gradient (K1b/K1br's plain versions: autograd through the plain
  version, and `context_mix_bwd_plain`, which rounds where the kernels
  do) against `jax.grad` of the interpreted TPU kernel on both of its
  routes: ||err|| / ||dv|| within 2e-3 and max |err| within 3e-3 of the
  largest |dv|. With du scaled into f16's subnormal range, where the TPU
  kernel rounds du_n, alpha·da and dv to f16 subnormals (a few bits
  each), within 5e-2 of ||dv||: a du_n flushed to zero is 100% off.
- One config-4 step on both routes: metrics rtol 1e-4, gradients within
  2e-3 of each leaf's largest entry; fits (streaming at
  steps_per_call 3, and from the device cache): every logged row rtol
  1e-4 and the params within 2e-3 of each leaf's largest entry.
- Serving, the exported artifact and eval at float16 compute in f32: bit
  for bit the port's float32 ones, and the JAX server at float16 within
  the f32 tolerance (1e-5).
- The fused route (train.kernels=pallas) and the detector at float16 build
  and run; an unknown dtype raises ValueError. tests/test_torch_f16_fused.py
  holds the fused route's kernels' plain versions, K5's and the detector at
  f16 to the JAX package at f16.

The f16 CUDA kernels themselves run only on a GPU: the `cuda` test skips
here, and chip_smoke.py's phases 20 and 21 hold them on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nafae_torch.config as tcfg
import nafae_tpu.config as jcfg
import nafae_tpu.ops.pallas.fused_ctx as FC
from nafae_tpu import evaluate as JE
from nafae_tpu.ops import grounding as JG
from nafae_tpu.serve import GroundingServer as JaxServer
from nafae_torch import evaluate as TE
from nafae_torch import serve as TS
from nafae_torch import train as TT
from nafae_torch.models.detector.faster_rcnn import FasterRCNNExtractor
from nafae_torch.ops.kernels import ctx_mix as K
from tests import test_torch_ctx_grad as CG
from tests import test_torch_ctx_mix as CM
from tests import test_torch_device_cache as DC
from tests import test_torch_eval as EV
from tests import test_torch_serve as SV
from tests import test_torch_train as TR

U_JAX_TOL = dict(rtol=1e-4, atol=5e-5)       # against context_mix at f16
U_PALLAS_TOL = dict(rtol=1e-3, atol=5e-4)    # ... and the TPU kernel's f16 u
DV_REL, DV_MAX = 2e-3, 3e-3                  # dv: ||err|| / ||dv||, max
DV_SUBNORMAL_REL = 5e-2
STEP_RTOL = 1e-4                             # metrics, rows
GRAD_ATOL = 2e-3                             # of each leaf's largest entry


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", ["ragged", "serving_R", "w20_T3"])
def test_ctx_mix_matches_jax_at_f16(case):
    b, t, r, e, w = CM.CASES[case]
    v_ext, fm_ext, rm_ext = CM._inputs(b, t, r, e, w, seed=len(case))
    jargs = (jnp.asarray(v_ext), jnp.asarray(fm_ext), w, 0.1, jnp.float16,
             jnp.asarray(rm_ext))
    want = np.asarray(JG.context_mix(*jargs)[0], np.float32)
    want_pallas = np.asarray(FC.ctx_mix_pallas(*jargs)[0], np.float32)
    u = {dt: K.ctx_mix(torch.from_numpy(v_ext), torch.from_numpy(fm_ext), w,
                       0.1, dtype=dt, rm_ext=torch.from_numpy(rm_ext)
                       )[0].numpy()
         for dt in (torch.float16, torch.bfloat16)}
    np.testing.assert_allclose(u[torch.float16], want, **U_JAX_TOL)
    np.testing.assert_allclose(u[torch.float16], want_pallas, **U_PALLAS_TOL)
    assert not np.allclose(u[torch.bfloat16], want, **U_JAX_TOL)


@pytest.mark.parametrize("route,scale", [("residual", 1.0),
                                         ("recompute", 1.0),
                                         ("residual", 1e-5)])
@pytest.mark.parametrize("case", ["ragged", "R33_E50", "w20_T3"])
def test_ctx_grad_matches_the_tpu_kernel_at_f16(case, route, scale,
                                                monkeypatch):
    """du is f16-representable, so that the TPU kernel's cast of it is
    exact and both sides round du_n = scale·du once; the subnormal case
    runs on the residual route (both routes round du_n alike)."""
    b, t, r, e, w, tile = CG.CASES[case]
    v_ext, fm_ext, rm_ext = CG._inputs(b, t, r, e, w, seed=len(case))
    rng = np.random.RandomState(len(case) + 7)
    du = (rng.randn(b, t, r, e) * scale).astype(np.float16).astype(np.float32)
    monkeypatch.setattr(FC, "ALPHA_RESIDUAL", route == "residual")

    def f(ve):
        return FC.ctx_mix_pallas(ve, jnp.asarray(fm_ext), w, 0.1, jnp.float16,
                                 jnp.asarray(rm_ext), tile=tile)[0]

    want = np.asarray(jax.grad(lambda ve: jnp.sum(
        f(ve).astype(jnp.float32) * du))(jnp.asarray(v_ext)), np.float32)
    v, fm, rm, dut = (torch.from_numpy(x) for x in (v_ext, fm_ext, rm_ext,
                                                    du))

    def port(dt):
        vp = v.clone().requires_grad_()
        u, _ = K.ctx_mix(vp, fm, w, 0.1, dtype=dt, rm_ext=rm)
        (g,) = torch.autograd.grad(u, vp, dut)
        alpha = (K.context_alpha_plain(v, fm, w, 0.1, dtype=dt, rm_ext=rm)
                 if route == "residual" else None)
        return {"autograd": g.numpy(), "kernels' rounding":
                K.context_mix_bwd_plain(v, fm, w, 0.1, dut, dtype=dt,
                                        rm_ext=rm, alpha=alpha).numpy()}

    top = np.abs(want).max()
    control = port(torch.bfloat16)
    for name, got in port(torch.float16).items():
        if scale != 1.0:
            assert _rel(got, want) <= DV_SUBNORMAL_REL, name
            continue
        assert _rel(got, want) <= DV_REL, name
        assert np.abs(got - want).max() <= DV_MAX * top, name
        assert _rel(control[name], want) > DV_REL, name


def _steps_cfgs(root, kernels, dtype):
    jc, _ = TR._cfgs(root, "config4", ["model.dtype=float16"], kernels)
    _, tc = TR._cfgs(root, "config4", [f"model.dtype={dtype}"], kernels)
    return jc, tc


def _grads_off(got, want):
    """Leaves whose gradient is more than GRAD_ATOL of its largest entry
    off the reference."""
    return [k for k in want if np.abs(got[k] - want[k]).max()
            > GRAD_ATOL * np.abs(want[k]).max()]


@pytest.mark.parametrize("kernels", ["auto", "pallas"])
def test_one_step_matches_jax_at_f16(synth_root, kernels):
    jc, _ = _steps_cfgs(synth_root, kernels, "float16")
    batch = TR._batches(synth_root, jc, 1)[0]
    js, ts = TR._start(jc)
    tb = TT.batch_to_device(batch, torch.device("cpu"))
    gj = TR._jax_grads(js, batch, jc)
    _, mj = TR.JT.build_train_fn(jc, None)(jax.tree.map(jnp.asarray, js),
                                           batch)
    for dt in ("float16", "bfloat16"):
        _, tc = _steps_cfgs(synth_root, kernels, dt)
        gt = TR._torch_grads(ts, tb, tc)
        _, mt = TT.train_step(ts, tb, tc)
        off = _grads_off(gt, gj)
        m_off = [k for k in mj if not np.isclose(float(mt[k]), float(mj[k]),
                                                 rtol=STEP_RTOL, atol=0)]
        if dt == "float16":
            assert set(mt) == set(mj)
            assert not off and not m_off, (off, m_off)
        else:                       # the bf16 control falls outside both
            assert off and m_off


def _rows_off(jrows, trows):
    assert [r["step"] for r in trows] == [r["step"] for r in jrows]
    return [k for j, t in zip(jrows, trows) for k in j
            if k not in DC.RATES + ("step",)
            and not np.isclose(t[k], j[k], rtol=STEP_RTOL, atol=0)]


def _params_off(jstate, tstate):
    return [k for k, v in jstate.params.items()
            if np.abs(tstate.params[k].numpy() - np.asarray(v)).max()
            > GRAD_ATOL * np.abs(np.asarray(v)).max()]


@pytest.mark.parametrize("way", ["streaming_spc3", "cached"])
def test_fit_matches_jax_at_f16(synth_root, tmp_path, monkeypatch, way):
    """4 steps with a refresh every 2: streaming in calls of 3 and 1, or
    from the device cache a step a call; the port's bf16 fit is the
    control."""
    real = TR._cfgs
    for dt in ("float16", "bfloat16"):
        def cfgs(root, preset, extra=(), kernels="auto", dt=dt):
            jc, _ = real(root, preset, [*extra, "model.dtype=float16"],
                         kernels)
            _, tc = real(root, preset, [*extra, f"model.dtype={dt}"],
                         kernels)
            return jc, tc

        monkeypatch.setattr(TR, "_cfgs", cfgs)
        monkeypatch.setattr(DC, "_cfgs", cfgs)
        out = tmp_path / dt
        out.mkdir()
        if way == "cached":
            jstate, tstate, jrows, trows = DC._both(
                synth_root, out, monkeypatch, ["loss.kmeans_interval=2"],
                steps=4)
        else:
            jstate, tstate, jrows, trows = TR._fit_both_runs(
                synth_root, out, monkeypatch,
                ["train.steps_per_call=3", "loss.kmeans_interval=2"], [4])
        off = _rows_off(jrows, trows) + _params_off(jstate, tstate)
        assert not off if dt == "float16" else off, (dt, off)


def _serve_cfg(dtype, pool="context"):
    """tests/test_torch_serve.py's widths at model.dtype=dtype."""
    over = ["data.feat_dim=16", "model.feat_dim=16", "model.embed_dim=8",
            "data.max_frames=6", "data.num_regions=4", "data.max_words=3",
            "data.batch_size=4", f"model.frame_pool={pool}",
            "loss.ctx_window=2", f"model.dtype={dtype}"]
    return (jcfg.load_config(preset_name="config4", overrides=over),
            tcfg.load_config(preset_name="config4", overrides=over))


@pytest.mark.parametrize("pool", ["context", "attention"])
def test_server_and_artifact_at_f16_are_the_f32_ones(pool, tmp_path):
    params, segs = SV._params(), SV._segments(10)
    cj16, ct16 = _serve_cfg("float16", pool)
    _, ct32 = _serve_cfg("float32", pool)
    srv16 = TS.GroundingServer(ct16, params, device="cpu")
    srv32 = TS.GroundingServer(ct32, params, device="cpu")
    got = srv16.ground_segments(segs)
    assert got == srv32.ground_segments(segs)
    want = JaxServer(cj16, {k: jnp.asarray(v) for k, v in params.items()}
                     ).ground_segments(segs)
    SV._assert_same_response(got, want)
    batch = SV._segments(4, seed=1)
    samples = [srv32._pad_segment(s) for s in batch]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    live = srv32.run_batch(batch)
    assert all(np.array_equal(a, live[k])
               for k, a in srv16.run_batch(batch).items())
    TS.export_grounding(ct16, params, str(tmp_path), device="cpu")
    call, manifest = TS.load_exported(str(tmp_path))
    assert manifest["model"]["dtype"] == "float16"
    out = call(*[batch[k] for k in ("feats", "boxes", "word_ids",
                                    "frame_mask", "word_mask",
                                    "region_mask")])
    for k, v in live.items():
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)


def test_eval_at_f16_is_the_f32_eval(synth_root):
    got = {}
    for dt in ("float32", "float16"):
        jc, tc = EV._cfgs(synth_root, extra=[f"model.dtype={dt}"])
        got[dt] = TE.evaluate_config(tc, params=EV._params(), device="cpu")
    assert got["float16"] == got["float32"]
    want = JE.evaluate_config(jc, params={k: jnp.asarray(v) for k, v in
                                          EV._params().items()})   # float16
    EV._assert_same_result(got["float16"], want)


def test_what_the_card_lacks_at_f16_raises(synth_root, tmp_path):
    """Nothing the reference accepts at float16 is refused any more:
    train.kernels=pallas (and the legacy train.use_pallas) at
    model.dtype=float16 builds its step and trains (here on the CPU, where
    the fused route runs its plain versions at f16; on the card K3, K4f and
    K4b launch their f16 kernels), and detector.dtype=float16 builds the
    detector. An unknown dtype still raises ValueError."""
    def cfg(*extra):
        return TR._cfgs(synth_root, "config4", extra)[1]

    pallas16 = cfg("model.dtype=float16", "train.kernels=pallas",
                   "train.steps=2", "train.log_every=1",
                   f"train.ckpt_dir={tmp_path / 'p'}")
    legacy = cfg("model.dtype=float16", "train.kernels=auto",
                 "train.use_pallas=true")
    for c in (pallas16, legacy):
        assert c.train.resolved_kernels() == "pallas"
        TT.build_train_fn(c, TT.make_optimizer(c), "cpu")
    rows = []
    state, _ = TT.fit(pallas16, device="cpu", log_fn=rows.append)
    assert int(state.step) == 2
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)
    det16 = tcfg.load_config(preset_name="config5", overrides=[
        "detector.dtype=float16", "detector.image_size=64"])
    assert FasterRCNNExtractor(det16.detector).backbone.dtype == torch.float16
    with pytest.raises(ValueError, match="detector.dtype"):
        FasterRCNNExtractor(tcfg.load_config(
            preset_name="config5",
            overrides=["detector.dtype=float64"]).detector)
    with pytest.raises(ValueError, match="model.dtype"):
        TT.TrainState.create(cfg("model.dtype=float64"), device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py's phase 20 runs "
                    "this check on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["serving_R", "R36_E1024", "w20_T3"])
def test_f16_kernels_match_plain_on_gpu(cuda_device, case):
    """K1f, K1fr, K1b and K1br launched on f16 tensors against their plain
    versions at f16 (the same rounding points: ||err|| / ||want|| within
    7e-4, chip_smoke.py's F16_REL), the bf16 plain version outside that."""
    b, t, r, e, w = CM.CASES[case]
    v32, fm, rm = (torch.from_numpy(a).to(cuda_device)
                   for a in CM._inputs(b, t, r, e, w))
    du = torch.randn(b, t, r, e, generator=torch.Generator().manual_seed(1)
                     ).to(cuda_device)
    v16 = v32.half()
    before = dict(K.launches)
    u, alpha = K.launch_fwd(v16, fm, w, 0.1, rm, residual=True)
    got = {"u": u, "alpha": alpha,
           "dv_res": K.launch_bwd(v16, fm, w, 0.1, rm, du, alpha),
           "dv": K.launch_bwd(v16, fm, w, 0.1, rm, du)}
    torch.cuda.synchronize()
    assert K.launches["ctx_mix_fwd_res"] == before["ctx_mix_fwd_res"] + 1

    def plain(dt, a=None):
        return {"u": K.context_mix_plain(v32, fm, w, 0.1, dtype=dt,
                                         rm_ext=rm)[0],
                "alpha": K.context_alpha_plain(v32, fm, w, 0.1, dtype=dt,
                                               rm_ext=rm),
                "dv_res": K.context_mix_bwd_plain(v32, fm, w, 0.1, du, dt,
                                                  rm, a),
                "dv": K.context_mix_bwd_plain(v32, fm, w, 0.1, du, dt, rm)}

    want = plain(torch.float16, alpha)
    control = plain(torch.bfloat16, plain(torch.bfloat16)["alpha"])

    def rel(x, y):
        return ((x.float() - y.float()).norm() / y.float().norm()).item()

    for k in want:
        assert rel(got[k], want[k]) <= 7e-4, k
        assert rel(control[k], want[k]) > 7e-4, k
