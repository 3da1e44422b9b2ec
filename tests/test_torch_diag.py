"""The port's fused diag epilogue (nafae_torch.ops.kernels.diag) against the
JAX package's `fused_diag.diag_epilogue_pallas` (K4f/K4b in interpret mode,
as tests/test_pallas.py runs them), on the same numpy inputs.

Held, at test_pallas.py:358's shapes and limits, at config4-like ones
(K = 8, R = 20, an all-masked frame, a frame without context) and at the
CUDA kernels' limits and edges in small sizes (K = 1 and 32, E = 4 and
512, R = 1 and 33, Kc = 1 and 130, T = 1, exact region and center ties at
3 and 35, a video with no valid frame), and past them, where the general
variants run (K = 33 and 40, E = 3, 50 and 1024, a center tie across 32 at
E = 50; K = 64 and 65, R = 64 and 65 and Kc = 129, at and one past the
general forward's words a pass, regions a tile and centers a pass): ctx_kt
and
clu_kt within 2e-5, f within 1e-6, and dw, dv of a masked weighted sum of
ctx and clu within 3e-5, for both the plain version and the wrapper on CPU
tensors (which takes the plain version). The selection ignores frame
validity (region mask only; an all-masked frame picks region 0). The bf16
mode against JAX's f32 at 2e-2 (JAX's CPU backend runs no bf16 dots), and
the bf16 rounding points of the TPU kernel checked directly.

The CUDA kernels run only on a GPU: the `cuda` test skips here, and
chip_smoke.py holds them against the plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafae_tpu.ops.pallas.fused_diag import diag_epilogue_pallas
from nafae_torch.ops.kernels import diag as D

CASES = {                       # B, K, T, R, E, Kc
    "pallas_test": (3, 5, 6, 7, 32, 11),
    "config4_like": (2, 8, 5, 20, 16, 9),
    # the kernels' limits and edges, small: K = 1 and 32, E = 4 and 512,
    # R = 1 and 33 (one past a chunk of 32 regions), Kc = 1 and 130, T = 1
    "k1": (2, 1, 4, 6, 16, 5),
    "k32": (2, 32, 3, 5, 16, 7),
    "e4": (2, 3, 4, 6, 4, 5),
    "e512": (2, 2, 2, 3, 512, 5),
    "r1": (2, 3, 4, 1, 16, 5),
    "r33": (2, 3, 3, 33, 16, 5),
    "kc1": (2, 3, 4, 6, 16, 1),
    "kc130": (2, 3, 3, 6, 16, 130),
    "t1": (2, 3, 1, 6, 16, 5),
    # exact ties between regions 3 and 35 and between centers 3 and 35
    # (across 32: the first must win), and a video with no valid frame
    "ties_dead_video": (2, 3, 3, 36, 16, 36),
    # past the specialised kernels (the general variants'): K = 33 and 40,
    # E = 3, 50 (GloVe-50d) and 1024, and a tie across 32 centers at E = 50
    "k33": (2, 33, 3, 5, 16, 7),
    "k40": (2, 40, 2, 4, 16, 5),
    "e3": (2, 3, 4, 6, 3, 5),
    "e50": (2, 3, 3, 6, 50, 9),
    "e1024": (2, 2, 2, 3, 1024, 5),
    "center_ties_e50": (2, 3, 3, 6, 50, 36),
    # the general forward's tiles: words a pass (64), regions a tile (64)
    # and centers a pass (128), at and one past each
    "k64": (2, 64, 2, 4, 16, 5),
    "k65": (2, 65, 2, 4, 16, 5),
    "r64_e50": (2, 3, 2, 64, 50, 5),
    "r65_e50": (2, 3, 2, 65, 50, 5),
    "kc129_e50": (2, 3, 2, 6, 50, 129),
}
# case -> later index of tied regions (where R is past it) and centers
TIES = {"ties_dead_video": 35, "center_ties_e50": 35}
DEAD = {"ties_dead_video"}       # cases whose video 1 has no valid frame
DA, DB = 0.7, 1.3               # weights of the two losses in the sum


def _inputs(case, seed=0):
    b, k, t, r, e, kc = CASES[case]
    rng = np.random.RandomState(seed)
    nrm = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)  # noqa: E731
    w = nrm(rng.randn(b, k, e)).astype(np.float32)
    v = nrm(rng.randn(b, t, r, e)).astype(np.float32)
    u = (rng.randn(b, t, r, e) * 0.5).astype(np.float32)
    centers = nrm(rng.randn(kc, e)).astype(np.float32)
    fm = (rng.rand(b, t) > 0.2).astype(np.float32)
    rm = (rng.rand(b, t, r) > 0.2).astype(np.float32)
    hc = (rng.rand(b, t) > 0.3).astype(np.float32)
    wm = (rng.rand(b, k) > 0.2).astype(np.float32)
    f1 = min(1, t - 1)
    fm[0, f1] = hc[0, f1] = 1.0
    rm[0, f1, :] = 0.0                 # a valid frame with no valid region
    if case in TIES:                   # duplicate rows: exact ties
        later = TIES[case]
        if later < r:
            v[:, :, later] = v[:, :, later - 32]
            rm[:, :, later] = rm[:, :, later - 32]
        centers[later] = centers[later - 32]
    if case in DEAD:
        fm[1] = 0.0
    return w, v, u, centers, fm, rm, hc, wm


def _total(ctx_kt, clu_kt, wm, fm, xp):
    return (DA * xp.sum(wm[:, :, None] * ctx_kt)
            + DB * xp.sum(wm[:, :, None] * fm[:, None, :] * clu_kt))


def _jax(w, v, u, centers, fm, rm, hc, wm):
    args = [jnp.asarray(x) for x in (u, centers, fm, rm, hc)]

    def parts(w_, v_):
        return diag_epilogue_pallas(w_, v_, args[0], args[1], args[2],
                                    args[3], args[4])

    ctx_kt, clu_kt, f = jax.jit(parts)(jnp.asarray(w), jnp.asarray(v))
    grads = jax.jit(jax.grad(
        lambda w_, v_: _total(*parts(w_, v_)[:2], jnp.asarray(wm),
                              args[2], jnp), argnums=(0, 1)))(
        jnp.asarray(w), jnp.asarray(v))
    return [np.asarray(x) for x in (ctx_kt, clu_kt, f, *grads)]


def _port(fn, w, v, u, centers, fm, rm, hc, wm, dtype=None):
    wt = torch.from_numpy(w).requires_grad_()
    vt = torch.from_numpy(v).requires_grad_()
    ctx_kt, clu_kt, f = fn(wt, vt, torch.from_numpy(u),
                           torch.from_numpy(centers), torch.from_numpy(fm),
                           torch.from_numpy(rm), torch.from_numpy(hc),
                           dtype=dtype)
    assert not f.requires_grad
    gw, gv = torch.autograd.grad(
        _total(ctx_kt, clu_kt, torch.from_numpy(wm), torch.from_numpy(fm),
               torch), (wt, vt))
    return [x.detach().numpy() for x in (ctx_kt, clu_kt, f, gw, gv)]


@pytest.mark.parametrize("fn", ["diag_epilogue_plain", "diag_epilogue"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_the_tpu_kernel(case, fn):
    ins = _inputs(case, seed=len(case))
    want = _jax(*ins)
    got = _port(getattr(D, fn), *ins)
    for name, g, w_, tol in zip(("ctx_kt", "clu_kt", "f", "dw", "dv"), got,
                                want, (2e-5, 2e-5, 1e-6, 3e-5, 3e-5)):
        np.testing.assert_allclose(g, w_, rtol=tol, atol=tol, err_msg=name)


def test_selection_and_masks():
    """An all-masked frame picks region 0 and adds nothing to ctx; frames
    without context or invalid add nothing to ctx; the residual d is the
    masked s - ŝ; r* ignores the frame mask."""
    w, v, u, centers, fm, rm, hc, _ = _inputs("config4_like", seed=3)
    fm[1, 2] = 0.0
    hc[1, 3] = 0.0
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    ctx, clu, f, d, rstar, cstar = D.diag_fwd_plain(
        t(w), t(v), t(u), t(centers), t(fm), t(hc), t(rm))
    assert (rstar[0, :, 1] == 0).all() and (ctx[0, :, 1] == 0).all()
    assert (ctx[1, :, 2] == 0).all() and (ctx[1, :, 3] == 0).all()
    s = np.einsum("bke,btre->bktr", w, v)
    m = ((rm > 0) & (fm > 0)[..., None] & (hc > 0)[..., None])[:, None]
    np.testing.assert_allclose(
        d.numpy(), np.where(m, s - np.einsum("bke,btre->bktr", w, u), 0.0),
        rtol=1e-5, atol=1e-6)
    want_r = np.argmax(np.where((rm > 0)[:, None], s, D.NEG), -1)
    np.testing.assert_array_equal(rstar.numpy(), want_r)
    np.testing.assert_array_equal(
        f.numpy(), v[np.arange(2)[:, None, None], np.arange(5)[None, :, None],
                     want_r.transpose(0, 2, 1)])
    assert rstar.dtype == cstar.dtype == torch.int32


def test_bf16_close_to_the_f32_reference():
    """bf16 against JAX's f32 where the f32 selection and cosine assignment
    are clear of bf16's rounding (top two scores more than 0.02 apart, for
    r* and for c*): elsewhere r* or c* may rightly differ, and clu with
    them."""
    w, v, u, centers, fm, rm, hc, wm = _inputs("config4_like", seed=5)
    s = np.where((rm > 0)[:, None], np.einsum("bke,btre->bktr", w, v), D.NEG)
    r_star = np.argmax(s, -1)
    f = v[np.arange(2)[:, None, None], np.arange(5)[None, None, :], r_star]
    sims = np.einsum("bkte,ce->bktc", f, centers)
    gap = lambda x: np.diff(np.sort(x, -1)[..., -2:], axis=-1)[..., 0]  # noqa: E731
    clear = ((gap(s) > 0.02) & (gap(sims) > 0.02)).astype(np.float32)
    assert clear.mean() > 0.5
    t = lambda x: torch.from_numpy(x)  # noqa: E731

    def total(ctx_kt, clu_kt, wm_, clear_, xp):
        # the cluster term weighs only the clear assignments
        return (DA * xp.sum(wm_[:, :, None] * ctx_kt)
                + DB * xp.sum(clear_ * clu_kt))

    ja = [jnp.asarray(x) for x in (u, centers, fm, rm, hc)]
    jparts = lambda w_, v_: diag_epilogue_pallas(w_, v_, *ja)  # noqa: E731
    ctx_j, clu_j, _ = jax.jit(jparts)(jnp.asarray(w), jnp.asarray(v))
    want = [ctx_j, np.asarray(clu_j) * clear, *jax.grad(
        lambda w_, v_: total(*jparts(w_, v_)[:2], jnp.asarray(wm),
                             jnp.asarray(clear), jnp),
        argnums=(0, 1))(jnp.asarray(w), jnp.asarray(v))]
    wt, vt = t(w).requires_grad_(), t(v).requires_grad_()
    ctx_kt, clu_kt, _ = D.diag_epilogue(wt, vt, t(u), t(centers), t(fm),
                                        t(rm), t(hc), dtype=torch.bfloat16)
    got = [ctx_kt, clu_kt * t(clear), *torch.autograd.grad(
        total(ctx_kt, clu_kt, t(wm), t(clear), torch), (wt, vt))]
    for name, g, w_ in zip(("ctx_kt", "clu_kt", "dw", "dv"), got, want):
        w_ = np.asarray(w_)
        scale = max(np.abs(w_).max(), 1e-30)
        np.testing.assert_allclose(g.detach().numpy() / scale, w_ / scale,
                                   rtol=2e-2, atol=2e-2, err_msg=name)


def test_bf16_rounds_where_the_tpu_kernel_rounds():
    """bf16 mode: each ctx term and the target center are bf16 values; the
    backward's ds is a bf16 value times the bf16 regions, summed in f32."""
    w, v, u, centers, fm, rm, hc, _ = _inputs("pallas_test", seed=7)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    ctx, clu, f, d, rstar, cstar = D.diag_fwd_plain(
        bf(w), bf(v), bf(u), t(centers), t(fm), t(hc), t(rm))
    wf, vf, uf = (bf(x).float() for x in (w, v, u))
    sq = (torch.einsum("bke,btre->bktr", wf, vf)
          - torch.einsum("bke,btre->bktr", wf, uf)) ** 2
    m = t(((rm > 0) & (fm > 0)[..., None] & (hc > 0)[..., None])[:, None])
    want = torch.where(m, sq, 0.0).to(torch.bfloat16).float().sum(-1)
    torch.testing.assert_close(ctx, want, rtol=1e-6, atol=1e-7)
    assert torch.equal(f, f.to(torch.bfloat16).float())
    tgt = t(centers)[cstar.long()].to(torch.bfloat16).float()
    torch.testing.assert_close(
        clu, ((f.permute(0, 2, 1, 3) - tgt) ** 2).sum(-1), rtol=1e-6,
        atol=1e-7)
    dctx = torch.rand(ctx.shape, generator=torch.Generator().manual_seed(0))
    dw, _ = D.diag_bwd_plain(bf(w), bf(v), t(centers), d, rstar, cstar, f,
                             dctx, torch.zeros_like(clu))
    ds = (2.0 * dctx.to(torch.bfloat16).float())[..., None] * d
    want_dw = torch.einsum("bktr,btre->bke",
                           ds.to(torch.bfloat16).float(), vf)
    torch.testing.assert_close(dw, want_dw, rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    ins = [torch.from_numpy(x) for x in _inputs("pallas_test", seed=1)[:7]]
    before = dict(D.launches)
    got = D.diag_epilogue(*ins)
    want = D.diag_epilogue_plain(*ins)
    assert D.launches == before
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    """Dtypes, layouts, alignment, shapes of the masks and cotangents, and
    the grids' limits (B; K4b's T*R and general grid) outside what the
    kernels take raise before any launch."""
    b, k, t, r, e, kc = 2, 3, 4, 5, 8, 6
    w, v = torch.zeros(b, k, e), torch.zeros(b, t, r, e)
    c, fm = torch.zeros(kc, e), torch.ones(b, t)
    unaligned = torch.zeros(b * t * r * e + 1)[1:].view(b, t, r, e)
    big_w, big_v = torch.zeros(65536, 1, 1), torch.zeros(65536, 1, 1, 1)
    for bad, match in (((w, torch.zeros(b, t, 0, e), c), "R"),
                       ((torch.zeros(b, 0, e), v, c), "K"),
                       ((w, v, torch.zeros(0, e)), "Kc"),
                       ((w.double(), v.double(), c),
                        "float32, bfloat16 or float16"),
                       ((w, v.bfloat16(), c), "w"),
                       ((w, v, c.double()), "centers"),
                       ((w, torch.zeros(b, t, e, r).transpose(2, 3), c),
                        "contiguous"),
                       ((w, unaligned, c), "aligned"),
                       ((big_w, big_v, torch.zeros(1, 1)), "B <= 65535")):
        bw, bv, bc = bad
        bfm = torch.ones(bv.shape[:2])
        with pytest.raises((ValueError, TypeError), match=match):
            D.launch_fwd(bw, bv, bv, bc, bfm, bfm, None)
    with pytest.raises(ValueError, match="rm"):
        D.launch_fwd(w, v, v, c, fm, fm, torch.ones(b, t, r + 1))
    with pytest.raises(ValueError, match="hc"):
        D.launch_fwd(w, v, v, c, fm, torch.ones(b, t + 1), None)
    with pytest.raises(ValueError, match="dctx"):
        D.launch_bwd(w, v, c, torch.zeros(b, k, t, r),
                     torch.zeros(b, k, t, dtype=torch.int32),
                     torch.zeros(b, k, t, dtype=torch.int32),
                     torch.zeros(b, t, k, e), torch.zeros(b, k, t + 1),
                     torch.zeros(b, k, t))
    with pytest.raises(ValueError, match="B <= 65535"):
        D.launch_bwd(big_w, big_v, torch.zeros(1, 1), *(None,) * 6)
    one = torch.zeros(1, 1, 1, 1)            # K4b's rows and blocks
    for shape in ((1, 2**16, 2**16, 1), (1, 2**20, 1, 2**17)):
        with pytest.raises(ValueError, match=r"B\*\(T\+9\)"):
            D.launch_bwd(one[0].expand(1, 1, shape[3]), one.expand(*shape),
                         torch.zeros(1, shape[3]), *(None,) * 6)


@pytest.mark.parametrize("k, e", [(33, 16), (40, 256), (8, 6), (8, 50),
                                  (8, 1024), (33, 3), (1, 1)])
def test_checks_take_any_k_and_e(k, e):
    """K > 32, E not a multiple of 4 and E > 512 pass the checks: the
    general variants take them."""
    for dt in (torch.float32, torch.bfloat16):
        w = torch.zeros(2, k, e, dtype=dt)
        v = torch.zeros(2, 3, 36, e, dtype=dt)
        assert D._check_inputs(w, v, torch.zeros(130, e)) == (2, k, 3, 36, e,
                                                               130)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on "
                    "the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_gpu(cuda_device, dtype):
    """K4f and K4b against the plain versions on the card (K4b on the same
    residuals): f32 sums in other orders, so 1e-4 / 1e-5. In bf16 a ctx
    term whose f32 value lies on a rounding midpoint may round the other
    way, so ctx may also differ by what such terms account for; ctx must be
    the sum of the kernel's own residual terms rounded as the plain version
    rounds them."""
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    rnd = D._rounder(tdt)
    for case in sorted(CASES):
        w, v, u, centers, fm, rm, hc, _ = (
            torch.from_numpy(x).to(cuda_device) for x in _inputs(case))
        w, v, u = w.to(tdt), v.to(tdt), u.to(tdt)
        before = dict(D.launches)
        got = D.launch_fwd(w, v, u, centers, fm, hc, rm)
        torch.cuda.synchronize()
        want = D.diag_fwd_plain(w, v, u, centers, fm, hc, rm)
        terms, want_terms = rnd(got[3] * got[3]), rnd(want[3] * want[3])
        other_way = ((terms - want_terms).abs().sum(-1)
                     if dtype == "bfloat16" else 0.0)
        assert ((got[0] - want[0]).abs()
                <= 1e-5 + 1e-4 * want[0].abs() + other_way).all()
        torch.testing.assert_close(got[0], terms.sum(-1), rtol=1e-4,
                                   atol=1e-5)
        for g, w_ in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-5)
        dctx, dclu = torch.rand_like(got[0]), torch.rand_like(got[1])
        dw, dv = D.launch_bwd(w, v, centers, *got[3:], got[2], dctx, dclu)
        pdw, pdv = D.diag_bwd_plain(w, v, centers, *got[3:], got[2], dctx,
                                    dclu)
        torch.testing.assert_close(dw, pdw, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(dv, pdv, rtol=1e-4, atol=1e-5)
        assert D.launches["diag_epilogue"] == before["diag_epilogue"] + 1
        assert D.launches["diag_epilogue_bwd"] == \
            before["diag_epilogue_bwd"] + 1
