"""The port's fused cross-MIL (nafae_torch.ops.kernels.cross_mil) against the
JAX package's `fused_ground.cross_mil` (K3a/K3b in interpret mode, as
tests/test_pallas.py runs them), on the same numpy inputs.

Held: the plain version's a (rtol 1e-5 / atol 1e-5) at test_pallas.py's
shapes, R = 33 (K3a's domain) and the degenerate single frame included,
and at the widths the CUDA kernel's general variant takes (E = 3, 50 at
R = 36, 1024; unit rows past E = 512, as the model's),
with and without a region mask that leaves a valid frame with no valid
region; its idx equal to the TPU kernels' on forced ties (the first
region); CrossMil's gradients, which route the whole cotangent to idx,
against jax.grad of the TPU kernel's VJP (rtol 1e-4 / atol 5e-5, the
reference's own limits: dw sums I·T terms in another order), also at
those widths. The bf16 mode against JAX's f32 at 2e-2 (JAX's CPU backend
runs no bf16 dots). The wrapper's checks take any R and E and refuse
dtypes, layouts, alignment, masks and the grid's limits.

The CUDA kernel runs only on a GPU: the `cuda` test skips here, and
chip_smoke.py holds the kernel against the plain version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafae_tpu.ops.pallas import fused_ground as FG
from nafae_torch.ops import grounding as TG
from nafae_torch.ops.kernels import cross_mil as K

SHAPES = {                      # I, J, K, T, R, E (tests/test_pallas.py:23)
    "tiny": (3, 3, 2, 4, 5, 16),
    "R20": (5, 4, 3, 7, 20, 32),
    "single": (2, 2, 1, 1, 1, 8),
    "R33": (4, 4, 2, 6, 33, 16),
    # widths past the specialised kernels (the general variant's): E not a
    # multiple of 4 (GloVe-50d's 50 at R = 36), E > 512
    "E3": (3, 2, 2, 3, 5, 3),
    "R36_E50": (2, 3, 2, 3, 36, 50),
    "E1024": (2, 2, 2, 2, 5, 1024),
}
# shapes at the edges of the CUDA kernel's tiles (80 columns, 32 or 64 words
# a block; E walked 32 or 16 columns at a time)
EDGE_SHAPES = {
    "R1": (2, 2, 2, 3, 1, 16),
    "R7": (2, 2, 2, 3, 7, 16),
    "R64": (2, 2, 2, 3, 64, 16),
    "R100": (2, 2, 2, 2, 100, 16),      # more than one chunk of regions
    "M1": (2, 1, 1, 3, 5, 16),
    "M129": (2, 43, 3, 2, 5, 8),
    "T1": (3, 2, 2, 1, 6, 16),
    "E512": (2, 2, 2, 2, 5, 512),
    "E4": (2, 2, 2, 3, 5, 4),           # the smallest E
}
# region pairs made equal: r and r + 32, r and the last row, across a chunk;
# at R = 36 with E = 50 (the general variant's width), r and r + 32
TIES = {33: [(0, 32), (5, 17)], 64: [(3, 35), (1, 63)],
        100: [(7, 39), (2, 99), (40, 85)], 36: [(2, 34), (0, 35)]}
TIE_E = {36: 50}                # E of a TIES case (16 when not listed)


def _inputs(shape, masked, seed):
    i, j, k, t, r, e = shape
    rng = np.random.RandomState(seed)
    w = rng.randn(j, k, e).astype(np.float32)
    v = rng.randn(i, t, r, e).astype(np.float32)
    if e > 512:
        # unit rows, as the model's ŵ and v̂: a dot of 1024 raw normal
        # entries is ~30 in size, summed in another order by each side
        w /= np.linalg.norm(w, axis=-1, keepdims=True)
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
    fm = (rng.rand(i, t) > 0.3).astype(np.float32)
    fm[0, 0] = 1.0
    rm = None
    if masked:
        rm = (rng.rand(i, t, r) > 0.4).astype(np.float32)
        rm[0, 0, :] = 0.0                  # a valid frame, no valid region
    return w, v, fm, rm


def _jax_a(w, v, fm, rm):
    return FG.cross_mil(jnp.asarray(w), jnp.asarray(v), jnp.asarray(fm),
                        None if rm is None else jnp.asarray(rm))


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plain_matches_the_tpu_kernel(case, masked):
    shape = SHAPES[case]
    w, v, fm, rm = _inputs(shape, masked, seed=len(case) + masked)
    i, j, k, t, r, e = shape
    a, idx = K.cross_mil_plain(_t(w).reshape(j * k, e), _t(v), _t(fm), _t(rm))
    np.testing.assert_allclose(a.numpy().reshape(i, j, k, t),
                               np.asarray(_jax_a(w, v, fm, rm)),
                               rtol=1e-5, atol=1e-5)
    rm1 = rm if rm is not None else np.ones((i, t, r), np.float32)
    a_j, idx_j = FG._cross_mil_fwd_impl(jnp.asarray(w.reshape(j * k, e)),
                                        jnp.asarray(v), jnp.asarray(fm),
                                        jnp.asarray(rm1))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    if masked:                  # the valid frame with no valid region
        assert (a[0, :, 0] == K.NEG).all() and (idx[0, :, 0] == 0).all()
    assert (a.numpy()[np.broadcast_to(fm[:, None, :] == 0, a.shape)]
            == 0).all()


def _edge_inputs(case):
    """EDGE_SHAPES inputs, masked, with video 1's frames all invalid."""
    w, v, fm, rm = _inputs(EDGE_SHAPES[case], True, seed=7 + len(case))
    fm[1, :] = 0.0
    return w, v, fm, rm


def _tie_inputs(r):
    """Duplicate region rows (TIES[r]) force exact ties; video 1, frame 0 is
    all masked."""
    i, m, t, e = 2, 5, 2, TIE_E.get(r, 16)
    rng = np.random.RandomState(r)
    v = rng.randn(i, t, r, e).astype(np.float32)
    rm = (rng.rand(i, t, r) > 0.2).astype(np.float32)
    for first, later in TIES[r]:
        v[:, :, later] = v[:, :, first]
        rm[:, :, later] = rm[:, :, first]
    rm[1, 0, :] = 0.0
    w = rng.randn(m, e).astype(np.float32)
    return w, v, np.ones((i, t), np.float32), rm


@pytest.mark.parametrize("case", sorted(EDGE_SHAPES))
def test_plain_matches_the_tpu_kernel_at_edge_shapes(case):
    """The plain version, which the card holds the CUDA kernel to, against
    the TPU kernels at the shapes a tiled product is likely to break."""
    i, j, k, t, r, e = EDGE_SHAPES[case]
    w, v, fm, rm = _edge_inputs(case)
    a, idx = K.cross_mil_plain(_t(w).reshape(j * k, e), _t(v), _t(fm), _t(rm))
    np.testing.assert_allclose(a.numpy().reshape(i, j, k, t),
                               np.asarray(_jax_a(w, v, fm, rm)),
                               rtol=1e-5, atol=1e-5)
    _, idx_j = FG._cross_mil_fwd_impl(jnp.asarray(w.reshape(j * k, e)),
                                      jnp.asarray(v), jnp.asarray(fm),
                                      jnp.asarray(rm))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    assert (a[1] == 0).all()               # the video with no valid frame
    assert (a[0, :, 0] == K.NEG).all() and (idx[0, :, 0] == 0).all()


@pytest.mark.parametrize("r", sorted(TIES))
def test_ties_across_tiles_resolve_to_the_first_region(r):
    """Equal rows r and r + 32, r and the last row, and across a chunk of 80
    regions: idx is the TPU kernel's, and never the later row of a pair."""
    w, v, fm, rm = _tie_inputs(r)
    a, idx = K.cross_mil_plain(_t(w), _t(v), _t(fm), _t(rm))
    a_j, idx_j = FG._cross_mil_fwd_impl(*(jnp.asarray(x)
                                          for x in (w, v, fm, rm)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=1e-5,
                               atol=1e-5)
    for _, later in TIES[r]:
        assert not (idx == later).any()
    assert (idx[1, :, 0] == 0).all()


@pytest.mark.parametrize("r", [20, 33])
def test_ties_resolve_to_the_first_region(r):
    """Duplicate region rows force exact score ties: idx is the first
    region, as the TPU kernels' (K3b's roll-max for R <= 32, K3a's for
    R > 32)."""
    i, m, t, e = 2, 4, 3, 16
    rng = np.random.RandomState(0)
    v = rng.randn(i, t, r, e).astype(np.float32)
    v[:, :, 16] = v[:, :, 8]
    v[:, :, 13] = v[:, :, 3]
    v[:, :, r - 1] = v[:, :, 0]
    w = rng.randn(m, e).astype(np.float32)
    fm = np.ones((i, t), np.float32)
    rm = np.ones((i, t, r), np.float32)
    rm[1, 2, :] = 0.0                      # all masked: every score is NEG
    a, idx = K.cross_mil_plain(_t(w), _t(v), _t(fm), _t(rm))
    args = tuple(jnp.asarray(x) for x in (w, v, fm, rm))
    a_j, idx_j = (FG._cross_mil_fwd_rollmax(*args) if r <= 32
                  else FG._cross_mil_fwd_impl(*args))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=1e-5,
                               atol=1e-5)
    s = np.einsum("me,itre->imtr", w, v)
    assert (idx.numpy()[:1] == np.argmax(s, -1)[:1]).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", ["R20", "R33", "E3", "R36_E50", "E1024"])
def test_gradients_match_the_tpu_kernel(case, masked):
    shape = SHAPES[case]
    w, v, fm, rm = _inputs(shape, masked, seed=3 + masked)

    def loss_j(w_, v_):
        return jnp.sum(jnp.sin(FG.cross_mil(
            w_, v_, jnp.asarray(fm),
            None if rm is None else jnp.asarray(rm)) * 1.7))

    gw_j, gv_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(w),
                                                   jnp.asarray(v))
    wt, vt = _t(w).requires_grad_(), _t(v).requires_grad_()
    a = K.cross_mil(wt, vt, _t(fm), _t(rm))
    gw, gv = torch.autograd.grad(torch.sum(torch.sin(a * 1.7)), (wt, vt))
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_j), rtol=1e-4,
                               atol=5e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(gv_j), rtol=1e-4,
                               atol=5e-5)


def test_gradient_goes_whole_to_the_first_tied_region():
    """Where regions tie, CrossMil sends the cotangent to the saved idx
    alone (the reference's VJP), not split as torch.amax would."""
    rng = np.random.RandomState(5)
    v = rng.randn(1, 2, 4, 8).astype(np.float32)
    v[:, :, 3] = v[:, :, 1]
    w = rng.randn(1, 1, 8).astype(np.float32)
    w[0, 0] = v[0, 0, 1] * 10.0            # region 1 (and its copy 3) wins
    w[0, 0] += v[0, 1, 1] * 10.0
    vt = _t(v).requires_grad_()
    a = K.cross_mil(_t(w), vt, torch.ones(1, 2))
    (gv,) = torch.autograd.grad(a.sum(), vt)
    assert torch.equal(gv[0, :, 3], torch.zeros(2, 8))
    torch.testing.assert_close(gv[0, 0, 1], _t(w)[0, 0])


def test_bf16_close_to_the_f32_reference():
    shape = SHAPES["R20"]
    w, v, fm, rm = _inputs(shape, True, seed=11)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    a = K.cross_mil(_t(w), _t(v), _t(fm), _t(rm), dtype=torch.bfloat16)
    assert a.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), np.asarray(_jax_a(w, v, fm, rm)),
                               rtol=2e-2, atol=2e-2)


def test_cross_scores_pallas_matches_the_reference():
    """cross_scores(impl="pallas") against the JAX package's, every pool,
    with and without a region mask (test_pallas.py:113)."""
    from nafae_tpu.ops import grounding as JG

    rng = np.random.RandomState(1)
    b, k, t, r, e = 4, 3, 6, 5, 16
    nrm = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)  # noqa: E731
    w = nrm(rng.randn(b, k, e)).astype(np.float32)
    v = nrm(rng.randn(b, t, r, e)).astype(np.float32)
    fm = (rng.rand(b, t) > 0.2).astype(np.float32)
    wm = (rng.rand(b, k) > 0.2).astype(np.float32)
    rm = (rng.rand(b, t, r) > 0.3).astype(np.float32)
    for pool in ("attention", "mean", "context"):
        for rmask in (None, rm):
            kw = dict(ctx_window=2) if pool == "context" else {}
            want = JG.cross_scores(*(jnp.asarray(x) for x in (w, wm, v, fm)),
                                   0.1, pool, impl="pallas",
                                   region_mask=None if rmask is None
                                   else jnp.asarray(rmask), **kw)
            got = TG.cross_scores(_t(w), _t(wm), _t(v), _t(fm), 0.1, pool,
                                  impl="pallas", region_mask=_t(rmask), **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{pool} rm={rmask is not None}")


def test_cpu_tensors_take_the_plain_version():
    w, v, fm, rm = _inputs(SHAPES["tiny"], True, seed=2)
    before = dict(K.launches)
    a = K.cross_mil(_t(w), _t(v), _t(fm), _t(rm))
    assert K.launches == before
    want, _ = K.cross_mil_plain(_t(w).reshape(-1, w.shape[-1]), _t(v),
                                _t(fm), _t(rm))
    assert torch.equal(a, want.reshape(a.shape))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """Dtypes, layouts, alignment, masks and the grid's limits (I and the
    blocks of 32 words) outside what the kernel takes raise before any
    launch."""
    fm = torch.ones(2, 3)
    w = torch.zeros(4, 8)
    unaligned = torch.zeros(2 * 3 * 4 * 8 + 1)[1:].view(2, 3, 4, 8)
    for bad_w, bad_v, bad_fm, match in (
            (w, torch.zeros(2, 3, 0, 8), fm, "R"),
            (w.double(), torch.zeros(2, 3, 4, 8, dtype=torch.float64), fm,
             "float32, bfloat16 or float16"),
            (w, torch.zeros(2, 3, 8, 4).transpose(2, 3), fm, "contiguous"),
            (w, unaligned, fm, "aligned"),
            (w.bfloat16(), torch.zeros(2, 3, 4, 8), fm, "w_flat"),
            (torch.zeros(4, 6), torch.zeros(2, 3, 4, 8), fm, "w_flat"),
            (torch.zeros(4, 1), torch.zeros(65536, 1, 1, 1),
             torch.ones(65536, 1), "I <= 65535"),
            (torch.zeros(32 * 65535 + 1, 1), torch.zeros(1, 1, 1, 1),
             torch.ones(1, 1), "ceil")):
        with pytest.raises((ValueError, TypeError), match=match):
            K.launch(bad_w, bad_v, bad_fm, None)
    with pytest.raises(ValueError, match="rm"):
        K.launch(w, torch.zeros(2, 3, 4, 8), fm, torch.ones(2, 3, 5))
    with pytest.raises(ValueError, match="fm"):
        K.launch(w, torch.zeros(2, 3, 4, 8), torch.ones(2, 4), None)
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.cross_mil(torch.zeros(1, 4, 8, device="meta"),
                    torch.zeros(2, 3, 4, 8, device="meta"),
                    torch.ones(2, 3, device="meta"))


@pytest.mark.parametrize("r, e", [(4, 6), (4, 1024), (36, 50), (81, 3),
                                  (20, 516), (1, 1)])
def test_checks_take_any_width(r, e):
    """E not a multiple of 4, E > 512 and any R pass the checks: the
    general variant (or the f32 kernel, at E a multiple of 4) takes them."""
    for dt in (torch.float32, torch.bfloat16):
        v = torch.zeros(2, 3, r, e, dtype=dt)
        assert K._check_inputs(torch.zeros(5, e, dtype=dt), v,
                               torch.ones(2, 3),
                               torch.ones(2, 3, r)) == (2, 5, 3, r, e)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on "
                    "the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_gpu(cuda_device, dtype):
    """The CUDA kernel against the plain version on the card: a within
    1e-5 (both sum f32 products, in other orders), idx equal where the top
    two scores differ by more than that, and one launch a call."""
    tdt = None if dtype == "float32" else torch.bfloat16
    cases = [_inputs(SHAPES[c], True, seed=4) for c in sorted(SHAPES)]
    cases += [_edge_inputs(c) for c in sorted(EDGE_SHAPES)]
    cases += [_tie_inputs(r) for r in sorted(TIES)]
    for n, case in enumerate(cases):
        w, v, fm, rm = (_t(x).to(cuda_device) for x in case)
        wf = w.reshape(-1, w.shape[-1])
        if tdt is not None:
            wf, v = wf.to(tdt), v.to(tdt)
        before = K.launches["cross_mil"]
        a, idx = K.launch(wf, v, fm, rm)
        torch.cuda.synchronize()
        assert K.launches["cross_mil"] == before + 1
        ap, idxp = K.cross_mil_plain(wf, v, fm, rm)
        torch.testing.assert_close(a, ap, rtol=1e-5, atol=1e-5)
        s = torch.where(rm[:, None] > 0,
                        torch.einsum("me,itre->imtr", wf.float(), v.float()),
                        K.NEG)
        top2 = s.topk(min(2, s.shape[-1]), dim=-1).values
        clear = (top2[..., 0] - top2[..., -1] > 1e-5) | (s.shape[-1] == 1)
        assert torch.equal(idx[clear], idxp[clear])
        if n >= len(SHAPES) + len(EDGE_SHAPES):     # exact ties: the first
            assert torch.equal(idx, idxp)
