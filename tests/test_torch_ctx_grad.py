"""The gradient of the port's context mix against the JAX package's.

The port's plain version under autograd (`ctx_mix` on CPU tensors, the
plain version of K1fr, K1b and K1br) is held against `jax.grad` of the
TPU kernel `ctx_mix_pallas` in interpret mode, with `fused_ctx.
ALPHA_RESIDUAL` flipped to reach both of its cores (the residual route
K1fr/K1br and the recompute route K1f/K1b, as tests/test_pallas.py does),
and against `context_mix(impl="offset")`, on the same numpy inputs: ragged
frame masks, T=7 (not a multiple of the TPU's tile), a window at least as
long as the clip, a valid frame whose regions are all masked, and the
edges of the CUDA backward: E = 4 and 12 (within one 64-column slice, not
a multiple of 8), E = 68 (past one slice), R = 1 and 32, a video whose
valid frames have no valid region (ds = 0 for every pair into them), a
centre frame with no valid neighbour and an invalid centre frame between
valid ones; and shapes past its specialised kernels, which its general
variant takes: R = 36 with E = 1024, R = 33 with E = 50, E = 516,
w = 20 at T = 3, and R = 64 and 65 (the largest tile of its staged
kernels, and one past it). Limits:
f32 rtol 1e-5 / atol 1e-6 for u and dv; bf16 2e-2 (the JAX package's
bf16 tolerance: the TPU kernels round u and dv to bf16, the port keeps
them in f32). Against the TPU kernel in bf16, dv's atol is 2e-2 of its
largest entry: that kernel also rounds du_n and ds (the score gradient,
which 1/temp = 10 scales up) to bf16 before its products, so its error
follows the largest terms of each sum, not each entry's size.

The CUDA kernels themselves run only on a GPU: the `cuda` tests skip
here, and chip_smoke.py holds them against the plain version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nafae_tpu.ops.pallas.fused_ctx as FC
from nafae_tpu.ops import grounding as G
from nafae_torch.ops.kernels import ctx_mix as K

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
CASES = {                       # B, T, R, E, w, the TPU tile of the residual
    "ragged": (3, 8, 5, 16, 2, 4),
    "T7": (2, 7, 6, 16, 2, 7),
    "window_ge_T": (2, 2, 4, 8, 3, 2),
    # the edges of the CUDA backward (64-column slices, R padded to 32)
    "E4": (2, 6, 5, 4, 2, 6),
    "E12": (2, 6, 5, 12, 3, 6),
    "R1": (2, 6, 1, 8, 2, 6),
    "R32": (2, 4, 32, 8, 2, 4),
    "no_valid_region": (3, 6, 5, 16, 2, 6),
    # the edges of the CUDA forward: E past one 64-column slice, a centre
    # frame with no valid neighbour, an invalid centre between valid ones
    "E68": (2, 6, 5, 68, 2, 6),
    "frame_edges": (2, 8, 5, 16, 2, 8),
    # past the specialised kernels' envelope, where the CUDA backward takes
    # its general variant: R > 32, E > 512 or not a multiple of 4, w > 16
    # (the TPU kernel runs its Pallas path at each: _ctx_bwd_vmem_bytes
    # stays under its 16 MB gate)
    "R36_E1024": (2, 4, 36, 1024, 2, 4),
    "R33_E50": (2, 4, 33, 50, 3, 4),
    "E516": (2, 3, 5, 516, 2, 3),
    "w20_T3": (2, 3, 5, 8, 20, 3),
    # the general variant's edge: R = 64, its staged kernels' largest tile,
    # and R = 65, its wide kernels
    "R64": (2, 3, 64, 16, 2, 3),
    "R65": (2, 3, 65, 16, 2, 3),
}
# cases whose video 1 has valid frames with no valid region at all: every
# pair into them is a uniform-fallback group, whose ds is 0
MASKED_VIDEO = {"no_valid_region"}
# cases whose last video has the frame edges (see _inputs)
EDGE_CASES = {"frame_edges"}


def _inputs(b, t, r, e, w, seed=0, masked_video=False, edges=False):
    rng = np.random.RandomState(seed)
    v = rng.randn(b, t, r, e).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    fm = (rng.rand(b, t) > 0.3).astype(np.float32)
    fm[0, :2] = 1.0
    rm = (rng.rand(b, t, r) > 0.4).astype(np.float32)
    rm[0, 1, :] = 0.0                 # a valid frame with no valid region
    if masked_video:
        fm[1, :3] = 1.0
        rm[1] = 0.0                   # ... and a video of them
    if edges:                         # T >= 2w + 4
        fm[-1] = 1.0
        fm[-1, :2 * w + 1] = 0.0
        fm[-1, w] = 1.0               # frame w: no valid neighbour
        fm[-1, 2 * w + 2] = 0.0       # invalid, between valid frames
    return (np.pad(v, ((0, 0), (w, w), (0, 0), (0, 0))),
            np.pad(fm, ((0, 0), (w, w))),
            np.pad(rm, ((0, 0), (w, w), (0, 0))))


def _loss_jax(u):
    return jnp.sum(jnp.sin(u.astype(jnp.float32) * 1.3))


def _port(v_ext, fm_ext, rm_ext, w, dtype):
    v = torch.from_numpy(v_ext).requires_grad_()
    u, _ = K.ctx_mix(v, torch.from_numpy(fm_ext), w, 0.1, dtype=dtype,
                     rm_ext=torch.from_numpy(rm_ext))
    (g,) = torch.autograd.grad(torch.sum(torch.sin(u * 1.3)), v)
    return u.detach().numpy(), g.numpy()


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("route", ["residual", "recompute"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_grad_matches_the_tpu_kernel(case, route, dtype, monkeypatch):
    b, t, r, e, w, tile = CASES[case]
    v_ext, fm_ext, rm_ext = _inputs(b, t, r, e, w, seed=len(case),
                                    masked_video=case in MASKED_VIDEO,
                                    edges=case in EDGE_CASES)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    monkeypatch.setattr(FC, "ALPHA_RESIDUAL", route == "residual")

    def f(ve):
        return FC.ctx_mix_pallas(ve, jnp.asarray(fm_ext), w, 0.1, jdt,
                                 jnp.asarray(rm_ext), tile=tile)[0]

    u_j = f(jnp.asarray(v_ext))
    g_j = jax.grad(lambda ve: _loss_jax(f(ve)))(jnp.asarray(v_ext))
    u, g = _port(v_ext, fm_ext, rm_ext, w, tdt)
    g_j = np.asarray(g_j, np.float32)
    gtol = (TOL[dtype] if dtype == "float32"
            else dict(rtol=2e-2, atol=2e-2 * np.abs(g_j).max()))
    np.testing.assert_allclose(u, np.asarray(u_j, np.float32), **TOL[dtype])
    np.testing.assert_allclose(g, g_j, **gtol)


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("case", sorted(CASES))
def test_cases_reach_the_tpu_kernel(case, dtype):
    """Every case runs ctx_mix_pallas's Pallas kernel, not its XLA path:
    the backward's scoped-VMEM estimate stays under the gate."""
    b, t, r, e, w, _ = CASES[case]
    itemsize = 4 if dtype == "float32" else 2
    assert FC._ctx_bwd_vmem_bytes(t, -(-r // 8) * 8, e, w, itemsize) \
        <= FC._BWD_SCOPED_VMEM_LIMIT


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("case", sorted(CASES))
def test_grad_matches_the_offset_form(case, dtype):
    b, t, r, e, w, _ = CASES[case]
    v_ext, fm_ext, rm_ext = _inputs(b, t, r, e, w, seed=len(case) + 1,
                                    masked_video=case in MASKED_VIDEO,
                                    edges=case in EDGE_CASES)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16

    def f(ve):
        return G.context_mix(ve, jnp.asarray(fm_ext), w, 0.1, dtype=jdt,
                             rm_ext=jnp.asarray(rm_ext))[0]

    g_j = jax.grad(lambda ve: _loss_jax(f(ve)))(jnp.asarray(v_ext))
    _, g = _port(v_ext, fm_ext, rm_ext, w, tdt)
    np.testing.assert_allclose(g, np.asarray(g_j, np.float32), **TOL[dtype])


def test_all_masked_frame_gets_only_the_mix_gradient():
    """A valid neighbour frame with no valid region takes the uniform
    alpha, whose scores carry no gradient: its regions get exactly the
    mix term (1/R of each centre row's du_n), and the centres none from
    that offset's scores."""
    b, t, r, e, w = 1, 2, 3, 4, 1
    v_ext, fm_ext, rm_ext = _inputs(b, t, r, e, w, seed=3)
    fm_ext[:] = 0.0
    fm_ext[0, 1:3] = 1.0
    rm_ext[:] = 1.0
    rm_ext[0, 2] = 0.0                # centre frame 1 (extended 2): masked
    v = torch.from_numpy(v_ext).requires_grad_()
    u, _ = K.ctx_mix(v, torch.from_numpy(fm_ext), w, 0.1,
                     rm_ext=torch.from_numpy(rm_ext))
    du = torch.randn(u.shape, generator=torch.Generator().manual_seed(0))
    du[0, 1] = 0.0                    # no gradient from frame 1's own row
    (g,) = torch.autograd.grad(u, v, du)
    # frame 1's only valid neighbour is frame 0 (one valid offset: den 1)
    want = du[0, 0].sum(0) / r
    torch.testing.assert_close(g[0, 2], want.expand(r, e), rtol=1e-6,
                               atol=1e-7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on "
                    "the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_kernel_grads_match_plain_on_gpu(cuda_device, dtype, residual,
                                         monkeypatch):
    """CtxMix on the card (K1fr+K1br, or K1f+K1b) against autograd through
    the plain version on the same card: u within the forward's limits, K1fr's
    alpha within chip_smoke's, dv within rtol 1e-4 / atol 1e-5 in f32 and
    2e-2 in bf16 (the kernels round du_n, alpha and ds to bf16 where the
    TPU kernels do, the plain autograd at its casts; du is seeded, so the
    bf16 case is the same on every run)."""
    monkeypatch.setattr(K, "ALPHA_RESIDUAL", residual)
    tdt = None if dtype == "float32" else torch.bfloat16
    utol = (dict(rtol=1e-4, atol=1e-5) if dtype == "float32"
            else dict(rtol=1e-3, atol=1e-4))
    gtol = (dict(rtol=1e-4, atol=1e-5) if dtype == "float32"
            else dict(rtol=2e-2, atol=2e-2))
    alpha_tol = (dict(rtol=1e-4, atol=1e-6) if dtype == "float32"
                  else dict(rtol=1e-2, atol=1e-6))
    for case in sorted(CASES):
        b, t, r, e, w, _ = CASES[case]
        v_ext, fm_ext, rm_ext = (
            torch.from_numpy(a).to(cuda_device)
            for a in _inputs(b, t, r, e, w, masked_video=case in MASKED_VIDEO,
                             edges=case in EDGE_CASES))
        vk = v_ext.clone().requires_grad_()
        before = dict(K.launches)
        u, _ = K.ctx_mix(vk, fm_ext, w, 0.1, dtype=tdt, rm_ext=rm_ext)
        assert u.grad_fn is not None
        du = torch.randn(u.shape, generator=torch.Generator().manual_seed(0)
                         ).to(cuda_device)
        (g,) = torch.autograd.grad(u, vk, du)
        torch.cuda.synchronize()
        fwd, bwd = (("ctx_mix_fwd_res", "ctx_mix_bwd_res") if residual
                    else ("ctx_mix_fwd", "ctx_mix_bwd"))
        assert K.launches[fwd] == before[fwd] + 1
        assert K.launches[bwd] == before[bwd] + 1
        vp = v_ext.clone().requires_grad_()
        up, _ = K.context_mix_plain(vp, fm_ext, w, 0.1, dtype=tdt,
                                    rm_ext=rm_ext)
        (gp,) = torch.autograd.grad(up, vp, du)
        torch.testing.assert_close(u, up, **utol)
        torch.testing.assert_close(g, gp, **gtol)
        if residual:                  # K1fr's alpha: the values K1br reads
            vc = v_ext.to(tdt) if tdt is not None else v_ext
            _, alpha = K.launch_fwd(vc, fm_ext, w, 0.1, rm_ext, residual=True)
            torch.testing.assert_close(
                alpha.float(), K.context_alpha_plain(
                    vc, fm_ext, w, 0.1, rm_ext=rm_ext).float(), **alpha_tol)


@pytest.mark.cuda
def test_u_carries_autograd_on_gpu(cuda_device):
    """On a CUDA tensor that needs a gradient, u has a grad_fn (CtxMix);
    without autograd it has none and K1f alone runs."""
    v_ext, fm_ext, rm_ext = (torch.from_numpy(a).to(cuda_device)
                             for a in _inputs(2, 5, 4, 8, 2))
    u, _ = K.ctx_mix(v_ext.clone().requires_grad_(), fm_ext, 2, 0.1,
                     rm_ext=rm_ext)
    assert u.grad_fn is not None
    with torch.no_grad():
        before = K.launches["ctx_mix_fwd"]
        u2, _ = K.ctx_mix(v_ext.clone().requires_grad_(), fm_ext, 2, 0.1,
                          rm_ext=rm_ext)
    assert u2.grad_fn is None
    assert K.launches["ctx_mix_fwd"] == before + 1
