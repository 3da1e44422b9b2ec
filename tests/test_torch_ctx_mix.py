"""The port's context mix (ops/kernels/ctx_mix.py) against the JAX package.

The plain version is held against JAX's fused TPU kernel `ctx_mix_pallas`
(interpret mode on the CPU, as tests/test_pallas.py runs it) and against
`context_mix(impl="offset")`, on the same numpy inputs: without and with a
region mask, ragged frame masks, a valid frame with no valid region (the
uniform-alpha group), a window at least as long as the clip, and the edges
of the CUDA forward (E = 4 and 68 against its 64-column slices, R = 1 and
32, a centre frame with no valid neighbour, an invalid centre frame
between valid ones), and shapes past its specialised kernels, which its
general variant takes (R = 36 with E = 1024, R = 33 with E = 50, E = 516,
w = 20 at T = 3). nbr_valid must match exactly; u within rtol 1e-5 /
atol 1e-6 in f32 and 2e-2 in bf16 (the TPU kernel returns bf16 u in bf16
mode; the port returns f32).

The CUDA kernel itself runs only on a GPU: `test_kernel_matches_plain_on_gpu`
skips here, and chip_smoke.py holds the kernel against the plain version on
the card at the serving shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafae_tpu.ops import grounding as G
from nafae_tpu.ops.pallas.fused_ctx import ctx_mix_pallas
from nafae_torch.ops.kernels import ctx_mix as K

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
CASES = {                       # B, T, R, E, w
    "ragged": (3, 7, 5, 16, 2),
    "window_ge_T": (2, 2, 4, 8, 3),
    "serving_R": (2, 5, 20, 32, 3),
    # the edges of the CUDA forward: 64-column slices of the mix, R padded
    # to 32 for the tensor cores, a centre frame with no valid neighbour
    # (cnt = 0, u = 0) and an invalid centre frame between valid ones
    "E4": (2, 6, 5, 4, 2),
    "E68": (2, 5, 5, 68, 2),
    "R1": (2, 6, 1, 8, 2),
    "R32": (2, 4, 32, 8, 2),
    "frame_edges": (2, 8, 5, 16, 2),
    # past the specialised kernels' envelope, where the CUDA forward takes
    # its general variant: R > 32, E > 512 or not a multiple of 4, w > 16
    "R36_E1024": (2, 4, 36, 1024, 2),
    "R33_E50": (2, 4, 33, 50, 3),
    "E516": (2, 3, 5, 516, 2),
    "w20_T3": (2, 3, 5, 8, 20),
}
# cases whose last video has the frame edges (see _inputs)
EDGE_CASES = {"frame_edges"}


def _inputs(b, t, r, e, w, seed=0, edges=False):
    rng = np.random.RandomState(seed)
    v = rng.randn(b, t, r, e).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    fm = (rng.rand(b, t) > 0.3).astype(np.float32)
    fm[0, 0] = 1.0
    rm = (rng.rand(b, t, r) > 0.4).astype(np.float32)
    rm[0, 0, :] = 0.0                 # a valid frame with no valid region
    if edges:                         # T >= 2w + 4
        fm[-1] = 1.0
        fm[-1, :2 * w + 1] = 0.0
        fm[-1, w] = 1.0               # frame w: no valid neighbour
        fm[-1, 2 * w + 2] = 0.0       # invalid, between valid frames
    return (np.pad(v, ((0, 0), (w, w), (0, 0), (0, 0))),
            np.pad(fm, ((0, 0), (w, w))),
            np.pad(rm, ((0, 0), (w, w), (0, 0))))


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("with_rm", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax(case, with_rm, dtype):
    b, t, r, e, w = CASES[case]
    v_ext, fm_ext, rm_ext = _inputs(b, t, r, e, w, seed=len(case),
                                    edges=case in EDGE_CASES)
    rm_ext = rm_ext if with_rm else None
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    u, nv = K.ctx_mix(torch.from_numpy(v_ext), torch.from_numpy(fm_ext), w,
                      0.1, dtype=tdt,
                      rm_ext=None if rm_ext is None
                      else torch.from_numpy(rm_ext))
    assert u.dtype == torch.float32 and u.shape == (b, t, r, e)
    jargs = (jnp.asarray(v_ext), jnp.asarray(fm_ext), w, 0.1, jdt,
             None if rm_ext is None else jnp.asarray(rm_ext))
    for name, (u_j, nv_j) in (("offset", G.context_mix(*jargs)),
                              ("pallas", ctx_mix_pallas(*jargs))):
        np.testing.assert_array_equal(nv.numpy(), np.asarray(nv_j),
                                      err_msg=name)
        np.testing.assert_allclose(u.numpy(), np.asarray(u_j, np.float32),
                                   err_msg=name, **TOL[dtype])
    if case in EDGE_CASES:            # cnt = 0 and the invalid centre: u = 0
        assert not u[-1, w].any() and not u[-1, 2 * w + 2].any()


def test_uniform_group_and_invalid_frames():
    """A valid neighbour frame with no valid region mixes its regions with
    the uniform 1/R; invalid centre frames give zero rows."""
    b, t, r, e, w = 1, 3, 4, 8, 1
    v_ext, fm_ext, rm_ext = _inputs(b, t, r, e, w, seed=5)
    fm_ext[:] = 0.0
    fm_ext[0, 1:3] = 1.0              # centre frames 0, 1 valid; 2 not
    rm_ext[:] = 1.0
    rm_ext[0, 2] = 0.0                # frame 1 (extended 2): no valid region
    u, nv = K.ctx_mix(torch.from_numpy(v_ext), torch.from_numpy(fm_ext), w,
                      0.1, rm_ext=torch.from_numpy(rm_ext))
    np.testing.assert_array_equal(nv[0].numpy(), [[0, 1], [1, 0], [0, 0]])
    # centre 0's only valid neighbour is frame 1: uniform over its regions
    want = np.broadcast_to(v_ext[0, 2].mean(0), (r, e))
    np.testing.assert_allclose(u[0, 0].numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(u[0, 2].numpy(), 0.0)


def test_cpu_tensors_take_the_plain_version():
    v_ext, fm_ext, rm_ext = (torch.from_numpy(a)
                             for a in _inputs(2, 4, 3, 8, 2, seed=1))
    before = dict(K.launches)
    got = K.ctx_mix(v_ext, fm_ext, 2, 0.1, rm_ext=rm_ext)
    want = K.context_mix_plain(v_ext, fm_ext, 2, 0.1, rm_ext=rm_ext)
    assert K.launches == before
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """temp below the kernel's bound, and (checked before any launch)
    dtypes, layouts and masks it does not take; any R, E and w pass the
    checks (the general variant takes them)."""
    v_ext, fm_ext, _ = (torch.from_numpy(a)
                        for a in _inputs(1, 3, 4, 8, 1, seed=2))
    with pytest.raises(ValueError, match="temp"):
        K.ctx_mix(v_ext, fm_ext, 1, 0.01)
    fm = torch.ones(1, 5)
    for bad, match in ((torch.zeros(1, 5, 4, 8, dtype=torch.float64),
                        "float32, bfloat16 or float16"),
                       (torch.zeros(1, 5, 8, 4).transpose(2, 3), "contiguous"),
                       (torch.zeros(1, 5, 0, 8), "R")):
        with pytest.raises((ValueError, TypeError), match=match):
            K.launch_fwd(bad, fm, 1, 0.1, None)
    with pytest.raises(ValueError, match="rm_ext"):
        K.launch_fwd(torch.zeros(1, 5, 4, 8), fm, 1, 0.1,
                     torch.ones(1, 5, 3))
    for r, e, w in ((33, 8, 1), (4, 516, 1), (4, 6, 1), (36, 50, 1),
                    (4, 8, 17)):
        v = torch.zeros(1, 3 + 2 * w, r, e)
        assert K._check_inputs(v, torch.ones(1, 3 + 2 * w), w,
                               torch.ones(1, 3 + 2 * w, r)) == (1, 3, r, e)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on "
                    "the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_kernel_matches_plain_on_gpu(cuda_device, dtype):
    """The CUDA kernel against the plain version on the card: the two round
    alike and differ only in the order of the sums (and in bf16 mode by an
    occasional alpha rounded the other way), so the limits are tighter than
    the tolerance against JAX."""
    tdt = None if dtype == "float32" else torch.bfloat16
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == "float32"
           else dict(rtol=1e-3, atol=1e-4))
    for case in sorted(CASES):
        b, t, r, e, w = CASES[case]
        v_ext, fm_ext, rm_ext = (
            torch.from_numpy(a).to(cuda_device)
            for a in _inputs(b, t, r, e, w, edges=case in EDGE_CASES))
        before = K.launches["ctx_mix_fwd"]
        u, nv = K.ctx_mix(v_ext, fm_ext, w, 0.1, dtype=tdt, rm_ext=rm_ext)
        torch.cuda.synchronize()
        assert K.launches["ctx_mix_fwd"] == before + 1
        up, nvp = K.context_mix_plain(v_ext, fm_ext, w, 0.1, dtype=tdt,
                                      rm_ext=rm_ext)
        assert torch.equal(nv, nvp)
        torch.testing.assert_close(u, up, **tol)
