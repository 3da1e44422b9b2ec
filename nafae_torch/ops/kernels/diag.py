"""Diagonal epilogue of the config-4 training step: the CUDA kernels
`csrc/diag_epilogue.cu` (forward) and `csrc/diag_epilogue_bwd.cu`
(backward), their wrappers, the autograd Function that joins them, and
their plain PyTorch versions.

From the diagonal similarity s[b,k,t,r] = ŵ[b,k]·v̂[b,t,r] it computes, per
video, what the train step's `kernels="pallas"` route needs (the reference's
`fused_diag.diag_epilogue_pallas`):

    ctx_kt [B,K,T]  = Σ_r (s − sg ŝ)² · m,   ŝ = ŵ·u,  m = live ∧ fm ∧ has_ctx
    f      [B,T,K,E] = v̂[t, r*],  r* = first argmax_r of s over live regions
    clu_kt [B,K,T]  = ‖f − sg C[c*]‖²,  c* = first cosine argmax over centers

Two kernels replace the TPU's in `nafae_tpu/ops/pallas/fused_diag.py`:

    diag_epilogue      K4f  _fwd_kernel   forward, keeping small residuals
    diag_epilogue_bwd  K4b  _bwd_kernel   backward, from those residuals

K4f is two CUDA kernels a call: one normalises the centers once into a
scratch the wrapper allocates (`chat`); the main kernel, launched as its
programmatic dependent, runs one block of 3 frames an SM (a worker of 4 warps
a frame). Each warp takes one region at a time for the 2 x 8 word dots, the
words in registers and lanes over the columns, with one transposed
butterfly across the warp; the 3 workers then share a ring of the
normalised centers in shared memory for the cosine sims (f32: FFMA, a
butterfly a center; bf16 and f16: `mma.sync` on the tensor cores), and
r* and c* come from first-index (value, index) butterflies. K4b is one launch of two
kinds of block: per frame, dv from the words, the frame's ds and df staged
once (no v read); per video and 32-column slice, dw as ds [K, T·R] · v
[T·R, E], so v is read once. Shapes outside those kernels (K > 32, E not
a multiple of 4, E > 512) take a general variant of each in the same
sources: every K and E the reference takes. K4f's streams E through
shared memory in stages, a block a frame for the region scores (v and u
read once, up to 64 words a pass), then a block a tile of 16 rows of f
for the cosine sims (up to 128 centers a pass), each kernel the
programmatic dependent of the one before; K4b's is one launch of dw
blocks (a video's 64-column slice, up to 64 words a pass, only the rows
where d is nonzero read from v; where the grid has few of them, a
video's rows split over a cluster of up to 8 blocks whose sums meet in
distributed shared memory) and dv blocks (a frame and 256 columns, the
words' rows streamed in 64-column stages, dv written once from
registers). Both are bound by bytes (PERF.md §6 has their bounds, times
and the empty-kernel floors of their grids, `launch_floor_fwd` and
`launch_floor_bwd`).

The forward keeps d = (s − ŝ)·m [B,K,T,R], r* and c* [B,K,T] (0.2 MB at
config4), so the backward neither re-reads u nor recomputes the cluster
sims, where the TPU backward re-runs the whole forward. Selection ignores
frame validity (region mask only); the centers are normalised as
c·rsqrt(Σc² + 1e-8); ŝ, the centers and both argmaxes are stop-gradients and
f is returned stop-gradient. In bf16 and f16 mode the operands are 16-bit
with f32 sums, and the kernels and the plain versions round to that type
where the TPU kernels round: each ctx term (s−ŝ)²·m, the normalised centers
and the target center in the forward; dctx, ds and df in the backward
(f16 subnormals kept: at config 4's step dctx lies below f16's normals).
The gradients are f32 until autograd casts them to the inputs' dtypes. Every output has one order of
sums and no float atomics, so two launches give the same bits.

`diag_epilogue` sends CPU tensors to the plain versions; on CUDA tensors it
launches the kernels or raises. `diag_epilogue_plain` is the plain version
of the whole (forward and backward) on any device. `launches` counts
launches per kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nafae_torch.ops.grounding import l2_normalize
from nafae_torch.ops.kernels import DTYPE_CODES, _build
from nafae_torch.ops.kernels import check_tensor as _check

NEG = -1e9
MAX_B = 65535         # videos along the backward grid's y
MAX_FRAMES = 2**31 - 1   # frames along the general forward grid's x
MAX_BLOCKS = 2**31 - 1   # the backward's rows a video, its general grid's x

launches = {"diag_epilogue": 0, "diag_epilogue_bwd": 0}


def _rounder(dtype):
    """x rounded to the compute dtype's precision, kept f32 (identity for
    f32)."""
    if dtype != torch.float32:
        return lambda x: x.to(dtype).float()
    return lambda x: x


def diag_fwd_plain(w, v, u, centers, fm, hc, rm):
    """Plain version of K4f: w [B,K,E], v and u [B,T,R,E] in the compute
    dtype; centers [Kc,E] f32; fm, hc [B,T]; rm [B,T,R] or None. Returns
    (ctx [B,K,T], clu [B,K,T], f [B,T,K,E] f32, d [B,K,T,R] f32, r* and c*
    [B,K,T] int32)."""
    rnd = _rounder(v.dtype)
    wf, vf = w.float(), v.float()
    s = torch.einsum("bke,btre->bktr", wf, vf)
    shat = torch.einsum("bke,btre->bktr", wf, u.float())
    b, k, t, r = s.shape
    live = ((rm > 0) if rm is not None
            else torch.ones((b, t, r), dtype=torch.bool, device=s.device))
    live = live[:, None]                                          # [B,1,T,R]
    m = live & ((fm > 0) & (hc > 0))[:, None, :, None]
    diff = s - shat
    d = torch.where(m, diff, 0.0)
    ctx = torch.sum(rnd(torch.where(m, diff * diff, 0.0)), dim=-1)
    rstar = torch.argmax(torch.where(live, s, NEG), dim=-1)       # [B,K,T]
    bi = torch.arange(b, device=s.device)[:, None, None]
    ti = torch.arange(t, device=s.device)[None, None, :]
    f = vf[bi, ti, rstar]                                         # [B,K,T,E]
    sims = torch.einsum("bkte,ce->bktc", f,
                        rnd(l2_normalize(centers.float())))
    cstar = torch.argmax(sims, dim=-1)                            # [B,K,T]
    clu = torch.sum((f - rnd(centers.float()[cstar])) ** 2, dim=-1)
    return (ctx, clu, f.permute(0, 2, 1, 3).contiguous(), d,
            rstar.to(torch.int32), cstar.to(torch.int32))


def diag_bwd_plain(w, v, centers, d, rstar, cstar, f, dctx, dclu):
    """Plain version of K4b: the forward's inputs w, v, centers, residuals
    d, r*, c* and output f, and the cotangents dctx, dclu [B,K,T] -> (dw
    [B,K,E], dv [B,T,R,E]) f32."""
    rnd = _rounder(v.dtype)
    r = v.shape[2]
    ds = rnd((2.0 * rnd(dctx.float()))[..., None] * d)            # [B,K,T,R]
    dw = torch.einsum("bktr,btre->bke", ds, v.float())
    dv = torch.einsum("bktr,bke->btre", ds, w.float())
    tgt = rnd(centers.float()[cstar.long()])                      # [B,K,T,E]
    df = rnd((2.0 * dclu.float())[..., None]
             * (f.permute(0, 2, 1, 3) - tgt))                     # [B,K,T,E]
    oh = (rstar[..., None] == torch.arange(r, device=v.device)).float()
    return dw, dv + torch.einsum("bktr,bkte->btre", oh, df)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("diag_epilogue")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.nafae_diag_fwd.argtypes = [vp, vp, vp, i, vp, vp, vp, vp, vp, vp, vp,
                                   vp, vp, vp, vp, i, i, i, i, i, i, vp]
    lib.nafae_diag_fwd.restype = i
    lib.nafae_diag_fwd_floor.argtypes = [i] * 7 + [vp]
    lib.nafae_diag_fwd_floor.restype = i
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("diag_epilogue_bwd")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.nafae_diag_bwd.argtypes = [vp, vp, i, vp, vp, vp, vp, vp, vp, vp, vp,
                                   vp, i, i, i, i, i, vp]
    lib.nafae_diag_bwd.restype = i
    lib.nafae_diag_bwd_floor.argtypes = [i] * 6 + [vp]
    lib.nafae_diag_bwd_floor.restype = i
    return lib


def _check_inputs(w, v, centers,
                  backward: bool = False) -> tuple[int, int, int, int, int,
                                                   int]:
    """Checks what both kernels take (with `backward`, K4b's limits too);
    returns (B, K, T, R, E, Kc). Any K, R, E and Kc (the specialised
    kernels or the general variants); the limits left are the grids'."""
    if v.dim() != 4 or w.dim() != 3 or centers.dim() != 2:
        raise ValueError(f"need w [B,K,E], v [B,T,R,E], centers [Kc,E]; got "
                         f"{tuple(w.shape)}, {tuple(v.shape)}, "
                         f"{tuple(centers.shape)}")
    b, t, r, e = v.shape
    k, kc = w.shape[1], centers.shape[0]
    if v.dtype not in DTYPE_CODES:
        raise TypeError(f"v must be float32, bfloat16 or float16, got "
                        f"{v.dtype}")
    if k < 1 or r < 1 or e < 1 or kc < 1:
        raise ValueError(f"diag kernels take K, R, E and Kc >= 1, got K={k}, "
                         f"R={r}, E={e}, Kc={kc}")
    if b > MAX_B or b * t > MAX_FRAMES:
        raise ValueError(f"diag kernels take B <= {MAX_B} and B*T <= "
                         f"{MAX_FRAMES}, got B={b}, T={t}")
    # K4b: T*R rows a video, and B*(T+9)*ceil(E/64) blocks at most in the
    # general variant's grid (its dw blocks, up to 8 a video's slice, its dv
    # blocks and the padding of its clusters)
    if backward and (t * r > MAX_BLOCKS
                     or b * (t + 9) * -(-e // 64) > MAX_BLOCKS):
        raise ValueError(f"diag_epilogue_bwd takes T*R <= {MAX_BLOCKS} and "
                         f"B*(T+9)*ceil(E/64) <= {MAX_BLOCKS}, got B={b}, "
                         f"T={t}, R={r}, E={e}")
    dev = v.device
    # rows are read 16 (f32) or 8 (16-bit) bytes at a time
    _check("v", v, (b, t, r, e), v.dtype, dev, vector=True)
    _check("w", w, (b, k, e), v.dtype, dev, vector=True)
    _check("centers", centers, (kc, e), torch.float32, dev, vector=True)
    return b, k, t, r, e, kc


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def launch_fwd(w, v, u, centers, fm, hc, rm):
    """K4f alone on CUDA tensors (the inputs of diag_fwd_plain): checks what
    it takes, allocates its outputs and residuals, launches on the current
    stream. Returns what diag_fwd_plain returns."""
    b, k, t, r, e, kc = _check_inputs(w, v, centers)
    dev = v.device
    _check("u", u, (b, t, r, e), v.dtype, dev, vector=True)
    _check("fm", fm, (b, t), torch.float32, dev)
    _check("hc", hc, (b, t), torch.float32, dev)
    if rm is not None:
        _check("rm", rm, (b, t, r), torch.float32, dev)
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=dev)
    ctx = torch.empty((b, k, t), **f32)
    clu = torch.empty((b, k, t), **f32)
    f = torch.empty((b, t, k, e), **f32)
    d = torch.empty((b, k, t, r), **f32)
    rstar = torch.empty((b, k, t), dtype=torch.int32, device=dev)
    cstar = torch.empty((b, k, t), dtype=torch.int32, device=dev)
    chat = torch.empty((kc, e), dtype=v.dtype, device=dev)   # normalised C
    with torch.cuda.device(dev):
        err = lib.nafae_diag_fwd(
            w.data_ptr(), v.data_ptr(), u.data_ptr(),
            DTYPE_CODES[v.dtype], centers.data_ptr(),
            chat.data_ptr(), fm.data_ptr(), hc.data_ptr(),
            rm.data_ptr() if rm is not None else None, ctx.data_ptr(),
            clu.data_ptr(), f.data_ptr(), d.data_ptr(), rstar.data_ptr(),
            cstar.data_ptr(), b, k, t, r, e, kc, _stream(dev))
    if err != 0:
        raise RuntimeError(f"diag_epilogue kernel launch failed: "
                           f"cudaError_t {err}")
    if b * t > 0:
        launches["diag_epilogue"] += 1
    return ctx, clu, f, d, rstar, cstar


def launch_bwd(w, v, centers, d, rstar, cstar, f, dctx, dclu):
    """K4b alone on CUDA tensors (the inputs of diag_bwd_plain): returns
    (dw [B,K,E], dv [B,T,R,E]) f32, launched on the current stream."""
    b, k, t, r, e, _ = _check_inputs(w, v, centers, backward=True)
    dev = v.device
    _check("f", f, (b, t, k, e), torch.float32, dev, vector=True)
    _check("d", d, (b, k, t, r), torch.float32, dev)
    for name, x, dt in (("rstar", rstar, torch.int32),
                        ("cstar", cstar, torch.int32),
                        ("dctx", dctx, torch.float32),
                        ("dclu", dclu, torch.float32)):
        _check(name, x, (b, k, t), dt, dev)
    lib = _lib_bwd()
    dw = torch.empty((b, k, e), dtype=torch.float32, device=dev)
    dv = torch.empty((b, t, r, e), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.nafae_diag_bwd(
            w.data_ptr(), v.data_ptr(), DTYPE_CODES[v.dtype],
            centers.data_ptr(), d.data_ptr(), rstar.data_ptr(),
            cstar.data_ptr(), f.data_ptr(), dctx.data_ptr(), dclu.data_ptr(),
            dw.data_ptr(), dv.data_ptr(), b, k, t, r, e, _stream(dev))
    if err != 0:
        raise RuntimeError(f"diag_epilogue_bwd kernel launch failed: "
                           f"cudaError_t {err}")
    if b > 0:
        launches["diag_epilogue_bwd"] += 1
    return dw, dv


def launch_floor_fwd(b: int, k: int, t: int, r: int, e: int, kc: int,
                     dtype: torch.dtype, device) -> None:
    """Launches empty kernels with the grids, block size and shared memory
    that `launch_fwd` uses for these sizes (the second as the first's
    programmatic dependent), on the current stream: the launch floor a
    measured time of K4f is judged against. Not a launch of the kernel:
    `launches` does not count it."""
    with torch.cuda.device(device):
        err = _lib().nafae_diag_fwd_floor(DTYPE_CODES[dtype], b, k, t, r, e,
                                          kc, _stream(device))
    if err != 0:
        raise RuntimeError(f"diag_epilogue floor launch failed: "
                           f"cudaError_t {err}")


def launch_floor_bwd(b: int, k: int, t: int, r: int, e: int,
                     dtype: torch.dtype, device) -> None:
    """The same for `launch_bwd` (K4b): one empty kernel of its grid."""
    with torch.cuda.device(device):
        err = _lib_bwd().nafae_diag_bwd_floor(DTYPE_CODES[dtype], b, k, t, r,
                                              e, _stream(device))
    if err != 0:
        raise RuntimeError(f"diag_epilogue_bwd floor launch failed: "
                           f"cudaError_t {err}")


class DiagEpilogue(torch.autograd.Function):
    """(ctx_kt, clu_kt, f) from (w, v, u, centers, fm, hc, rm) with the
    reference's VJP, through the given forward and backward (the kernels'
    launchers or the plain versions). The gradient reaches w and v only,
    in their dtypes; f is returned non-differentiable."""

    @staticmethod
    def forward(ctx, fwd, bwd, w, v, u, centers, fm, hc, rm):
        ctx_kt, clu_kt, f, d, rstar, cstar = fwd(w, v, u, centers, fm, hc,
                                                 rm)
        ctx.save_for_backward(w, v, centers, d, rstar, cstar, f)
        ctx.bwd = bwd
        ctx.mark_non_differentiable(f)
        return ctx_kt, clu_kt, f

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dctx, dclu, _df):
        w, v, centers, d, rstar, cstar, f = ctx.saved_tensors
        dw, dv = ctx.bwd(w, v, centers, d, rstar, cstar, f,
                         dctx.float().contiguous(), dclu.float().contiguous())
        return (None, None, dw.to(w.dtype), dv.to(v.dtype), None, None, None,
                None, None)


def _apply(fwd, bwd, w_emb, v_emb, u, centers, frame_mask, region_mask,
           has_ctx, dtype):
    cdt = dtype if dtype is not None else v_emb.dtype
    out = DiagEpilogue.apply(
        fwd, bwd, w_emb.to(cdt).contiguous(), v_emb.to(cdt).contiguous(),
        u.detach().to(cdt).contiguous(), centers.detach().float().contiguous(),
        frame_mask.float().contiguous(), has_ctx.float().contiguous(),
        region_mask.float().contiguous() if region_mask is not None else None)
    return out[0], out[1], out[2].detach()


def diag_epilogue(w_emb: torch.Tensor, v_emb: torch.Tensor, u: torch.Tensor,
                  centers: torch.Tensor, frame_mask: torch.Tensor,
                  region_mask: torch.Tensor | None, has_ctx: torch.Tensor,
                  dtype=None):
    """The fused diag epilogue of one batch, with the signature and return
    layout of the reference's `diag_epilogue_pallas`: w_emb [B,K,E], v_emb
    [B,T,R,E], u [B,T,R,E] (context-mixed, a stop-gradient), centers
    [Kc,E], frame_mask [B,T], region_mask [B,T,R] or None, has_ctx [B,T]
    (1 where the frame has a valid neighbour); dtype the compute dtype
    (None: v_emb's). Returns (ctx_kt [B,K,T], clu_kt [B,K,T], f [B,T,K,E]
    stop-gradient); the caller applies the word mask. CPU tensors take the
    plain versions; CUDA tensors launch K4f and, in the backward, K4b."""
    if v_emb.device.type == "cpu":
        fwd, bwd = diag_fwd_plain, diag_bwd_plain
    elif v_emb.device.type == "cuda":
        fwd, bwd = launch_fwd, launch_bwd
    else:
        raise ValueError(f"diag_epilogue runs on cuda or cpu, not "
                         f"{v_emb.device}")
    return _apply(fwd, bwd, w_emb, v_emb, u, centers, frame_mask,
                  region_mask, has_ctx, dtype)


def diag_epilogue_plain(w_emb, v_emb, u, centers, frame_mask, region_mask,
                        has_ctx, dtype=None):
    """Plain version of `diag_epilogue` (forward and backward) on any
    device."""
    return _apply(diag_fwd_plain, diag_bwd_plain, w_emb, v_emb, u, centers,
                  frame_mask, region_mask, has_ctx, dtype)
