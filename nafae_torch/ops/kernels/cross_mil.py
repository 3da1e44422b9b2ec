"""Fused cross-similarity and MIL max: the CUDA kernel `csrc/cross_mil.cu`,
its wrapper, the autograd Function around it, and its plain PyTorch version.

Computes the ranking loss's per-frame MIL max over the global batch,

    a[i, j, k, t] = max_r ŵ[j, k] · v̂[i, t, r]    (masked; see below)

without the [I, J, K, T, R] score tensor. One kernel replaces both TPU
kernels of `nafae_tpu/ops/pallas/fused_ground.py`:

    cross_mil   K3a  _fwd_kernel      lane-grouped forward (R > 32)
                K3b  _rollmax_kernel  video-tiled roll-max forward (R <= 32)

The kernel treats a video as a [M,E] x [E,T·R] product with a segmented
max over each frame's R columns as its epilogue: f32 operands on CUDA cores
with 8 x 5 register tiles and a cp.async double buffer (full f32, no
TF32), bf16 and f16 operands on tensor cores (`mma.sync` m16n8k16, f32
accumulators; one template, the mma of the type). Blocks take whole
frames (80 columns: 4 frames at R = 20), so no dead region slot is
multiplied; every dot is summed over E in one
order wherever it sits in a tile, so exact ties stay ties and the first
region wins. The f32 kernel takes any E (its stages land by 16-, 8- or
4-byte copies as the rows allow); 16-bit shapes outside its kernel (E not
a multiple of 4, or above 512) take a general variant in the same source,
same blocks and epilogue, whose tensor-core product streams E through a
ring of stages: every E the reference takes. The source note of
`csrc/cross_mil.cu` has the design and the bound, PERF.md the measured
times.

Masks, as the reference: a region with rm = 0 scores NEG = -1e9; an invalid
frame gives a = 0; a valid frame with no valid region gives a = -1e9 and
idx 0. idx is the first region that reaches the max.

The backward, as in the reference (`fused_ground.py::_cross_mil_bwd`, a jnp
scan, not a Pallas kernel), is plain PyTorch on both devices: the whole
cotangent goes to the saved idx (not split across ties, as `torch.amax`
would), gated by fm · any_valid, as two one-hot products.

`cross_mil` sends CPU tensors to the plain version `cross_mil_plain`; on
CUDA tensors it launches the kernel or raises. `launches` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nafae_torch.device import matmul_precision
from nafae_torch.ops.kernels import DTYPE_CODES, _build
from nafae_torch.ops.kernels import check_tensor as _check

NEG = -1e9
MAX_GRID = 65535      # I, and the blocks of 32 words, along the grid's z, y
WORDS_A_BLOCK = 32

launches = {"cross_mil": 0}


def cross_mil_plain(w_flat: torch.Tensor, v: torch.Tensor, fm: torch.Tensor,
                    rm: torch.Tensor | None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: w_flat [M,E], v [I,T,R,E] (both in the
    compute dtype; products summed in f32), fm [I,T], rm [I,T,R] or None ->
    (a [I,M,T] f32, idx [I,M,T] int32)."""
    s = torch.einsum("me,itre->imtr", w_flat.float(), v.float())
    if rm is not None:
        s = torch.where(rm[:, None] > 0, s, NEG)
    a = torch.where(fm[:, None, :] > 0, s.amax(-1), 0.0)
    # argmax gives the first index on ties (torch.max does not promise to)
    return a, torch.argmax(s, dim=-1).to(torch.int32)


def cross_mil_bwd(w_flat: torch.Tensor, v: torch.Tensor, fm: torch.Tensor,
                  rm: torch.Tensor | None, idx: torch.Tensor,
                  da: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dw [M,E], dv [I,T,R,E]) in the inputs' dtypes: da [I,M,T] routed to
    the saved idx, gated by fm · any_valid (a frame with no valid region is
    the constant NEG), as one-hot products summed in f32, exact under
    model.matmul_precision=default too (the reference pins them at
    HIGHEST)."""
    m = w_flat.shape[0]
    i, t, r, e = v.shape
    gate = fm.float()
    if rm is not None:
        gate = gate * (rm.amax(-1) > 0).float()
    g = da.float() * gate[:, None, :]                             # [I,M,T]
    regions = torch.arange(r, device=v.device)
    oh = (idx[..., None] == regions).float() * g[..., None]       # [I,M,T,R]
    oh = oh.permute(0, 2, 3, 1)                                   # [I,T,R,M]
    with matmul_precision("highest"):
        dv = torch.matmul(oh, w_flat.float())                     # [I,T,R,E]
        dw = torch.matmul(oh.reshape(i * t * r, m).T,
                          v.float().reshape(i * t * r, e))        # [M,E]
    return dw.to(w_flat.dtype), dv.to(v.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("cross_mil")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.nafae_cross_mil.argtypes = [vp, vp, i, vp, vp, vp, vp, i, i, i, i, i,
                                    vp]
    lib.nafae_cross_mil.restype = i
    lib.nafae_cross_mil_floor.argtypes = [i, i, i, i, i, i, vp]
    lib.nafae_cross_mil_floor.restype = i
    return lib


def _check_inputs(w_flat: torch.Tensor, v: torch.Tensor, fm: torch.Tensor,
                  rm: torch.Tensor | None) -> tuple[int, int, int, int, int]:
    """Checks what the kernel takes; returns (I, M, T, R, E). Any R and E
    (the specialised kernels or the general variant); the limits left are
    the grid's."""
    if v.dim() != 4 or w_flat.dim() != 2:
        raise ValueError(f"need w_flat [M,E] and v [I,T,R,E], got "
                         f"{tuple(w_flat.shape)} and {tuple(v.shape)}")
    i, t, r, e = v.shape
    m = w_flat.shape[0]
    if v.dtype not in DTYPE_CODES:
        raise TypeError(f"v must be float32, bfloat16 or float16, got "
                        f"{v.dtype}")
    if r < 1 or e < 1:
        raise ValueError(f"cross_mil kernel takes R >= 1 and E >= 1, got "
                         f"R={r}, E={e}")
    if i > MAX_GRID or -(-m // WORDS_A_BLOCK) > MAX_GRID:
        raise ValueError(f"cross_mil kernel takes I <= {MAX_GRID} and "
                         f"ceil(M / {WORDS_A_BLOCK}) <= {MAX_GRID}, got I={i}, "
                         f"M={m}")
    dev = v.device
    _check("v", v, (i, t, r, e), v.dtype, dev, vector=True)
    _check("w_flat", w_flat, (m, e), v.dtype, dev, vector=True)
    _check("fm", fm, (i, t), torch.float32, dev)
    if rm is not None:
        _check("rm", rm, (i, t, r), torch.float32, dev)
    return i, m, t, r, e


def launch(w_flat: torch.Tensor, v: torch.Tensor, fm: torch.Tensor,
           rm: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel alone on CUDA tensors: checks what it takes, allocates
    a [I,M,T] f32 and idx [I,M,T] int32, and launches on the current
    stream."""
    i, m, t, r, e = _check_inputs(w_flat, v, fm, rm)
    dev = v.device
    lib = _lib()
    a = torch.empty((i, m, t), dtype=torch.float32, device=dev)
    idx = torch.empty((i, m, t), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.nafae_cross_mil(
            w_flat.data_ptr(), v.data_ptr(), DTYPE_CODES[v.dtype],
            fm.data_ptr(), rm.data_ptr() if rm is not None else None,
            a.data_ptr(), idx.data_ptr(), i, m, t, r, e,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cross_mil kernel launch failed: cudaError_t {err}")
    if i * m * t > 0:
        launches["cross_mil"] += 1
    return a, idx


def launch_floor(i: int, m: int, t: int, r: int, e: int,
                 dtype: torch.dtype, device) -> None:
    """Launches an empty kernel with the grid, block size and shared memory
    that `launch` uses for these sizes, on the current stream: the launch
    floor a measured time of the kernel is judged against. Not a launch of
    the kernel: `launches` does not count it."""
    with torch.cuda.device(device):
        err = _lib().nafae_cross_mil_floor(
            DTYPE_CODES[dtype], i, m, t, r, e,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cross_mil floor launch failed: cudaError_t {err}")


def _forward(w_flat, v, fm, rm):
    if v.device.type == "cpu":
        return cross_mil_plain(w_flat, v, fm, rm)
    if v.device.type != "cuda":
        raise ValueError(f"cross_mil runs on cuda or cpu, not {v.device}")
    return launch(w_flat, v, fm, rm)


class CrossMil(torch.autograd.Function):
    """a = cross_mil(w_flat, v) with the reference's VJP: the forward is the
    kernel on CUDA tensors (the plain version on CPU tensors) and saves idx;
    the backward routes the whole cotangent to idx (cross_mil_bwd). The
    masks get no gradient."""

    @staticmethod
    def forward(ctx, w_flat, v, fm, rm):
        a, idx = _forward(w_flat, v, fm, rm)
        ctx.save_for_backward(w_flat, v, fm, rm, idx)
        return a

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, da):
        w_flat, v, fm, rm, idx = ctx.saved_tensors
        dw, dv = cross_mil_bwd(w_flat, v, fm, rm, idx, da)
        return dw, dv, None, None


def cross_mil(w_emb: torch.Tensor, v_emb: torch.Tensor,
              frame_mask: torch.Tensor,
              region_mask: torch.Tensor | None = None,
              dtype=None) -> torch.Tensor:
    """Fused a[i,j,k,t] = masked max_r ŵ[j,k]·v̂[i,t,r] (the reference's
    `fused_ground.cross_mil`): w_emb [J,K,E], v_emb [I,T,R,E], frame_mask
    [I,T], region_mask [I,T,R] or None (every region valid) -> [I,J,K,T]
    f32. dtype (None: v_emb's; e.g. bfloat16, float16) casts both
    operands; the sums stay f32 and the gradients flow back through the
    casts."""
    j, k, e = w_emb.shape
    dt = dtype if dtype is not None else v_emb.dtype
    w_flat = w_emb.to(dt).reshape(j * k, e).contiguous()
    v = v_emb.to(dt).contiguous()
    rm = region_mask.float().contiguous() if region_mask is not None else None
    a = CrossMil.apply(w_flat, v, frame_mask.float().contiguous(), rm)
    return a.reshape(a.shape[0], j, k, a.shape[2])
