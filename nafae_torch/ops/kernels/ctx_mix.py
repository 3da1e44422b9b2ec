"""Context mixing: the CUDA kernels `csrc/ctx_mix.cu` (forward) and
`csrc/ctx_mix_bwd.cu` (backward), their wrappers, the autograd Function
that joins them, and their plain PyTorch version.

Computes the context-mixed region embeddings of the context-pooled model:

    (u [B,T,R,E] f32, nbr_valid [B,T,2w]) = ctx_mix(v_ext, fm_ext, w, temp, ...)

from the halo-extended region embeddings v_ext [B, w+T+w, R, E], the frame
mask fm_ext [B, w+T+w] and the optional region mask rm_ext [B, w+T+w, R].
Four kernels replace the TPU's in `nafae_tpu/ops/pallas/fused_ctx.py`:

    ctx_mix_fwd      K1f   _fwd_kernel       forward
    ctx_mix_fwd_res  K1fr  _fwd_kernel_res   forward, storing alpha
    ctx_mix_bwd      K1b   _bwd_kernel       backward, alpha recomputed
    ctx_mix_bwd_res  K1br  _bwd_kernel_res   backward, alpha read back

Each source runs two CUDA kernels a call (per-pair scores and softmax,
then a per-frame sum), and says what bounds it on an H100. Each takes
every shape the reference takes: R <= 32, E a multiple of 4 in [4, 512]
and w <= 16 (and T <= 65535 for the backward) run its specialised
kernels; any other R, E, w >= 1 its general variant. Up to R = 64 and
w = 512 both directions' general variants stream E through shared
memory in stages, a block a pair of frames with its whole R x R tiles
there, then a per-frame kernel launched as its programmatic dependent
(the backward's pairs write, for each frame and neighbour, the matrices
its gather multiplies, into a scratch in v_ext's dtype); past those they
walk 32 regions and 64 columns at a time with scalar loads (the
backward's scratch then two f32 [B,T,2w,R,R] arrays). Left are B <=
65535, the general variant's grids (the forward's T + w and
T·ceil(E/128) blocks up to R = 64 and w = 512, else T·2w·ceil(R/32)
and T·ceil(R/32)·ceil(E/64); the backward's T + w and
(T+2w)·ceil(E/64) (16-bit: ceil(E/128)) up to R = 64 and w = 512, else
T·2w·ceil(R/32) and (T+2w)·ceil(R/32)·ceil(E/64); each under 2^31) and
device memory. Both count under the same `launches` keys. Every kernel
is a template on v_ext's type, instantiated for f32, bf16 and f16 (the
f16 kernels run the bf16 kernels' code: 16-bit operands on the tensor
cores, f32 sums, alpha, du_n and ds rounded to f16); `DTYPE_CODES` is the
entry points' dtype argument. The plain
version, `context_mix_plain`, is a port of
`nafae_tpu.ops.grounding.context_mix` (impl="offset"); under autograd it is
the plain version of all four.

`ctx_mix` takes one of two routes. With autograd on (v_ext needs a
gradient), a CPU tensor takes the plain version and a CUDA tensor goes
through `CtxMix`, whose forward launches K1fr (or K1f) and whose backward
launches K1br (or K1b). With autograd off (serving, eval, export), both go
through the custom op `torch.ops.nafae.ctx_mix_fwd` (`ctx_mix_fwd_op`):
its CUDA implementation launches K1f or raises, its CPU implementation is
the plain version, and its fake implementation gives the output's shape,
so that `torch.export` keeps the op, and with it K1f, in the exported
program (a ctypes call cannot run on the fake tensors export traces
with). The op is registered when this module is imported, which must
happen before `torch.export.load` of a program that holds it.
`launches` counts launches per kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nafae_torch.ops.kernels import DTYPE_CODES, _build
from nafae_torch.ops.kernels import check_tensor as _check

NEG = -1e9            # masked-logit fill, as in the reference softmax
MAX_B = 65535         # videos: the kernels' grids take them along y

# Route of the gradient, as fused_ctx.py routes it: with ALPHA_RESIDUAL the
# forward stores alpha [B,T,2w,R,R] (compute dtype) and the backward reads
# it back instead of recomputing the scores. The TPU also needs its frame
# tiles to divide T and its slab to fit VMEM; the port has no tiles and
# keeps the residual in device memory, so its only rule is on the
# residual's bytes: above ALPHA_MAX_BYTES the backward recomputes alpha.
ALPHA_RESIDUAL = True
ALPHA_MAX_BYTES = 256 << 20

launches = {"ctx_mix_fwd": 0, "ctx_mix_fwd_res": 0,
            "ctx_mix_bwd": 0, "ctx_mix_bwd_res": 0}


def _offsets(window: int) -> list[int]:
    return [o for o in range(-window, window + 1) if o != 0]


def _operands(a: torch.Tensor, b: torch.Tensor, dtype):
    """Round both product operands to the compute dtype, then multiply in
    f32: bf16 x bf16 products are exact in f32, so this is the reference's
    bf16-operand, f32-output contract (preferred_element_type=f32); a bf16
    torch product would round its output to bf16."""
    if dtype is not None:
        a, b = a.to(dtype), b.to(dtype)
    return a.float(), b.float()


def nbr_valid_of(fm_ext: torch.Tensor, window: int) -> torch.Tensor:
    """nbr_valid [B,T,2w]: 1 where the centre frame and its neighbour at
    each offset are both valid (halo frames have fm_ext = 0)."""
    w = window
    t = fm_ext.shape[1] - 2 * w
    fm_c = fm_ext[:, w:w + t]
    return torch.stack([fm_ext[:, w + o:w + o + t] for o in _offsets(w)],
                       dim=2) * fm_c[:, :, None]


def _offset_alpha(v_ext, fm_ext, window, temp, dtype, rm_ext, o):
    """(alpha * nv_o [B,T,R,S] f32, v_o [B,T,S,E]) of offset o."""
    w = window
    t = v_ext.shape[1] - 2 * w
    v_c = v_ext[:, w:w + t]                                   # [B,T,R,E]
    v_o = v_ext[:, w + o:w + o + t]                           # [B,T,S,E]
    nv_o = fm_ext[:, w + o:w + o + t] * fm_ext[:, w:w + t]    # [B,T]
    ve, vn = _operands(v_c, v_o, dtype)
    logits = torch.einsum("btre,btse->btrs", ve, vn) / temp
    if rm_ext is not None:
        rm_o = rm_ext[:, w + o:w + o + t]                     # [B,T,S]
        logits = torch.where(rm_o[:, :, None, :] > 0, logits, NEG)
    # an all-NEG row (valid frame, no valid region) softmaxes to the
    # uniform 1/R, as in the reference
    return torch.softmax(logits, dim=-1) * nv_o[:, :, None, None], v_o


def context_mix_plain(v_ext: torch.Tensor, fm_ext: torch.Tensor, window: int,
                      temp: float, dtype=None,
                      rm_ext: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: a static loop over the 2w offsets, one
    [B,T,R,S] softmax and one mix product per offset."""
    num = None
    for o in _offsets(window):
        a_nv, v_o = _offset_alpha(v_ext, fm_ext, window, temp, dtype, rm_ext,
                                  o)
        ae, vn2 = _operands(a_nv.to(v_ext.dtype), v_o, dtype)
        mix = torch.einsum("btrs,btse->btre", ae, vn2)
        num = mix if num is None else num + mix
    nbr_valid = nbr_valid_of(fm_ext, window)
    den = torch.clamp(nbr_valid.sum(-1), min=1.0)
    return num / den[:, :, None, None], nbr_valid


def context_alpha_plain(v_ext: torch.Tensor, fm_ext: torch.Tensor,
                        window: int, temp: float, dtype=None,
                        rm_ext: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K1fr's residual: alpha * nv_o as [B,T,2w,R,R] in the
    compute dtype (the values the mix multiplies by)."""
    dt = dtype if dtype is not None else v_ext.dtype
    return torch.stack([
        _offset_alpha(v_ext, fm_ext, window, temp, dtype, rm_ext, o)[0]
        .to(v_ext.dtype).to(dt) for o in _offsets(window)], dim=2)


def context_mix_bwd_plain(v_ext: torch.Tensor, fm_ext: torch.Tensor,
                          window: int, temp: float, du: torch.Tensor,
                          dtype=None, rm_ext: torch.Tensor | None = None,
                          alpha: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K1b (alpha None: recomputed in f32) and K1br (alpha:
    K1fr's residual [B,T,2w,R,R]) as the kernels, and the TPU kernels,
    round: dv_ext [B,T+2w,R,E] f32 from du [B,T,R,E] f32, with du_n =
    scale·du, the alpha of the products and ds rounded to the compute
    dtype (`dtype`, None: v_ext's) and every product summed in f32.
    Autograd through context_mix_plain computes the same function but
    rounds at its casts instead (the products' outputs), which at a
    16-bit dtype differs from the kernels by a few of its ulps, and by
    more where du_n is an f16 subnormal (du at gradient scale): this form
    differs from them by the order of the f32 sums alone."""
    dt = dtype if dtype is not None else v_ext.dtype
    rnd = ((lambda x: x) if dt == torch.float32
           else (lambda x: x.to(dt).float()))
    cdt = None if dt == torch.float32 else dt
    w = window
    t = v_ext.shape[1] - 2 * w
    v = rnd(v_ext.float())
    nbr = nbr_valid_of(fm_ext, w)
    scale = fm_ext[:, w:w + t] / torch.clamp(nbr.sum(-1), min=1.0)
    du_n = rnd(du * scale[:, :, None, None])
    dv = torch.zeros(v_ext.shape, dtype=torch.float32, device=v_ext.device)
    for i, o in enumerate(_offsets(w)):
        v_c, v_o = v[:, w:w + t], v[:, w + o:w + o + t]
        a = (_offset_alpha(v_ext, fm_ext, w, temp, cdt, rm_ext, o)[0]
             if alpha is None else alpha[:, :, i].float())
        ad = a * torch.einsum("btre,btse->btrs", du_n, v_o)
        ds = (ad - a * ad.sum(-1, keepdim=True)) / temp
        if rm_ext is not None:   # no valid region in t+o: the uniform alpha
            live = (rm_ext[:, w + o:w + o + t] > 0).any(-1)
            ds = torch.where(live[:, :, None, None], ds, 0.0)
        ds = rnd(ds)
        dv[:, w + o:w + o + t] += (
            torch.einsum("btrs,btre->btse", rnd(a), du_n)
            + torch.einsum("btrs,btre->btse", ds, v_c))
        dv[:, w:w + t] += torch.einsum("btrs,btse->btre", ds, v_o)
    return dv


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ctx_mix")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nafae_ctx_mix_fwd.argtypes = [vp, i, vp, vp, vp, vp, i, i, i, i, i,
                                      f, vp]
    lib.nafae_ctx_mix_fwd.restype = i
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("ctx_mix_bwd")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nafae_ctx_mix_bwd.argtypes = [vp, i, vp, vp, vp, vp, vp, i, i, i,
                                      i, i, f, vp]
    lib.nafae_ctx_mix_bwd.restype = i
    lib.nafae_ctx_mix_bwd_res.argtypes = [vp, i, vp, vp, vp, vp, vp, vp, i,
                                          i, i, i, i, f, vp]
    lib.nafae_ctx_mix_bwd_res.restype = i
    lib.nafae_ctx_mix_bwd_scratch.argtypes = [i, i, i, i, i, i]
    lib.nafae_ctx_mix_bwd_scratch.restype = ctypes.c_size_t
    lib.nafae_ctx_mix_bwd_floor.argtypes = [i] * 6 + [vp]
    lib.nafae_ctx_mix_bwd_floor.restype = i
    return lib


def _check_inputs(v_ext, fm_ext, window, rm_ext) -> tuple[int, int, int, int]:
    """Checks what every kernel takes; returns (B, T, R, E)."""
    if v_ext.dim() != 4:
        raise ValueError(f"v_ext must be [B,T+2w,R,E], got {tuple(v_ext.shape)}")
    b, t_ext, r, e = v_ext.shape
    t = t_ext - 2 * window
    if v_ext.dtype not in DTYPE_CODES:
        raise TypeError(f"v_ext must be float32, bfloat16 or float16, got "
                        f"{v_ext.dtype}")
    if window < 1 or t < 1 or r < 1 or e < 1:
        raise ValueError(f"ctx_mix takes window, T, R and E >= 1; got "
                         f"window={window}, T+2w={t_ext}, R={r}, E={e}")
    if b > MAX_B:
        raise ValueError(f"ctx_mix kernel takes B <= {MAX_B}, got B={b}")
    _check("v_ext", v_ext, tuple(v_ext.shape), v_ext.dtype, v_ext.device,
           vector=True)
    _check("fm_ext", fm_ext, (b, t_ext), torch.float32, v_ext.device)
    if rm_ext is not None:
        _check("rm_ext", rm_ext, (b, t_ext, r), torch.float32, v_ext.device)
    return b, t, r, e


def _ptr(x: torch.Tensor | None):
    return x.data_ptr() if x is not None else None


def launch_fwd(v_ext: torch.Tensor, fm_ext: torch.Tensor, window: int,
               temp: float, rm_ext: torch.Tensor | None,
               residual: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """K1f (or, with `residual`, K1fr) alone on CUDA tensors: checks what it
    takes, allocates u [B,T,R,E] f32 and alpha [B,T,2w,R,R] in v_ext's
    dtype, and launches on the current stream (v_ext already in the compute
    dtype). One call runs the source's two kernels (pairs, then mix), with
    alpha between them: K1fr returns it as the backward's residual, K1f
    drops it. Returns (u, alpha or None)."""
    b, t, r, e = _check_inputs(v_ext, fm_ext, window, rm_ext)
    dev = v_ext.device
    lib = _lib()
    u = torch.empty((b, t, r, e), dtype=torch.float32, device=dev)
    alpha = torch.empty((b, t, 2 * window, r, r), dtype=v_ext.dtype,
                        device=dev)
    with torch.cuda.device(dev):
        err = lib.nafae_ctx_mix_fwd(
            v_ext.data_ptr(), DTYPE_CODES[v_ext.dtype], fm_ext.data_ptr(), _ptr(rm_ext), u.data_ptr(), alpha.data_ptr(),
            b, t, r, e, window, float(temp),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ctx_mix kernel launch failed: cudaError_t {err}")
    if b > 0:
        launches["ctx_mix_fwd_res" if residual else "ctx_mix_fwd"] += 1
    return u, alpha if residual else None


def launch_bwd(v_ext: torch.Tensor, fm_ext: torch.Tensor, window: int,
               temp: float, rm_ext: torch.Tensor | None, du: torch.Tensor,
               alpha: torch.Tensor | None = None) -> torch.Tensor:
    """K1b (alpha None: recomputed) or K1br (alpha from launch_fwd's
    residual) alone on CUDA tensors: du [B,T,R,E] f32 -> dv_ext
    [B,T+2w,R,E] f32, halo frames included, on the current stream. One
    call runs the source's two kernels (pairs, then gather) through a
    scratch in v_ext's dtype, as large as the C function
    nafae_ctx_mix_bwd_scratch says for the shape (the pairs' matrices and,
    in 16 bits, du_n)."""
    b, t, r, e = _check_inputs(v_ext, fm_ext, window, rm_ext)
    dev = v_ext.device
    _check("du", du, (b, t, r, e), torch.float32, dev, vector=True)
    if alpha is not None:
        _check("alpha", alpha, (b, t, 2 * window, r, r), v_ext.dtype, dev)
    lib = _lib_bwd()
    dv = torch.empty(v_ext.shape, dtype=torch.float32, device=dev)
    code = DTYPE_CODES[v_ext.dtype]
    scratch = torch.empty(lib.nafae_ctx_mix_bwd_scratch(
        b, t, r, e, window, code), dtype=v_ext.dtype, device=dev)
    common = (fm_ext.data_ptr(), _ptr(rm_ext))
    tail = (du.data_ptr(), dv.data_ptr(), scratch.data_ptr(), b, t, r, e,
            window, float(temp), torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        if alpha is None:
            err = lib.nafae_ctx_mix_bwd(v_ext.data_ptr(), code, *common,
                                        *tail)
        else:
            err = lib.nafae_ctx_mix_bwd_res(v_ext.data_ptr(), code, *common,
                                            alpha.data_ptr(), *tail)
    if err != 0:
        raise RuntimeError(f"ctx_mix backward kernel launch failed: "
                           f"cudaError_t {err}")
    if b > 0:
        launches["ctx_mix_bwd" if alpha is None else "ctx_mix_bwd_res"] += 1
    return dv


def launch_floor_bwd(b: int, t: int, r: int, e: int, window: int,
                     dtype: torch.dtype, device) -> None:
    """Launches empty kernels with the grids, block size and shared memory
    that `launch_bwd`'s general variant (K1b or K1br) uses for these sizes,
    on the current stream: the launch floor a measured time of it is
    judged against. Raises for shapes the specialised kernels take. Not a
    launch of the kernel: `launches` does not count it."""
    with torch.cuda.device(device):
        err = _lib_bwd().nafae_ctx_mix_bwd_floor(
            DTYPE_CODES[dtype], b, t, r, e, window,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ctx_mix backward floor launch failed: "
                           f"cudaError_t {err}")


def use_residual(v_ext: torch.Tensor, window: int) -> bool:
    """Whether CtxMix keeps alpha for the backward (see ALPHA_RESIDUAL)."""
    b, t_ext, r, _ = v_ext.shape
    nbytes = b * (t_ext - 2 * window) * 2 * window * r * r \
        * v_ext.element_size()
    return ALPHA_RESIDUAL and nbytes <= ALPHA_MAX_BYTES


@torch.library.custom_op("nafae::ctx_mix_fwd", mutates_args=(),
                         device_types="cpu")
def ctx_mix_fwd_op(v_ext: torch.Tensor, fm_ext: torch.Tensor,
                   rm_ext: torch.Tensor | None, window: int,
                   temp: float) -> torch.Tensor:
    """u [B,T,R,E] f32 without autograd, v_ext already in the compute
    dtype. This body is the CPU implementation: the plain version."""
    return context_mix_plain(v_ext, fm_ext, window, temp, rm_ext=rm_ext)[0]


@ctx_mix_fwd_op.register_kernel("cuda")
def _ctx_mix_fwd_cuda(v_ext, fm_ext, rm_ext, window, temp):
    return launch_fwd(v_ext, fm_ext, window, temp, rm_ext)[0]


@ctx_mix_fwd_op.register_fake
def _ctx_mix_fwd_fake(v_ext, fm_ext, rm_ext, window, temp):
    b, t_ext, r, e = v_ext.shape
    return v_ext.new_empty((b, t_ext - 2 * window, r, e),
                           dtype=torch.float32)


class CtxMix(torch.autograd.Function):
    """u = ctx_mix(v_ext) on CUDA tensors with its gradient in CUDA kernels:
    K1fr then K1br when `use_residual`, else K1f then K1b. The gradient
    reaches v_ext only (dv in v_ext's dtype); the masks get none."""

    @staticmethod
    def forward(ctx, v_ext, fm_ext, rm_ext, window, temp):
        residual = use_residual(v_ext, window)
        u, alpha = launch_fwd(v_ext, fm_ext, window, temp, rm_ext,
                              residual=residual)
        ctx.save_for_backward(v_ext, fm_ext, rm_ext, alpha)
        ctx.window, ctx.temp = window, temp
        return u

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, du):
        v_ext, fm_ext, rm_ext, alpha = ctx.saved_tensors
        dv = launch_bwd(v_ext, fm_ext, ctx.window, ctx.temp, rm_ext,
                        du.float().contiguous(), alpha)
        return dv.to(v_ext.dtype), None, None, None, None


def ctx_mix(v_ext: torch.Tensor, fm_ext: torch.Tensor, window: int,
            temp: float, dtype=None, rm_ext: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(u [B,T,R,E] f32, nbr_valid [B,T,2w]) on v_ext's device.

    dtype: compute dtype of the products (None = v_ext's own). CPU tensors
    take the plain version; CUDA tensors launch the kernels, on the current
    stream, or raise (see the module docstring for the two routes). u
    carries autograd to v_ext whenever autograd is on and v_ext needs a
    gradient."""
    if not temp >= 0.02:
        raise ValueError(f"ctx_temp={temp}: the context mix takes temp >= "
                         "0.02 (|logits| <= 1/temp on l2-normalized regions)")
    if v_ext.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ctx_mix runs on cuda or cpu, not {v_ext.device}")
    if torch.is_grad_enabled() and v_ext.requires_grad:
        if v_ext.device.type == "cpu":
            return context_mix_plain(v_ext, fm_ext, window, temp,
                                     dtype=dtype, rm_ext=rm_ext)
        if dtype is not None:
            v_ext = v_ext.to(dtype)
        u = CtxMix.apply(v_ext.contiguous(), fm_ext, rm_ext, window,
                         float(temp))
    else:
        if dtype is not None:
            v_ext = v_ext.to(dtype)
        u = ctx_mix_fwd_op(v_ext.contiguous(), fm_ext, rm_ext, window,
                           float(temp))
    return u, nbr_valid_of(fm_ext, window)
