"""Context mixing (forward): the CUDA kernel `csrc/ctx_mix.cu`, its wrapper,
and its plain PyTorch version.

Computes the context-mixed region embeddings of the context-pooled model:

    (u [B,T,R,E] f32, nbr_valid [B,T,2w]) = ctx_mix(v_ext, fm_ext, w, temp, ...)

from the halo-extended region embeddings v_ext [B, w+T+w, R, E], the frame
mask fm_ext [B, w+T+w] and the optional region mask rm_ext [B, w+T+w, R].
The kernel replaces `nafae_tpu/ops/pallas/fused_ctx.py::_fwd_kernel`; its
source note says what bounds it on an H100. The plain version,
`context_mix_plain`, is a port of `nafae_tpu.ops.grounding.context_mix`
(impl="offset"); the CPU path and the tests use it, the GPU path never.

`ctx_mix` sends a CPU tensor to the plain version, and on a CUDA tensor
launches the kernel or raises. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nafae_torch.ops.kernels import _build

NEG = -1e9            # masked-logit fill, as in the reference softmax
MAX_R = 32            # the kernel keeps one register accumulator per region
MAX_E = 512           # one thread per embedding column, 512 threads a block

launches = 0


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


def context_mix_plain(v_ext: torch.Tensor, fm_ext: torch.Tensor, window: int,
                      temp: float, dtype=None,
                      rm_ext: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: a static loop over the 2w offsets, one
    [B,T,R,S] softmax and one mix product per offset."""
    w = window
    t = v_ext.shape[1] - 2 * w
    v_c = v_ext[:, w:w + t]                                   # [B,T,R,E]
    fm_c = fm_ext[:, w:w + t]                                 # [B,T]
    num = None
    for o in _offsets(w):
        v_o = v_ext[:, w + o:w + o + t]                       # [B,T,S,E]
        nv_o = fm_ext[:, w + o:w + o + t] * fm_c              # [B,T]
        ve, vn = _operands(v_c, v_o, dtype)
        logits = torch.einsum("btre,btse->btrs", ve, vn) / temp
        if rm_ext is not None:
            rm_o = rm_ext[:, w + o:w + o + t]                 # [B,T,S]
            logits = torch.where(rm_o[:, :, None, :] > 0, logits, NEG)
        # an all-NEG row (valid frame, no valid region) softmaxes to the
        # uniform 1/R, as in the reference
        a_nv = torch.softmax(logits, dim=-1) * nv_o[:, :, None, None]
        ae, vn2 = _operands(a_nv.to(v_ext.dtype), v_o, dtype)
        mix = torch.einsum("btrs,btse->btre", ae, vn2)
        num = mix if num is None else num + mix
    nbr_valid = nbr_valid_of(fm_ext, w)
    den = torch.clamp(nbr_valid.sum(-1), min=1.0)
    return num / den[:, :, None, None], nbr_valid


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ctx_mix")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.nafae_ctx_mix_fwd.argtypes = [vp, i, vp, vp, vp, i, i, i, i, i,
                                      ctypes.c_float, vp]
    lib.nafae_ctx_mix_fwd.restype = i
    return lib


def _check(name: str, x: torch.Tensor, shape: tuple, dtype, device) -> None:
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, v_ext on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch_kernel(v_ext: torch.Tensor, fm_ext: torch.Tensor, window: int,
                  temp: float, rm_ext: torch.Tensor | None) -> torch.Tensor:
    """The kernel alone on CUDA tensors: checks what it takes, allocates
    u [B,T,R,E] f32 and launches on the current stream (v_ext already in
    the compute dtype)."""
    global launches
    if v_ext.dim() != 4:
        raise ValueError(f"v_ext must be [B,T+2w,R,E], got {tuple(v_ext.shape)}")
    b, t_ext, r, e = v_ext.shape
    t = t_ext - 2 * window
    if v_ext.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"v_ext must be float32 or bfloat16, got {v_ext.dtype}")
    if window < 1 or t < 1:
        raise ValueError(f"need window >= 1 and T >= 1; got window={window}, "
                         f"T+2w={t_ext}")
    if not 1 <= r <= MAX_R:
        raise ValueError(f"ctx_mix kernel takes 1 <= R <= {MAX_R}, got R={r}")
    if e % 4 or not 4 <= e <= MAX_E:
        raise ValueError(f"ctx_mix kernel takes E a multiple of 4 in "
                         f"[4, {MAX_E}], got E={e}")
    if b > 65535:
        raise ValueError(f"ctx_mix kernel takes B <= 65535, got B={b}")
    dev = v_ext.device
    if not v_ext.is_contiguous() or v_ext.data_ptr() % 16:
        raise ValueError("v_ext must be contiguous and 16-byte aligned")
    _check("fm_ext", fm_ext, (b, t_ext), torch.float32, dev)
    if rm_ext is not None:
        _check("rm_ext", rm_ext, (b, t_ext, r), torch.float32, dev)
    lib = _lib()
    u = torch.empty((b, t, r, e), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.nafae_ctx_mix_fwd(
            v_ext.data_ptr(), int(v_ext.dtype == torch.bfloat16),
            fm_ext.data_ptr(),
            rm_ext.data_ptr() if rm_ext is not None else None,
            u.data_ptr(), b, t, r, e, window, float(temp),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ctx_mix kernel launch failed: cudaError_t {err}")
    if b > 0:
        launches += 1
    return u


def ctx_mix(v_ext: torch.Tensor, fm_ext: torch.Tensor, window: int,
            temp: float, dtype=None, rm_ext: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(u [B,T,R,E] f32, nbr_valid [B,T,2w]) on v_ext's device.

    dtype: compute dtype of the products (None = v_ext's own). CPU tensors
    take the plain version; CUDA tensors launch the kernel, on the current
    stream, or raise."""
    if not temp >= 0.02:
        raise ValueError(f"ctx_temp={temp}: the context mix takes temp >= "
                         "0.02 (|logits| <= 1/temp on l2-normalized regions)")
    if v_ext.device.type == "cpu":
        return context_mix_plain(v_ext, fm_ext, window, temp, dtype=dtype,
                                 rm_ext=rm_ext)
    if v_ext.device.type != "cuda":
        raise ValueError(f"ctx_mix runs on cuda or cpu, not {v_ext.device}")
    if dtype is not None:
        v_ext = v_ext.to(dtype)
    u = launch_kernel(v_ext, fm_ext, window, temp, rm_ext)
    return u, nbr_valid_of(fm_ext, window)
