"""Times this tree's context mix (K1f and K1fr, csrc/ctx_mix.cu; K1br and
K1b, csrc/ctx_mix_bwd.cu), greedy NMS (K2, csrc/nms.cu), fused cross-MIL
(K3, csrc/cross_mil.cu) and diagonal epilogue (K4f, csrc/diag_epilogue.cu;
K4b, csrc/diag_epilogue_bwd.cu) against other versions of the same
sources, on one card, in one process, on the main path's own inputs:

- K1f: the first config-4 serving batch (B=16, T=20, R=20, E=256, w=3,
  planted-signal oracle weights, chip_smoke.timings' inputs), v_ext in f32
  and in bf16;
- K1fr / K1br / K1b: the first config-4 training batch, v_ext in f32 and in
  bf16, du from a seed;
- K3 / K4f / K4b: the first config-4 training batch's fused-route inputs
  (chip_smoke.fused_inputs: I=B=16, M=128, K=8, Kc=67) in f32 and bf16, K4b
  on this tree's K4f residuals with cotangents from a seed, as
  chip_smoke.fused_timings runs them;
- K2: the first config-5 batch's detector planes (320 rows x 24,000
  anchors, num_keep 20), from the f32 and from the bf16 detector;
- f16 against bf16 (f16_ab): this tree's K1f / K1fr / K1br / K1b, both
  instantiations of one source through one path, on the first config-4
  training batch and at R=36, E=1024, w=3, timed in turns;
- the general variants at phase 17's shapes (B=16, T=20): K1f / K1fr /
  K1br / K1b at R=36, E=1024, w=3 and R=20, E=50, w=20
  (chip_smoke.ANY_TIMED) on chip_smoke.ctx_inputs' random masks, K3 on
  the fused route's inputs of those fits, and K4f / K4b on the fused
  route's inputs of every phase-17 fit (chip_smoke.ANY_FITS: also K=40;
  K4b on each version's own K4f residuals), in f32 and bf16 (any_ab; the
  other versions must take those shapes).

    python3 kernel_ab.py DIR [DIR ...]

Each DIR holds another version's ctx_mix.cu, ctx_mix_bwd.cu, nms.cu,
cross_mil.cu, diag_epilogue.cu and diag_epilogue_bwd.cu (with the
ctx_mix_common.cuh
they include), for example `git archive <commit> nafae_torch/csrc`
unpacked under the git-ignored build/. Each C interface in use since the
first port is taken (a forward whose alpha is null for K1f, or one that
always takes alpha and refuses a null one; a backward with or without a
scratch; NMS with or without tiers; K4f with or without the normalised
centers' scratch). Every version is first held to this tree's output
(K1f/K1fr within chip_smoke.CTX_TOL and ALPHA_TOL, K1b/K1br within
GRAD_TOL, K2 exactly, K3 within CROSS_TOL with idx equal where clear of
ties, K4f/K4b within DIAG_TOL with r* and c* equal where clear of ties;
whether K1's, K3's and K4's outputs are bit for bit this tree's is
recorded), then timed with CUDA graphs (chip_smoke.device_ms) in the
order others, tree, tree, others reversed. Then one f32 serving batch is
timed host to host (numpy in, numpy out) with each version's K1f swapped
into the server, beside the batch's copy to the card alone, in
interleaved rounds (serving_host_ab). Also records each version's
registers, stack and spills of ctx_mix_bwd.cu's kernels (ptxas -v).
Prints one JSON object as its last line and writes it to
build/kernel_ab.json.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

import chip_smoke as CS

ROOT = Path(__file__).resolve().parent


SOURCES = ("ctx_mix", "ctx_mix_bwd", "nms", "cross_mil", "diag_epilogue",
           "diag_epilogue_bwd")


def ptxas_usage(log: str) -> dict[str, str]:
    """{kernel (mangled name): its registers, stack frame, spills and
    shared memory} from the log of an nvcc run with -Xptxas -v."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            out[name] = ""
        elif name and ("registers" in ln or "spill" in ln):
            out[name] = (out[name] + " " + ln.split(" : ")[-1].strip()).strip()
    return out


def build(dirs: list[Path]) -> tuple[dict[str, dict], dict[str, dict]]:
    """nvcc of each DIR's SOURCES into build/kernel_ab/, all at once;
    ({DIR name: {source name: loaded library}}, {DIR name: ptxas_usage of
    its ctx_mix_bwd.cu})."""
    from nafae_torch.ops.kernels import _build

    procs = {}
    for d in dirs:
        out = ROOT / "build" / "kernel_ab" / d.name
        out.mkdir(parents=True, exist_ok=True)
        for n in SOURCES:
            procs[d.name, n] = (out / f"lib{n}.so", subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                 str(out / f"lib{n}.so"), str(d / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {d.name: {} for d in dirs}
    usage = {}
    for (d, n), (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            CS.fail(f"nvcc failed on {d}/{n}.cu:\n{log}")
        libs[d][n] = ctypes.CDLL(str(so))
        if n == "ctx_mix_bwd":
            usage[d] = ptxas_usage(log)
    return libs, usage


def bind(torch, libs: dict):
    """(nms(x1, y1, x2, y2, sc) -> (idx, valid), bwd(v, fm, rm, du, w,
    temp, alpha) -> dv, fwd(v, fm, rm, w, temp, residual) -> (u, alpha or
    None), K4f, K4b, K3) for one version's libraries, any interface; K4f,
    K4b and K3 take and give what the tree's diag.launch_fwd / launch_bwd
    and cross_mil.launch do. The context mix's dtype argument is
    ctx_mix.DTYPE_CODES' code (0 f32, 1 bf16; 2 f16, which versions before
    the f16 kernels read as bf16: give them no f16 tensor)."""
    from nafae_torch.ops.kernels.ctx_mix import DTYPE_CODES

    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ln, lb, lf = libs["nms"], libs["ctx_mix_bwd"], libs["ctx_mix"]
    lf.nafae_ctx_mix_fwd.argtypes = [vp, i, vp, vp, vp, vp] + [i] * 5 + [f, vp]
    lf.nafae_ctx_mix_fwd.restype = i
    # a forward that always takes alpha refuses a null one, before any
    # launch (B = 0 launches nothing in either interface)
    alpha_always = lf.nafae_ctx_mix_fwd(None, 0, None, None, None, None,
                                        0, 1, 1, 4, 1, 1.0, None) != 0
    tiered = hasattr(ln, "nafae_nms_tier_boxes")
    ln.nafae_nms.argtypes = [vp] * 8 + [i, i, i, f, vp]
    ln.nafae_nms.restype = i
    if not tiered:
        ln.nafae_nms_smem_boxes.argtypes = []
        ln.nafae_nms_smem_boxes.restype = i
    scratched = hasattr(lb, "nafae_ctx_mix_bwd_scratch")
    extra = [vp] if scratched else []
    lb.nafae_ctx_mix_bwd.argtypes = [vp, i, vp, vp, vp, vp] + extra + \
        [i] * 5 + [f, vp]
    lb.nafae_ctx_mix_bwd_res.argtypes = [vp, i, vp, vp, vp, vp, vp] + \
        extra + [i] * 5 + [f, vp]
    lb.nafae_ctx_mix_bwd.restype = lb.nafae_ctx_mix_bwd_res.restype = i
    if scratched:
        lb.nafae_ctx_mix_bwd_scratch.argtypes = [i] * 6
        lb.nafae_ctx_mix_bwd_scratch.restype = ctypes.c_size_t

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def nms(x1, y1, x2, y2, sc, keep=20, thresh=0.7):
        b, n = sc.shape
        idx = torch.empty(b, keep, dtype=torch.int32, device=sc.device)
        val = torch.empty(b, keep, device=sc.device)
        ptrs = [x.data_ptr() for x in (x1, y1, x2, y2, sc)]
        if tiered:
            args = ptrs + [idx.data_ptr(), val.data_ptr(), None]
        else:
            scr = (torch.empty(b, n, device=sc.device)
                   if n > ln.nafae_nms_smem_boxes() else None)
            args = ptrs + [scr.data_ptr() if scr is not None else None,
                           idx.data_ptr(), val.data_ptr()]
        if ln.nafae_nms(*args, b, n, keep, thresh, stream()):
            CS.fail("nms launch failed")
        return idx, val

    def bwd(v, fm, rm, du, w, temp, alpha=None):
        b, te, r, e = v.shape
        dv = torch.empty(v.shape, device=v.device)
        bf = DTYPE_CODES[v.dtype]
        scr = []
        if scratched:
            s = torch.empty(lb.nafae_ctx_mix_bwd_scratch(b, te - 2 * w, r, e,
                                                         w, bf),
                            dtype=v.dtype, device=v.device)
            scr = [s.data_ptr()]
        head = [v.data_ptr(), bf, fm.data_ptr(), rm.data_ptr()]
        tail = [du.data_ptr(), dv.data_ptr(), *scr, b, te - 2 * w, r, e, w,
                temp, stream()]
        err = (lb.nafae_ctx_mix_bwd(*head, *tail) if alpha is None else
               lb.nafae_ctx_mix_bwd_res(*head, alpha.data_ptr(), *tail))
        if err:
            CS.fail(f"ctx_mix_bwd launch failed: {err}")
        return dv

    def fwd(v, fm, rm, w, temp, residual=False):
        b, te, r, e = v.shape
        t = te - 2 * w
        u = torch.empty(b, t, r, e, device=v.device)
        alpha = (torch.empty(b, t, 2 * w, r, r, dtype=v.dtype, device=v.device)
                 if residual or alpha_always else None)
        err = lf.nafae_ctx_mix_fwd(
            v.data_ptr(), DTYPE_CODES[v.dtype], fm.data_ptr(),
            rm.data_ptr() if rm is not None else None, u.data_ptr(),
            alpha.data_ptr() if alpha is not None else None, b, t, r, e, w,
            temp, stream())
        if err:
            CS.fail(f"ctx_mix launch failed: {err}")
        return u, alpha if residual else None

    return nms, bwd, fwd, *bind_diag(torch, libs), bind_cross(torch, libs)


def bind_cross(torch, libs: dict):
    """K3 of one version's cross_mil library (one interface since the
    first port): (w_flat, v, fm, rm) -> (a, idx)."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib = libs["cross_mil"]
    lib.nafae_cross_mil.argtypes = [vp, vp, i, vp, vp, vp, vp] + [i] * 5 + [vp]
    lib.nafae_cross_mil.restype = i

    def k3(w, v, fm, rm):
        n, t, m = v.shape[0], v.shape[1], w.shape[0]
        a = torch.empty((n, m, t), device=v.device)
        idx = torch.empty((n, m, t), dtype=torch.int32, device=v.device)
        err = lib.nafae_cross_mil(
            w.data_ptr(), v.data_ptr(), int(v.dtype == torch.bfloat16),
            fm.data_ptr(), rm.data_ptr(), a.data_ptr(), idx.data_ptr(), n, m,
            t, v.shape[2], v.shape[3],
            torch.cuda.current_stream().cuda_stream)
        if err:
            CS.fail(f"cross_mil launch failed: {err}")
        return a, idx

    return k3


def cross_ab(torch, others: dict, ins, tag: str) -> dict:
    """K3 of this tree against the other versions on the first training
    batch's fused-route inputs in one dtype: each version's a within
    CROSS_TOL of this tree's and idx equal where the top two scores are
    clear of ties; then whether bit for bit this tree's, the a_b times and
    this tree's time by kernel."""
    from nafae_torch.ops.kernels import cross_mil as K3

    w, v, fm, rm = ins
    rtol, atol = CS.CROSS_TOL
    fns = {"tree": lambda: K3.launch(w, v, fm, rm)}
    want_a, want_i = fns["tree"]()
    s = torch.where(rm[:, None] > 0, torch.einsum(
        "me,itre->imtr", w.float(), v.float()), K3.NEG)
    clear = CS.clear_of_ties(torch, s)
    equal = {}
    for name, (*_, ok3) in others.items():
        fns[name] = lambda ok3=ok3: ok3(w, v, fm, rm)
        got_a, got_i = fns[name]()
        if not (torch.allclose(got_a, want_a, rtol=rtol, atol=atol)
                and torch.equal(got_i[clear], want_i[clear])):
            CS.fail(f"K3 {tag}: {name} differs from this tree")
        equal[name] = bool(torch.equal(got_a, want_a)
                           and torch.equal(got_i, want_i))
    res = {"ms": a_b(torch, fns), "bitwise_equal_to_tree": equal,
           "by_kernel_us": CS.profile_forward(torch, fns["tree"],
                                              reps=20)[0]}
    CS.log(f"K3 {tag}: {res}")
    return {f"K3_{tag}": res}


def bind_diag(torch, libs: dict):
    """(K4f, K4b) of one version's diag_epilogue libraries: with or without
    the normalised centers' scratch (the forward's floor came with it)."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lf, lb = libs["diag_epilogue"], libs["diag_epilogue_bwd"]
    scratch = hasattr(lf, "nafae_diag_fwd_floor")
    lf.nafae_diag_fwd.argtypes = ([vp, vp, vp, i, vp] + [vp] * scratch
                                  + [vp] * 9 + [i] * 6 + [vp])
    lf.nafae_diag_fwd.restype = i
    lb.nafae_diag_bwd.argtypes = [vp, vp, i] + [vp] * 9 + [i] * 5 + [vp]
    lb.nafae_diag_bwd.restype = i

    def fwd(w, v, u, centers, fm, hc, rm):
        b, t, r, e = v.shape
        k, kc = w.shape[1], centers.shape[0]
        f32 = dict(dtype=torch.float32, device=v.device)
        outs = (torch.empty((b, k, t), **f32), torch.empty((b, k, t), **f32),
                torch.empty((b, t, k, e), **f32),
                torch.empty((b, k, t, r), **f32),
                torch.empty((b, k, t), dtype=torch.int32, device=v.device),
                torch.empty((b, k, t), dtype=torch.int32, device=v.device))
        chat = ([torch.empty((kc, e), dtype=v.dtype,
                             device=v.device).data_ptr()]
                if scratch else [])
        err = lf.nafae_diag_fwd(
            w.data_ptr(), v.data_ptr(), u.data_ptr(),
            int(v.dtype == torch.bfloat16), centers.data_ptr(), *chat,
            fm.data_ptr(), hc.data_ptr(), rm.data_ptr(),
            *(x.data_ptr() for x in outs), b, k, t, r, e, kc,
            torch.cuda.current_stream().cuda_stream)
        if err:
            CS.fail(f"diag_epilogue launch failed: {err}")
        return outs

    def bwd(w, v, centers, d, rstar, cstar, f, dctx, dclu):
        b, t, r, e = v.shape
        dw = torch.empty((b, w.shape[1], e), device=v.device)
        dv = torch.empty((b, t, r, e), device=v.device)
        err = lb.nafae_diag_bwd(
            w.data_ptr(), v.data_ptr(), int(v.dtype == torch.bfloat16),
            *(x.data_ptr() for x in (centers, d, rstar, cstar, f, dctx, dclu,
                                     dw, dv)),
            b, w.shape[1], t, r, e, torch.cuda.current_stream().cuda_stream)
        if err:
            CS.fail(f"diag_epilogue_bwd launch failed: {err}")
        return dw, dv

    return fwd, bwd


def diag_ab(torch, others: dict, ins, tag: str, own: bool = False) -> dict:
    """K4f and K4b of this tree against the other versions on the first
    training batch's fused-route inputs in one dtype: each version's K4f
    within DIAG_TOL of this tree's (ctx also allowing for bf16 terms that
    rounded the other way; r*, f and c* equal where clear of ties), each
    version's K4b on this tree's residuals within DIAG_TOL of this tree's
    K4b (own: on its own K4f's residuals, within DIAG_TOL of the plain
    version on them, since a bf16 ds may round the other way from another
    version's d); then the a_b times and this tree's time by kernel."""
    from nafae_torch.ops.grounding import l2_normalize
    from nafae_torch.ops.kernels import diag as K4

    w, v, u, centers, fm, rm, hc = ins
    rnd = K4._rounder(v.dtype)
    rtol, atol = CS.DIAG_TOL
    want = K4.launch_fwd(w, v, u, centers, fm, hc, rm)
    s = torch.where(rm[:, None] > 0,
                    torch.einsum("bke,btre->bktr", w.float(), v.float()),
                    K4.NEG)
    clear_r = CS.clear_of_ties(torch, s)
    both = clear_r & CS.clear_of_ties(torch, torch.einsum(
        "btke,ce->bktc", want[2], rnd(l2_normalize(centers))))
    gen = torch.Generator().manual_seed(CS.SEED + 5)
    dctx = torch.rand(want[0].shape, generator=gen).cuda()
    dclu = torch.rand(want[1].shape, generator=gen).cuda()
    res_args = (w, v, centers, want[3], want[4], want[5], want[2], dctx, dclu)
    want_b = K4.launch_bwd(*res_args)
    fns = {"tree": lambda: K4.launch_fwd(w, v, u, centers, fm, hc, rm)}
    bfns = {"tree": lambda: K4.launch_bwd(*res_args)}
    equal = {}
    for name, (_, _, _, ofwd, obwd, _) in others.items():
        fns[name] = lambda ofwd=ofwd: ofwd(w, v, u, centers, fm, hc, rm)
        got = fns[name]()
        args = ((w, v, centers, got[3], got[4], got[5], got[2], dctx, dclu)
                if own else res_args)
        bfns[name] = lambda obwd=obwd, args=args: obwd(*args)
        got_b = bfns[name]()
        ref_b = K4.diag_bwd_plain(*args) if own else want_b
        other_way = (rnd(got[3] ** 2) - rnd(want[3] ** 2)).abs().sum(-1)
        ok = (torch.allclose(got[3], want[3], rtol=rtol, atol=atol)
              and ((got[0] - want[0]).abs()
                   <= atol + rtol * want[0].abs() + other_way).all()
              and torch.allclose(got[1][both], want[1][both], rtol=rtol,
                                 atol=atol)
              and torch.equal(got[4][clear_r], want[4][clear_r])
              and torch.equal(got[2].permute(0, 2, 1, 3)[clear_r],
                              want[2].permute(0, 2, 1, 3)[clear_r])
              and torch.equal(got[5][both], want[5][both]))
        if not ok:
            CS.fail(f"K4f {tag}: {name} differs from this tree")
        if not all(torch.allclose(g, x, rtol=rtol, atol=atol)
                   for g, x in zip(got_b, ref_b)):
            CS.fail(f"K4b {tag}: {name} differs from "
                    + ("the plain version" if own else "this tree"))
        equal[name] = {"K4f": all(torch.equal(g, x)
                                  for g, x in zip(got, want)),
                       "K4b": all(torch.equal(g, x)
                                  for g, x in zip(got_b, want_b))}
    res = {}
    for kname, f in (("K4f", fns), ("K4b", bfns)):
        res[f"{kname}_{tag}"] = {
            "ms": a_b(torch, f), "bitwise_equal_to_tree": {
                n: e[kname] for n, e in equal.items()},
            "by_kernel_us": CS.profile_forward(torch, f["tree"],
                                               reps=20)[0]}
        CS.log(f"{kname} {tag}: {res[f'{kname}_{tag}']}")
    return res


def serving_batch(torch, srv, batch: dict):
    """(v_ext, fm_ext, rm_ext, w, temp) of the first config-4 serving batch
    in f32, as chip_smoke.timings builds it (oracle weights)."""
    from nafae_torch.ops import grounding as TG

    tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    w = srv.model.ctx_window
    with torch.inference_mode():
        v_emb = TG.project_params(srv.params, tb["feats"])
        v_ext, fm_ext, rm_ext = TG.extend_for_window(
            v_emb, tb["frame_mask"], tb["region_mask"], w)
    return v_ext.clone(), fm_ext.clone(), rm_ext.clone(), w, \
        srv.model.ctx_temp


def serving_host_ab(torch, others: dict, tree, srv, batch: dict,
                    rounds: int = 60) -> dict:
    """One f32 serving batch host to host (GroundingServer.run_batch: numpy
    batch in, numpy outputs out, as chip_smoke.timings times it) with K1f
    from each version, swapped in for this tree's launch_fwd; "tree" is
    this tree unchanged, "tree_bound" this tree's library through the same
    wrapper as the others; "copy" the batch's copy to the card alone. Each
    round calls every one once, in an order reversed every other round, so
    a drift of the host's speed falls on all alike; 5 rounds warm up.
    {name: [25th percentile, median, 75th percentile] ms over the rounds}."""
    import time

    from nafae_torch.ops.kernels import ctx_mix as K1

    real = K1.launch_fwd

    def with_fwd(of):
        def run():
            K1.launch_fwd = (lambda v, fm, w, temp, rm, residual=False:
                             of(v, fm, rm, w, temp, residual))
            try:
                srv.run_batch(batch)
            finally:
                K1.launch_fwd = real
        return run

    def copy():
        t = {k: torch.from_numpy(v).to("cuda", non_blocking=True)
             for k, v in batch.items()}
        torch.cuda.synchronize()
        return t

    fns = {"copy": copy, **{n: with_fwd(f[2]) for n, f in others.items()},
           "tree_bound": with_fwd(tree[2]),
           "tree": lambda: srv.run_batch(batch)}
    ms = {n: [] for n in fns}
    for i in range(rounds + 5):
        for n in (list(fns) if i % 2 else list(fns)[::-1]):
            t0 = time.perf_counter()
            fns[n]()
            if i >= 5:
                ms[n].append((time.perf_counter() - t0) * 1e3)
    return {n: np.percentile(v, [25, 50, 75]).tolist() for n, v in ms.items()}


def compare_fwd(torch, others, v, fm, rm, w, temp, residual, case) -> dict:
    """K1f (or K1fr) of this tree against the other versions on one input:
    u within CTX_TOL (f32: also whether bitwise equal) and alpha within
    ALPHA_TOL, then the a_b times and this tree's time by kernel."""
    from nafae_torch.ops.kernels import ctx_mix as K1

    dt = "bfloat16" if v.dtype == torch.bfloat16 else "float32"
    fns = {"tree": lambda: K1.launch_fwd(v, fm, w, temp, rm,
                                         residual=residual)}
    want_u, want_a = fns["tree"]()
    equal = {}
    for name, (_, _, of, *_) in others.items():
        fns[name] = lambda of=of: of(v, fm, rm, w, temp, residual)
        got_u, got_a = fns[name]()
        if not torch.allclose(got_u, want_u, rtol=CS.CTX_TOL[dt][0],
                              atol=CS.CTX_TOL[dt][1]):
            CS.fail(f"{case}: {name}'s u differs from this tree's")
        if residual and not torch.allclose(
                got_a.float(), want_a.float(), rtol=CS.ALPHA_TOL[dt][0],
                atol=CS.ALPHA_TOL[dt][1]):
            CS.fail(f"{case}: {name}'s alpha differs from this tree's")
        equal[name] = bool(torch.equal(got_u, want_u) and (
            not residual or torch.equal(got_a, want_a)))
    entry = {"ms": a_b(torch, fns), "bitwise_equal_to_tree": equal,
             "by_kernel_us": CS.profile_forward(torch, fns["tree"],
                                                reps=20)[0]}
    CS.log(f"{case}: {entry}")
    return entry


def bwd_ab(torch, others: dict, v32, fm, rm, w, temp, du,
           suffix: str = "") -> dict:
    """K1br (on this tree's K1fr alpha) and K1b of this tree against the
    other versions on one input, v in f32 and in bf16: dv within GRAD_TOL,
    whether bit for bit this tree's, the a_b times and this tree's time by
    kernel; keys "{K1br,K1b}_{f32,bf16}" + suffix."""
    from nafae_torch.ops.kernels import ctx_mix as K1

    res = {}
    for tag, v in (("f32", v32), ("bf16", v32.to(torch.bfloat16))):
        _, alpha = K1.launch_fwd(v, fm, w, temp, rm, residual=True)
        tol = CS.GRAD_TOL["float32" if tag == "f32" else "bfloat16"]
        for kname, a in (("K1br", alpha), ("K1b", None)):
            fns = {"tree": lambda a=a, v=v: K1.launch_bwd(v, fm, w, temp, rm,
                                                           du, a)}
            want = fns["tree"]()
            equal = {}
            for name, (_, ob, *_) in others.items():
                fns[name] = (lambda ob=ob, a=a, v=v:
                             ob(v, fm, rm, du, w, temp, a))
                got = fns[name]()
                if not torch.allclose(got, want, rtol=tol[0], atol=tol[1]):
                    CS.fail(f"{kname} {tag}{suffix}: {name} differs from "
                            "this tree")
                equal[name] = bool(torch.equal(got, want))
            entry = {"ms": a_b(torch, fns), "bitwise_equal_to_tree": equal,
                     "by_kernel_us": CS.profile_forward(torch, fns["tree"],
                                                        reps=20)[0]}
            res[f"{kname}_{tag}{suffix}"] = entry
            CS.log(f"{kname} {tag}{suffix}: {entry}")
    return res


def any_ab(torch, others: dict, tmp: str) -> dict:
    """The general variants at phase 17's shapes: K1f, K1fr, K1br and K1b
    on ctx_inputs' random masks at chip_smoke.ANY_TIMED (B=16, T=20: R=36,
    E=1024, w=3 and R=20, E=50, w=20; du from a seed); K3 (at ANY_TIMED's
    shapes), K4f and K4b (at every fit of chip_smoke.ANY_FITS, K = 40 too)
    on the fused route's inputs of those fits (chip_smoke.fused_inputs on
    an R = 36 and a 40-word split written under tmp, and on tmp's config-4
    split at E = 50), K4b on each version's own K4f residuals; each in f32
    and bf16, as the config-4 comparisons; keys end in the shape's name.
    The other versions must take those shapes."""
    gen = torch.Generator().manual_seed(CS.SEED + 18)
    res = {}
    for name, (b, t, r, e, w) in CS.ANY_TIMED.items():
        v32, fm, rm = CS.ctx_inputs(torch, gen, b, t, r, e, w,
                                    torch.device("cuda"))
        du = torch.randn(b, t, r, e, generator=gen).cuda()
        for tag, v in (("f32", v32), ("bf16", v32.to(torch.bfloat16))):
            for kname, residual in (("K1f", False), ("K1fr", True)):
                res[f"{kname}_{tag}_{name}"] = compare_fwd(
                    torch, others, v, fm, rm, w, 0.1, residual,
                    f"{kname} {tag} at {name}")
        res.update(bwd_ab(torch, others, v32, fm, rm, w, 0.1, du,
                          "_" + name))
        torch.cuda.empty_cache()
    roots = {"c4": tmp, "r36": os.path.join(tmp, "r36"),
             "k40": os.path.join(tmp, "k40")}
    CS.make_train_data(roots["r36"], regions=36)
    CS.make_train_data(roots["k40"], words=40)
    for name, (extra, data, *_) in CS.ANY_FITS.items():
        ins = CS.fused_inputs(torch, roots[data], tmp, extra)
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            w_emb, v_emb, u = (x.to(dt) for x in ins[:3])
            if name in CS.ANY_TIMED:
                res.update(cross_ab(torch, others, (
                    w_emb.reshape(-1, w_emb.shape[-1]).contiguous(), v_emb,
                    ins[4], ins[5]), f"{tag}_{name}"))
            res.update(diag_ab(torch, others, (w_emb, v_emb, u, *ins[3:]),
                               f"{tag}_{name}", own=True))
        torch.cuda.empty_cache()
    return res


def f16_ab(torch, tree, v32, fm, rm, w, temp, du, tag: str) -> dict:
    """This tree's K1f, K1fr, K1br (on its own K1fr alpha) and K1b through
    one path (`bind`'s wrapper of this tree's libraries) on one input in
    bf16 and in f16, timed in turns (bf16, f16, f16, bf16: a_b); keys
    "{kernel}_f16_vs_bf16_" + tag, each {"bf16": [ms, ms], "f16": [ms,
    ms]}. The two instantiations are one template: the same bytes, the
    same tensor-core rate."""
    _, tb, tf, *_ = tree
    vs = {"bf16": v32.to(torch.bfloat16), "f16": v32.half()}
    alphas = {k: tf(v, fm, rm, w, temp, True)[1] for k, v in vs.items()}
    res = {}
    for kname, make in (
            ("K1f", lambda k: lambda: tf(vs[k], fm, rm, w, temp)),
            ("K1fr", lambda k: lambda: tf(vs[k], fm, rm, w, temp, True)),
            ("K1br", lambda k: lambda: tb(vs[k], fm, rm, du, w, temp,
                                          alphas[k])),
            ("K1b", lambda k: lambda: tb(vs[k], fm, rm, du, w, temp))):
        ms = a_b(torch, {"tree": make("f16"), "bf16": make("bf16")})
        key = f"{kname}_f16_vs_bf16_{tag}"
        res[key] = {"bf16": ms["bf16"], "f16": ms["tree"]}
        CS.log(f"{kname} f16 vs bf16, {tag}: {res[key]}")
    return res


def a_b(torch, fns: dict) -> dict:
    """Device ms of each fn, others then this tree twice then others
    reversed: {name: [ms, ms]}."""
    names = [n for n in fns if n != "tree"]
    order = names + ["tree", "tree"] + names[::-1]
    ms = {n: [] for n in fns}
    for n in order:
        ms[n].append(CS.device_ms(torch, fns[n]))
    return ms


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        CS.fail("kernel_ab.py needs a CUDA card")
    from nafae_torch.config import load_config
    from nafae_torch.ops import grounding as TG
    from nafae_torch.ops.kernels import _build, nms as K2
    from nafae_torch.serve import GroundingServer
    from nafae_torch.train import TrainState, batch_to_device

    dirs = [Path(d) for d in sys.argv[1:]]
    CS.log(f"card: {CS.card_line()}")
    _build.build_all(CS.SOURCES)
    libs, usage = build(dirs)
    others = {name: bind(torch, lib) for name, lib in libs.items()}
    usage["tree"] = ptxas_usage(_build.build_log("ctx_mix_bwd"))
    res = {"card": CS.card_line(), "ctx_mix_bwd_ptxas": usage}
    CS.log(f"ctx_mix_bwd ptxas: {usage}")
    with tempfile.TemporaryDirectory() as tmp:
        segs, _ = CS.make_requests(tmp)
        srv = GroundingServer(load_config(preset_name="config4"),
                              CS.oracle_params(), device="cuda")
        samples = [srv._pad_segment(s) for s in segs[:srv.batch_size]]
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        fwd_inputs = [("K1f", "serving", *serving_batch(torch, srv, batch),
                       False)]
        CS.make_train_data(tmp)
        cfg = CS.train_cfg(tmp, os.path.join(tmp, "ck"), "float32", 1000)
        tb = batch_to_device(CS.first_batch(tmp), torch.device("cuda"))
        state = TrainState.create(cfg, device=torch.device("cuda"))
        w, temp = cfg.loss.ctx_window, cfg.loss.ctx_temp
        with torch.no_grad():
            v_emb = TG.project_regions(tb["feats"], state.params["w_v"],
                                       state.params["b_v"])
            v32, fm, rm = TG.extend_for_window(v_emb, tb["frame_mask"],
                                               tb["region_mask"], w)
        b, te, r, e = v32.shape
        du = torch.randn(b, te - 2 * w, r, e,
                         generator=torch.Generator().manual_seed(7)).cuda()
        fwd_inputs.append(("K1fr", "training", v32, fm, rm, w, temp, True))
        for kname, which, v32_, fm_, rm_, w_, temp_, residual in fwd_inputs:
            for tag, v in (("f32", v32_), ("bf16", v32_.to(torch.bfloat16))):
                res[f"{kname}_{tag}"] = compare_fwd(
                    torch, others, v, fm_, rm_, w_, temp_, residual,
                    f"{kname} {tag}, the first {which} batch")
        ins = CS.fused_inputs(torch, tmp, tmp)
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            w_emb, v_emb, u = (x.to(dt) for x in ins[:3])
            res.update(cross_ab(torch, others, (
                w_emb.reshape(-1, w_emb.shape[-1]).contiguous(), v_emb,
                ins[4], ins[5]), tag))
            res.update(diag_ab(torch, others,
                               (w_emb, v_emb, u, *ins[3:]), tag))
        tree = bind(torch, {n: _build.load(n) for n in SOURCES})
        res["serving_batch_host_ms"] = serving_host_ab(torch, others, tree,
                                                       srv, batch)
        CS.log(f"serving batch host to host: {res['serving_batch_host_ms']}")
        res.update(bwd_ab(torch, others, v32, fm, rm, w, temp, du))
        res.update(f16_ab(torch, tree, v32, fm, rm, w, temp, du, "config4"))
        b36, t36, r36, e36, w36 = CS.ANY_TIMED["R36_E1024_w3"]
        v36, fm36, rm36 = CS.ctx_inputs(
            torch, torch.Generator().manual_seed(CS.SEED + 18), b36, t36,
            r36, e36, w36, torch.device("cuda"))
        du36 = torch.randn(b36, t36, r36, e36).cuda()
        res.update(f16_ab(torch, tree, v36, fm36, rm36, w36, 0.1, du36,
                          "R36_E1024_w3"))
        del v36, fm36, rm36, du36
        res.update(any_ab(torch, others, tmp))
        ann = CS.write_c5_videos(tmp, CS.C5_SEGMENTS, 640, CS.SEED)
        cfg5 = CS.c5_cfg(ann, os.path.join(tmp, "ck5"), "float32", 1)
        frames = torch.from_numpy(CS.c5_first_batch(cfg5)["frames"]).cuda()
        frames = frames.reshape((-1,) + frames.shape[2:])
        for run in ("float32", "bfloat16"):
            det = CS.c5_detector(torch, CS.c5_cfg(
                ann, os.path.join(tmp, "ck5"), run, 1))
            planes, sc, _, _ = CS.detector_inputs(torch, det, frames)
            del det
            tiers = torch.zeros(sc.shape[0], dtype=torch.int32,
                                device=sc.device)
            wi, wv = K2.launch(*planes, sc, 20, 0.7, tiers=tiers)
            fns = {"tree": lambda pl=planes, sc=sc: K2.launch(*pl, sc, 20,
                                                              0.7)}
            for name, (on, *_) in others.items():
                fns[name] = lambda on=on, pl=planes, sc=sc: on(*pl, sc)
                gi, gv = fns[name]()
                if not (torch.equal(gi, wi) and torch.equal(gv, wv)):
                    CS.fail(f"K2 {run}: {name}'s survivors differ")
            at_top = (sc == sc.max(1, keepdim=True).values).sum(1).float()
            res[f"K2_{run}"] = {
                "ms": a_b(torch, fns),
                "bound": CS.nms_bound_ms(torch, sc, wi, wv),
                "rows_by_tiers": torch.bincount(tiers.long()).tolist(),
                "boxes_at_the_top_score": [float(at_top.min()),
                                           float(at_top.median()),
                                           float(at_top.max())],
                "rows_tied_past_a_tier": int((at_top > K2.TIER_BOXES).sum())}
            CS.log(f"K2 {run}: {res[f'K2_{run}']}")
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "kernel_ab.json").write_text(
        json.dumps(res, indent=1))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
