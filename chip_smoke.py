#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nafae_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (the kernels are built from `nafae_torch/csrc`
at first use) and nothing else: weights, requests and training data are
made from seeds. Phases, each of which fails loudly (exit code != 0):

1. card: prints the card's name and power limit and torch's CUDA version;
2. build: compiles every kernel source (one nvcc each, all at once) and
   prints the build time and each kernel's registers and spills;
3. kernels against their plain PyTorch versions on the card, at the main
   paths' shapes and at edge shapes, in f32 and bf16: K1f (u), K1fr (u and
   alpha), K1b and K1br (dv_ext against autograd through the plain
   version), CtxMix end to end; the fused cross-MIL K3 (a, and idx where
   the top two scores are clear of ties; R = 40, an all-masked frame,
   exact ties resolved to the first region), the diag epilogue K4f (ctx,
   clu, f, its residuals, r* and c*) and K4b (dw, dv on K4f's residuals),
   with K = 7, R = 40 and Kc = 67 among the cases;
4. serving (main path 1): a config4 GroundingServer at full width, with
   planted-signal oracle weights, answers synthetic requests in process
   and over HTTP, in f32 and bf16; the launch counts show that the path
   went through K1f, box accuracy must clear the planted-signal bar, and
   one batch re-run on the CPU must agree;
5. training (main path 2): `nafae_torch.train.fit` on config4 at full
   width over planted-signal features, 20 steps in f32 and 10 in bf16,
   must lower the loss and launch K1fr and K1br once per step; with
   ALPHA_RESIDUAL off, K1f and K1b once per step; the first steps'
   metrics and one step's gradients must agree with a CPU re-run;
6. training with `train.kernels=pallas` (main path 3): the same runs must
   lower the loss and launch, each step, K3 twice, K4f, K4b, K1fr and
   K1br once; the first steps and one step's gradients must agree with a
   CPU re-run, and the first step's loss and gradients with the auto
   route on the same batch;
7. times from CUDA events (median of repeated runs after warm-up): each
   kernel, its plain version (and, for K3, the two PyTorch calls of the
   auto route), one full serving batch and one training step of each
   route, with torch.profiler breakdowns.

The line before the last is the card as `nvidia-smi` names it; the one
before that is a JSON object with each kernel's numbers; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # f32 on CUDA cores, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # bf16 on tensor cores, dense, same sheet
SEED = 7
NUM_SEGMENTS = 40               # 2.5 batches of 16: a ragged last batch
ACC_BAR = 0.8                   # planted-signal box accuracy bar
TRAIN_SEGMENTS = 64             # 4 batches of 16 a training epoch
TRAIN_STEPS = {"float32": 20, "bfloat16": 10}
CPU_STEPS = 3                   # steps re-run on the CPU
# card against CPU, f32: metrics of the first steps (through two Adam
# updates, whose m/sqrt(v) can turn a last-digit difference of a tiny
# gradient into a full-size step) and one step's gradients (relative to
# each parameter's largest entry)
CPU_METRIC_TOL = (1e-3, 1e-6)
CPU_GRAD_TOL = (1e-4, 1e-6)
# the overrides of the training runs: warm up over 2 steps to lr 3e-3 and
# refresh the k-means centers every 10 steps, so that a 20-step run moves
TRAIN_OVERRIDES = ["train.lr=0.003", "train.warmup_steps=2",
                   "loss.kmeans_interval=10", "train.log_every=1",
                   "train.ckpt_every=1000000", "train.eval_every=1000000"]
SOURCES = ("ctx_mix", "ctx_mix_bwd", "cross_mil", "diag_epilogue",
           "diag_epilogue_bwd")         # nafae_torch/csrc/<name>.cu
ROUTES = ("auto", "pallas")             # train.kernels of the training runs
# kernel against plain, rtol and atol: the plain version rounds like the
# kernel (bf16 operands, alpha rounded to bf16, f32 sums), so bf16 differs
# only by the order of the sums and an occasional alpha rounded the other way
CTX_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-3, 1e-4)}
# alpha of K1fr: f32 sums in another order; in bf16 a value may round to
# the neighbouring bf16 number (one ulp is at most 2^-7 relative)
ALPHA_TOL = {"float32": (1e-4, 1e-6), "bfloat16": (1e-2, 1e-6)}
# dv_ext of K1b/K1br against autograd through the plain version: f32 sums
# in another order; in bf16 the kernels round du_n, alpha and ds to bf16 as
# the TPU kernels do, the plain autograd rounds at its casts instead, so
# bf16 takes the reference tests' 2e-2
GRAD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}
# K3 against plain: both sum the same f32 products (bf16 operands in bf16
# mode), in other orders
CROSS_TOL = (1e-5, 1e-5)
# K4f's ctx, clu and residual, K4b's dw and dv against plain: the kernels
# round the same f32 values at the same points, so only the order of the
# f32 sums differs, in both dtypes (for ctx in bf16, see compare_diag)
DIAG_TOL = (1e-4, 1e-5)
# argmaxes (K3's idx, K4f's r* and c*) are held equal wherever the top two
# scores differ by more than this; closer pairs may go either way
TIE_GAP = 1e-4
# the pallas route against the auto route on one batch, f32: the loss (rtol)
# and each gradient leaf (atol, as a fraction of the leaf's largest entry)
PALLAS_AUTO_TOL = (1e-5, 1e-4)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- kernels


def ctx_inputs(torch, gen, b, t, r, e, w, device):
    """l2-normalized regions with random frame and region masks, incl. a
    valid frame whose regions are all invalid (the uniform-alpha group)."""
    F = torch.nn.functional
    v = torch.randn(b, t, r, e, generator=gen)
    v = v / v.norm(dim=-1, keepdim=True)
    fm = (torch.rand(b, t, generator=gen) > 0.25).float()
    rm = (torch.rand(b, t, r, generator=gen) > 0.3).float()
    fm[:, 0] = 1.0
    fm[0, min(1, t - 1)] = 1.0
    rm[0, min(1, t - 1)] = 0.0
    return (F.pad(v, (0, 0, 0, 0, w, w)).to(device),
            F.pad(fm, (w, w)).to(device),
            F.pad(rm, (0, 0, w, w)).to(device))


def check_ctx_mix(torch, device) -> dict[str, float]:
    """K1f against its plain version on the card; returns the max |u| error
    per dtype."""
    from nafae_torch.ops.kernels import ctx_mix as K

    gen = torch.Generator().manual_seed(SEED)
    cases = [(16, 20, 20, 256, 3, True),    # config4 serving shapes
             (16, 20, 20, 256, 3, False),   # ... without a region mask
             (16, 7, 20, 256, 3, True),     # ragged T
             (16, 2, 20, 256, 3, True),     # w >= T
             (3, 5, 32, 512, 2, True)]      # the kernel's widest R and E
    errs = {}
    for dt_name, dt in (("float32", None), ("bfloat16", torch.bfloat16)):
        rtol, atol = CTX_TOL[dt_name]
        worst = 0.0
        for b, t, r, e, w, with_rm in cases:
            v_ext, fm_ext, rm_ext = ctx_inputs(torch, gen, b, t, r, e, w,
                                               device)
            rm_ext = rm_ext if with_rm else None
            u, nv = K.ctx_mix(v_ext, fm_ext, w, 0.1, dtype=dt, rm_ext=rm_ext)
            torch.cuda.synchronize()
            up, nvp = K.context_mix_plain(v_ext, fm_ext, w, 0.1, dtype=dt,
                                          rm_ext=rm_ext)
            case = f"{dt_name} B={b} T={t} R={r} E={e} w={w} rm={with_rm}"
            if not torch.equal(nv, nvp):
                fail(f"ctx_mix nbr_valid differs from the plain version: {case}")
            if not torch.isfinite(u).all():
                fail(f"ctx_mix gave non-finite values: {case}")
            err = (u - up).abs().max().item()
            if not torch.allclose(u, up, rtol=rtol, atol=atol):
                fail(f"ctx_mix differs from the plain version by {err}: {case}")
            worst = max(worst, err)
        errs[dt_name] = worst
        log(f"ctx_mix vs plain, {dt_name}: max |err| {worst:.3e} "
            f"(rtol {rtol}, atol {atol}, {len(cases)} cases)")
    return errs


def compare_grad_kernels(torch, vc, fm_ext, rm_ext, w, du, dt_name,
                         case) -> dict[str, float]:
    """K1fr (u, alpha), K1b and K1br (dv_ext) on vc (in the compute dtype)
    against the plain version on the same card; fails beyond the limits,
    returns the max |error| of each."""
    from nafae_torch.ops.kernels import ctx_mix as K

    dt = torch.bfloat16 if vc.dtype == torch.bfloat16 else None
    u, alpha = K.launch_fwd(vc, fm_ext, w, 0.1, rm_ext, residual=True)
    dv_rec = K.launch_bwd(vc, fm_ext, w, 0.1, rm_ext, du)
    dv_res = K.launch_bwd(vc, fm_ext, w, 0.1, rm_ext, du, alpha)
    torch.cuda.synchronize()
    # the plain version in f32 from the same (rounded) values, with the
    # compute dtype's rounding of the operands
    vp = vc.float().requires_grad_()
    up, _ = K.context_mix_plain(vp, fm_ext, w, 0.1, dtype=dt, rm_ext=rm_ext)
    (dvp,) = torch.autograd.grad(up, vp, du)
    ap = K.context_alpha_plain(vc, fm_ext, w, 0.1, rm_ext=rm_ext)
    errs = {}
    for name, got, want in (("ctx_mix_fwd_res", u, up.detach()),
                            ("alpha", alpha, ap),
                            ("ctx_mix_bwd", dv_rec, dvp),
                            ("ctx_mix_bwd_res", dv_res, dvp)):
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            fail(f"{name} gave non-finite values: {case}")
        rtol, atol = (CTX_TOL if name == "ctx_mix_fwd_res" else
                      ALPHA_TOL if name == "alpha" else GRAD_TOL)[dt_name]
        errs[name] = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            fail(f"{name} differs from the plain version by {errs[name]} "
                 f"(rtol {rtol}, atol {atol}): {case}")
    return errs


def check_ctx_grad(torch, device) -> dict[str, float]:
    """K1fr, K1b and K1br against the plain version on the card, at K1f's
    shapes (config4's first; train_timings adds the real first training
    batch): u and alpha of K1fr against the plain forward and softmax,
    dv_ext of both backward routes against autograd through
    context_mix_plain; then CtxMix end to end (u carries a grad_fn, one
    launch of each kernel of its route). Returns the max errors by kernel
    and dtype."""
    from nafae_torch.ops.kernels import ctx_mix as K

    gen = torch.Generator().manual_seed(SEED + 1)
    cases = [(16, 20, 20, 256, 3, True),    # config4 shapes
             (16, 20, 20, 256, 3, False),   # ... without a region mask
             (16, 7, 20, 256, 3, True),     # ragged T
             (16, 2, 20, 256, 3, True),     # w >= T
             (3, 5, 32, 512, 2, True)]      # the kernels' widest R and E
    errs = {}
    for dt_name, dt in (("float32", None), ("bfloat16", torch.bfloat16)):
        worst = dict.fromkeys(("ctx_mix_fwd_res", "alpha", "ctx_mix_bwd",
                               "ctx_mix_bwd_res"), 0.0)
        for b, t, r, e, w, with_rm in cases:
            v_ext, fm_ext, rm_ext = ctx_inputs(torch, gen, b, t, r, e, w,
                                               device)
            du = torch.randn(b, t, r, e, generator=gen).to(device)
            got = compare_grad_kernels(
                torch, v_ext.to(dt) if dt is not None else v_ext, fm_ext,
                rm_ext if with_rm else None, w, du, dt_name,
                f"{dt_name} B={b} T={t} R={r} E={e} w={w} rm={with_rm}")
            worst = {k: max(worst[k], got[k]) for k in worst}
        errs[dt_name] = worst
        log(f"K1fr/K1b/K1br vs plain, {dt_name}: max |err| "
            + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
            + f" (u {CTX_TOL[dt_name]}, alpha {ALPHA_TOL[dt_name]}, dv "
            f"{GRAD_TOL[dt_name]} as rtol, atol; {len(cases)} cases)")

    # CtxMix end to end: the gradient route of each ALPHA_RESIDUAL setting
    v_ext, fm_ext, rm_ext = ctx_inputs(torch, gen, 2, 6, 20, 256, 3, device)
    for residual in (True, False):
        K.ALPHA_RESIDUAL = residual
        before = dict(K.launches)
        v = v_ext.clone().requires_grad_()
        u, _ = K.ctx_mix(v, fm_ext, 3, 0.1, rm_ext=rm_ext)
        if u.grad_fn is None:
            fail("ctx_mix on the card returned a u without a grad_fn")
        u.sum().backward()
        torch.cuda.synchronize()
        want = ({"ctx_mix_fwd_res", "ctx_mix_bwd_res"} if residual
                else {"ctx_mix_fwd", "ctx_mix_bwd"})
        got = {k for k in K.launches if K.launches[k] != before[k]}
        if got != want or any(K.launches[k] - before[k] != 1 for k in want):
            fail(f"CtxMix (ALPHA_RESIDUAL={residual}) launched "
                 f"{ {k: K.launches[k] - before[k] for k in K.launches} }")
    K.ALPHA_RESIDUAL = True
    log("CtxMix: u carries a grad_fn; backward launched K1fr+K1br "
        "(residual) and K1f+K1b (recompute), once each")
    return errs


def unit_rows(torch, gen, *shape):
    x = torch.randn(*shape, generator=gen)
    return x / x.norm(dim=-1, keepdim=True)


def frame_region_masks(torch, gen, b, t, r):
    """Random frame and region masks with a valid frame whose regions are
    all masked (video 0, frame 0)."""
    fm = (torch.rand(b, t, generator=gen) > 0.2).float()
    rm = (torch.rand(b, t, r, generator=gen) > 0.3).float()
    fm[0, 0] = 1.0
    rm[0, 0] = 0.0
    return fm, rm


def clear_of_ties(torch, scores, gap=TIE_GAP):
    """Where the top two scores of the last axis differ by more than gap."""
    if scores.shape[-1] == 1:
        return torch.ones(scores.shape[:-1], dtype=torch.bool,
                          device=scores.device)
    top = scores.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1] > gap


def check_cross_mil(torch, device) -> dict[str, float]:
    """K3 against its plain version on the card: config4's training shapes
    (I=16 videos, M=B·K=128 words, T=20, R=20, E=256), R=40 (K3a's
    domain), no region mask, and a ragged case (M=40, T=7, R=33) with exact
    ties; each with a valid frame whose regions are all masked. Returns the
    max |a| error per dtype."""
    from nafae_torch.ops.kernels import cross_mil as K3

    gen = torch.Generator().manual_seed(SEED + 2)
    cases = [(16, 128, 20, 20, 256, True, False),
             (16, 128, 20, 40, 256, True, False),
             (16, 128, 20, 20, 256, False, False),
             (3, 40, 7, 33, 64, True, True)]
    rtol, atol = CROSS_TOL
    errs = {}
    for dt_name, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        worst = 0.0
        for i, m, t, r, e, with_rm, tied in cases:
            w = unit_rows(torch, gen, m, e)
            v = unit_rows(torch, gen, i, t, r, e)
            fm, rm = frame_region_masks(torch, gen, i, t, r)
            if tied:       # duplicate rows: exact ties, first region wins
                v[:, :, 16] = v[:, :, 8]
                v[:, :, r - 1] = v[:, :, 0]
                rm[:, :, 16] = rm[:, :, 8]
                rm[:, :, r - 1] = rm[:, :, 0]
            w, v = w.to(dt).to(device), v.to(dt).to(device)
            fm, rm = fm.to(device), rm.to(device) if with_rm else None
            case = (f"{dt_name} I={i} M={m} T={t} R={r} E={e} rm={with_rm} "
                    f"ties={tied}")
            a, idx = K3.launch(w, v, fm, rm)
            torch.cuda.synchronize()
            ap, idxp = K3.cross_mil_plain(w, v, fm, rm)
            if not torch.isfinite(a).all():
                fail(f"cross_mil gave non-finite values: {case}")
            err = (a - ap).abs().max().item()
            if not torch.allclose(a, ap, rtol=rtol, atol=atol):
                fail(f"cross_mil differs from the plain version by {err}: "
                     f"{case}")
            s = torch.einsum("me,itre->imtr", w.float(), v.float())
            if rm is not None:
                s = torch.where(rm[:, None] > 0, s, K3.NEG)
            clear = clear_of_ties(torch, s)
            if not torch.equal(idx[clear], idxp[clear]):
                fail(f"cross_mil idx differs from the plain version where "
                     f"the top two scores are clear of ties: {case}")
            if tied and ((idx == 16) | (idx == r - 1)).any():
                fail(f"cross_mil resolved an exact tie to the later region: "
                     f"{case}")
            if with_rm and not ((a[0, :, 0] == K3.NEG).all()
                                and (idx[0, :, 0] == 0).all()):
                fail(f"cross_mil: an all-masked valid frame must give -1e9 "
                     f"and idx 0: {case}")
            worst = max(worst, err)
        errs[dt_name] = worst
        log(f"cross_mil vs plain, {dt_name}: max |a err| {worst:.3e} (rtol "
            f"{rtol}, atol {atol}; idx equal where the top two differ by > "
            f"{TIE_GAP}; {len(cases)} cases)")
    return errs


def compare_diag(torch, w, v, u, centers, fm, hc, rm, case, tied=False
                 ) -> dict[str, float]:
    """K4f and K4b against their plain versions on one input (K4b on K4f's
    residuals, with random cotangents); returns the max |error| of each."""
    from nafae_torch.ops.grounding import l2_normalize
    from nafae_torch.ops.kernels import diag as K4

    dt_name = "bfloat16" if v.dtype == torch.bfloat16 else "float32"
    got = K4.launch_fwd(w, v, u, centers, fm, hc, rm)
    torch.cuda.synchronize()
    want = K4.diag_fwd_plain(w, v, u, centers, fm, hc, rm)
    ctx, clu, f, d, rstar, cstar = got
    for name, x in (("ctx", ctx), ("clu", clu), ("f", f), ("d", d)):
        if not torch.isfinite(x).all():
            fail(f"diag_epilogue gave non-finite {name}: {case}")
    s = torch.einsum("bke,btre->bktr", w.float(), v.float())
    if rm is not None:
        s = torch.where(rm[:, None] > 0, s, K4.NEG)
    clear_r = clear_of_ties(torch, s)
    rnd = (lambda x: x.to(torch.bfloat16).float()) \
        if v.dtype == torch.bfloat16 else (lambda x: x)
    sims = torch.einsum("btke,ce->bktc", want[2],
                        rnd(l2_normalize(centers)))
    both = clear_r & clear_of_ties(torch, sims)
    if not torch.equal(rstar[clear_r], want[4][clear_r]) \
            or not torch.equal(f.permute(0, 2, 1, 3)[clear_r],
                               want[2].permute(0, 2, 1, 3)[clear_r]):
        fail(f"diag_epilogue r* or f differ from the plain version where "
             f"the top two scores are clear of ties: {case}")
    if not torch.equal(cstar[both], want[5][both]):
        fail(f"diag_epilogue c* differs from the plain version where the "
             f"top two sims are clear of ties: {case}")
    if tied and ((rstar == 16).any() or (cstar == 5).any()):
        fail(f"diag_epilogue resolved an exact tie to the later index: {case}")
    rtol, atol = DIAG_TOL
    errs = {}
    for name, g, wnt in (("clu", clu[both], want[1][both]),
                         ("d", d, want[3])):
        errs[name] = (g - wnt).abs().max().item() if g.numel() else 0.0
        if not torch.allclose(g, wnt, rtol=rtol, atol=atol):
            fail(f"diag_epilogue {name} differs from the plain version by "
                 f"{errs[name]} (rtol {rtol}, atol {atol}): {case}")
    # ctx against the plain version: in bf16 a term (s - ŝ)² whose f32 value
    # lies on a bf16 rounding midpoint may round the other way from the plain
    # version's, so each (b, k, t) may also differ by what its terms rounded
    # the other way account for (nothing in f32, where no term is rounded)
    terms, want_terms = rnd(d * d), rnd(want[3] * want[3])
    other_way = ((terms - want_terms).abs().sum(-1)
                 if v.dtype == torch.bfloat16 else torch.zeros_like(ctx))
    errs["ctx"] = (ctx - want[0]).abs().max().item()
    errs["ctx_terms_rounded_other_way"] = float(
        (terms != want_terms).sum().item()) if v.dtype == torch.bfloat16 \
        else 0.0
    if not ((ctx - want[0]).abs()
            <= atol + rtol * want[0].abs() + other_way).all():
        fail(f"diag_epilogue ctx differs from the plain version by "
             f"{errs['ctx']} (rtol {rtol}, atol {atol}, plus the terms that "
             f"rounded the other way): {case}")
    # ctx against the kernel's own residuals d, each term rounded as the
    # plain version rounds it: only the order of the f32 sum differs. The
    # same sum left unrounded, what a kernel that skips the bf16 rounding of
    # the terms would give, must differ by more than the limit.
    own = terms.sum(-1)
    errs["ctx_vs_own_terms"] = (ctx - own).abs().max().item()
    if not torch.allclose(ctx, own, rtol=rtol, atol=atol):
        fail(f"diag_epilogue ctx is not the sum of its own terms rounded "
             f"as the plain version rounds them, off by "
             f"{errs['ctx_vs_own_terms']} (rtol {rtol}, atol {atol}): {case}")
    if v.dtype == torch.bfloat16:
        unrounded = (d * d).sum(-1)
        errs["ctx_unrounded_vs_own_terms"] = (
            unrounded - own).abs().max().item()
        if torch.allclose(unrounded, own, rtol=rtol, atol=atol):
            fail(f"the ctx check cannot tell a kernel that skips the bf16 "
                 f"rounding of the terms: the unrounded sum is within rtol "
                 f"{rtol}, atol {atol}: {case}")
    gen = torch.Generator().manual_seed(SEED + 4)
    dctx = torch.rand(ctx.shape, generator=gen).to(v.device)
    dclu = torch.rand(clu.shape, generator=gen).to(v.device)
    dw, dv = K4.launch_bwd(w, v, centers, d, rstar, cstar, f, dctx, dclu)
    torch.cuda.synchronize()
    pdw, pdv = K4.diag_bwd_plain(w, v, centers, d, rstar, cstar, f, dctx,
                                 dclu)
    for name, g, wnt in (("dw", dw, pdw), ("dv", dv, pdv)):
        errs[name] = (g - wnt).abs().max().item()
        if not torch.isfinite(g).all() or not torch.allclose(
                g, wnt, rtol=rtol, atol=atol):
            fail(f"diag_epilogue_bwd {name} differs from the plain version "
                 f"by {errs[name]} (rtol {rtol}, atol {atol}): {case}")
    return errs


def check_diag(torch, device) -> dict[str, dict[str, float]]:
    """K4f and K4b against their plain versions on the card: config4's
    shapes (B=16, K=8, T=20, R=20, E=256, Kc=67), K=7 with R=40 and exact
    ties (duplicate regions and centers), and no region mask; each with a
    valid frame whose regions are all masked and frames without context.
    Returns the max errors by output and dtype."""
    gen = torch.Generator().manual_seed(SEED + 3)
    cases = [(16, 8, 20, 20, 256, 67, True, False),
             (4, 7, 9, 40, 256, 67, True, True),
             (4, 8, 20, 20, 256, 67, False, False)]
    errs = {}
    for dt_name, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        worst: dict[str, float] = {}
        for b, k, t, r, e, kc, with_rm, tied in cases:
            w = unit_rows(torch, gen, b, k, e)
            v = unit_rows(torch, gen, b, t, r, e)
            u = 0.5 * torch.randn(b, t, r, e, generator=gen)
            centers = unit_rows(torch, gen, kc, e)
            fm, rm = frame_region_masks(torch, gen, b, t, r)
            hc = (torch.rand(b, t, generator=gen) > 0.2).float()
            if tied:
                v[:, :, 16] = v[:, :, 8]
                rm[:, :, 16] = rm[:, :, 8]
                centers[5] = centers[2]
            got = compare_diag(
                torch, *(x.to(dt).to(device) for x in (w, v, u)),
                *(x.to(device) for x in (centers, fm, hc)),
                rm.to(device) if with_rm else None,
                f"{dt_name} B={b} K={k} T={t} R={r} E={e} Kc={kc} "
                f"rm={with_rm} ties={tied}", tied)
            worst = {n: max(worst.get(n, 0.0), x) for n, x in got.items()}
        errs[dt_name] = worst
        log(f"diag_epilogue (K4f) / diag_epilogue_bwd (K4b) vs plain, "
            f"{dt_name}: max |err| " + ", ".join(
                f"{n} {int(x)}" if n.endswith("other_way") else
                f"{n} {x:.3e}" for n, x in worst.items())
            + f" ({DIAG_TOL} as rtol, atol, ctx against plain plus its "
            f"terms rounded the other way; r*, f, c* equal where clear of "
            f"ties; {len(cases)} cases)")
    return errs


# ------------------------------------------------------------- serving


def make_requests(root: str):
    """Synthetic config4-width segments (with their ground truth)."""
    from nafae_torch.data.synthetic import generate_synthetic_dataset

    generate_synthetic_dataset(root, "val", num_segments=NUM_SEGMENTS,
                               feat_dim=2048, num_regions=20, max_frames=20,
                               max_words=4, seed=SEED)
    segs, gts = [], []
    with open(os.path.join(root, "val", "index.jsonl")) as f:
        index = [json.loads(ln) for ln in f if ln.strip()]
    for meta in index:
        with np.load(os.path.join(root, "val", meta["file"])) as z:
            segs.append({"feats": z["feats"].astype(np.float32),
                         "boxes": z["boxes"].astype(np.float32),
                         "word_ids": z["word_ids"].astype(np.int32).tolist()})
            gts.append((z["gt_boxes"].astype(np.float32),
                        z["gt_mask"].astype(np.float32)))
    return segs, gts


def oracle_params(vocab: int = 67, feat_dim: int = 2048, embed: int = 256):
    """Planted-signal oracle (the tests' golden-fixture construction at
    full width): w_v projects onto the class directions, zero-padded from
    the 67 classes to E columns."""
    from nafae_torch.data.synthetic import _class_directions

    dirs = _class_directions(vocab, feat_dim)
    w_v = np.zeros((feat_dim, embed), np.float32)
    w_v[:, :vocab] = dirs.T[:, :embed]
    return {"word_emb": (dirs @ w_v).astype(np.float32), "w_v": w_v,
            "b_v": np.zeros(embed, np.float32)}


def box_accuracy(torch, segs, results, gts) -> float:
    """Micro box accuracy of served regions, scored by the port's
    grounding_hits; also checks each served box is its region's box."""
    from nafae_torch.ops.iou import grounding_hits

    hits = total = 0.0
    for seg, res, (gt_b, gt_m) in zip(segs, results, gts):
        boxes = seg["boxes"]
        t, r = boxes.shape[:2]
        region = np.array([[fr["region"] for fr in w["frames"]]
                           for w in res["words"]])                 # [K,T]
        served = np.array([[fr["box"] for fr in w["frames"]]
                           for w in res["words"]], np.float32)     # [K,T,4]
        if region.shape != gt_m.shape:
            fail(f"response shape {region.shape} != ground truth {gt_m.shape}")
        if not np.array_equal(served, boxes[np.arange(t)[None], region]):
            fail("a served box is not the box of its served region")
        s = np.eye(r, dtype=np.float32)[region]                    # [K,T,R]
        c, m = grounding_hits(torch.from_numpy(s[None]),
                              torch.from_numpy(boxes[None]),
                              torch.from_numpy(gt_b[None]),
                              torch.from_numpy(gt_m[None]))
        hits += c.sum().item()
        total += m.sum().item()
    return hits / max(total, 1.0)


def max_response_diff(got: list[dict], want: list[dict]) -> float:
    """Largest score / frame-weight / video-score gap between two lists of
    responses; fails unless their structure, regions and boxes are equal."""
    def strip(res):
        return [[(w["word_id"], w["word"],
                  [(f["frame"], f["region"], f["box"]) for f in w["frames"]])
                 for w in r["words"]] for r in res]

    def nums(res):
        return np.array([x for r in res for x in
                         [f["score"] for w in r["words"] for f in w["frames"]]
                         + r["frame_weights"] + [r["video_score"]]])

    if strip(got) != strip(want):
        fail("responses differ in structure, regions or boxes")
    a, b = nums(got), nums(want)
    return float(np.abs(a - b).max()) if a.size else 0.0


def post_concurrently(base: str, requests: list[list[dict]]) -> list[list]:
    def post(segs):
        body = json.dumps({"segments": [
            {"feats": s["feats"].tolist(), "boxes": s["boxes"].tolist(),
             "word_ids": s["word_ids"]} for s in segs]}).encode()
        req = urllib.request.Request(base + "/ground", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())["results"]

    with concurrent.futures.ThreadPoolExecutor(len(requests)) as ex:
        return list(ex.map(post, requests))


def serve_over_http(srv, requests: list[list[dict]]) -> list[list]:
    """Starts the HTTP front on a free port, posts `requests` concurrently,
    and stops it again."""
    box = {}
    ready = threading.Event()
    th = threading.Thread(
        target=srv.serve_http,
        kwargs=dict(host="127.0.0.1", port=0, max_request_bytes=1 << 30,
                    ready_cb=lambda h: (box.update(h=h), ready.set())),
        daemon=True)
    th.start()
    if not ready.wait(60):
        fail("HTTP server did not start")
    try:
        base = f"http://127.0.0.1:{box['h'].server_address[1]}"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        if health.get("backend") != srv.device.type:
            fail(f"/healthz reports {health}")
        return post_concurrently(base, requests)
    finally:
        box["h"].shutdown()
        th.join(30)
        if th.is_alive():
            fail("HTTP server thread did not stop")


def serve(torch, cfg_of, params, segs, gts, device="cuda"):
    """The main path. Returns per-dtype servers and their results."""
    from nafae_torch.serve import GroundingServer

    out = {}
    for dt in ("float32", "bfloat16"):
        srv = GroundingServer(cfg_of(dt), params, device=device)
        t0 = time.perf_counter()
        results = srv.ground_segments(segs)
        wall = time.perf_counter() - t0
        for res in results:
            vals = [fr["score"] for w in res["words"] for fr in w["frames"]]
            vals += res["frame_weights"] + [res["video_score"]]
            if not np.all(np.isfinite(vals)):
                fail(f"{dt} server returned non-finite values")
        acc = box_accuracy(torch, segs, results, gts)
        log(f"served {len(segs)} segments in process ({dt}): box accuracy "
            f"{acc:.4f} (bar {ACC_BAR}), {wall:.3f} s incl. the first "
            "batch's warm-up")
        if acc < ACC_BAR:
            fail(f"{dt} box accuracy {acc} < {ACC_BAR}")
        if dt == "float32":
            picks = [[0, 1], [2], [3, 4]]          # 3 concurrent requests
            answers = serve_over_http(
                srv, [[segs[i] for i in p] for p in picks])
            worst = max(max_response_diff(ans, [results[i] for i in p])
                        for p, ans in zip(picks, answers))
            if worst > 1e-5:
                fail(f"HTTP answers differ from the in-process results by "
                     f"{worst}")
            log(f"HTTP: 3 concurrent requests answered; equal to the "
                f"in-process results (regions, boxes; max |score or weight "
                f"diff| {worst:.3e})")
        out[dt] = (srv, results)
    return out


def check_cpu_rerun(torch, cfg, params, srv, segs) -> None:
    """One batch re-run on the CPU through the plain versions."""
    from nafae_torch.serve import GroundingServer

    cpu = GroundingServer(cfg, params, device="cpu")
    batch = segs[:srv.batch_size]
    worst = max_response_diff(srv.ground_segments(batch),
                              cpu.ground_segments(batch))
    if worst > 1e-4:
        fail(f"GPU and CPU scores/frame weights differ by {worst}")
    log(f"CPU re-run of one f32 batch: regions equal, max |score or frame "
        f"weight diff| {worst:.3e} (limit 1e-4)")


# ------------------------------------------------------------- training


def make_train_data(root: str) -> None:
    """Planted-signal config4-width training segments (K up to 8 words)."""
    from nafae_torch.data.synthetic import generate_synthetic_dataset

    generate_synthetic_dataset(root, "train", num_segments=TRAIN_SEGMENTS,
                               feat_dim=2048, num_regions=20, max_frames=20,
                               max_words=8, seed=SEED)


def train_cfg(root: str, ckpt: str, dtype: str, steps: int,
              kernels: str = "auto"):
    from nafae_torch.config import load_config

    return load_config(preset_name="config4", overrides=TRAIN_OVERRIDES + [
        f"data.root={root}", f"train.ckpt_dir={ckpt}", f"model.dtype={dtype}",
        f"train.steps={steps}", f"train.kernels={kernels}"])


def kernel_modules():
    from nafae_torch.ops.kernels import cross_mil, ctx_mix, diag

    return ctx_mix, cross_mil, diag


def zero_counts() -> None:
    """Sets every kernel's launch count to 0."""
    for mod in kernel_modules():
        for k in mod.launches:
            mod.launches[k] = 0


def read_counts() -> dict[str, int]:
    return {k: n for mod in kernel_modules() for k, n in mod.launches.items()}


def per_step_launches(route: str, residual: bool = True) -> dict[str, int]:
    """Launches of each kernel in one training step of `route`."""
    want = dict.fromkeys(read_counts(), 0)
    want["ctx_mix_fwd_res" if residual else "ctx_mix_fwd"] = 1
    want["ctx_mix_bwd_res" if residual else "ctx_mix_bwd"] = 1
    if route == "pallas":
        want.update(cross_mil=2, diag_epilogue=1, diag_epilogue_bwd=1)
    return want


def run_fit(torch, cfg, device="cuda") -> list[dict]:
    """nafae_torch.train.fit as a user calls it; the per-step metrics."""
    from nafae_torch.train import fit

    logs = []
    fit(cfg, device=device, log_fn=logs.append)
    if len(logs) != cfg.train.steps:
        fail(f"fit logged {len(logs)} of {cfg.train.steps} steps")
    for m in logs:
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"training step {m['step']} gave non-finite metrics: {m}")
    return logs


def train(torch, root: str, tmp: str) -> dict:
    """The training main paths: fit in f32 and bf16 with train.kernels
    auto (K1fr + K1br once a step) and pallas (also K3 twice, K4f and K4b
    once a step), then auto with ALPHA_RESIDUAL off (K1f + K1b once a
    step). Each run is read with the launch counts zeroed just before it.
    Returns {route: {dtype: {"logs", "launches"}}, "recompute": ...}."""
    from nafae_torch.ops.kernels import ctx_mix as K

    out = {}
    for route in ROUTES:
        out[route] = {}
        for dt, steps in TRAIN_STEPS.items():
            cfg = train_cfg(root, os.path.join(tmp, f"ck_{route}_{dt}"), dt,
                            steps, route)
            zero_counts()                       # main path starts here
            t0 = time.perf_counter()
            logs = run_fit(torch, cfg)
            wall = time.perf_counter() - t0
            counts = read_counts()              # ... and ends here
            want = {k: n * steps for k, n in per_step_launches(route).items()}
            if counts != want:
                fail(f"{dt} training ({route}) launched {counts}, expected "
                     f"{want}")
            first = statistics.mean(m["loss"] for m in logs[:3])
            last = statistics.mean(m["loss"] for m in logs[-3:])
            log(f"trained config4 {steps} steps ({dt}, kernels={route}) in "
                f"{wall:.2f} s incl. set-up: loss {logs[0]['loss']:.5f} -> "
                f"{logs[-1]['loss']:.5f} (mean of first 3 {first:.5f}, last "
                f"3 {last:.5f}); launches {counts}")
            if not last < first:
                fail(f"{dt} training ({route}) did not lower the loss: "
                     f"{first} -> {last}")
            out[route][dt] = {"logs": logs, "launches": counts}

    K.ALPHA_RESIDUAL = False
    try:
        steps = CPU_STEPS
        cfg = train_cfg(root, os.path.join(tmp, "ck_recompute"), "float32",
                        steps)
        zero_counts()                           # main path starts here
        run_fit(torch, cfg)
        counts = read_counts()                  # ... and ends here
    finally:
        K.ALPHA_RESIDUAL = True
    want = {k: n * steps for k, n in
            per_step_launches("auto", residual=False).items()}
    if counts != want:
        fail(f"training with ALPHA_RESIDUAL off launched {counts}, "
             f"expected {want}")
    log(f"trained {steps} steps with ALPHA_RESIDUAL off: launches {counts}")
    out["recompute"] = {"launches": counts}
    return out


def first_batch(root: str):
    """The first training batch (numpy), as fit's loader gives it."""
    from nafae_torch.data.loader import BatchLoader
    from nafae_torch.data.youcook2 import SegmentDataset

    ds = SegmentDataset(root, "train", 20, 20, 2048, 8)
    return next(iter(BatchLoader(ds, 16, shuffle=True, seed=0)))


def step_grads(torch, cfg, state, batch, kernels):
    """(loss, {name: gradient on the CPU}) of one compute_losses call."""
    from nafae_torch.train import batch_to_device, compute_losses

    params = {k: v.detach().requires_grad_() for k, v in state.params.items()}
    total, _ = compute_losses(params, state.centers,
                              batch_to_device(batch, state.device), cfg,
                              kernels)
    names = sorted(params)
    gs = torch.autograd.grad(total, [params[k] for k in names])
    return float(total.detach()), {k: g.cpu() for k, g in zip(names, gs)}


def check_train_cpu_rerun(torch, root: str, tmp: str, logs: list[dict],
                          kernels: str = "auto"):
    """The first CPU_STEPS steps re-run on the CPU (same data, same seed)
    against the card's f32 run; and one step's gradients, card against CPU,
    from the same initial state and batch."""
    from nafae_torch.train import TrainState

    cfg = train_cfg(root, os.path.join(tmp, f"ck_cpu_{kernels}"), "float32",
                    CPU_STEPS, kernels)
    cpu_logs = run_fit(torch, cfg, device="cpu")
    rtol, atol = CPU_METRIC_TOL
    worst = 0.0
    for g, c in zip(logs[:CPU_STEPS], cpu_logs):
        for k in c:
            if k in ("frames_per_sec", "ts"):
                continue
            if not np.isclose(g[k], c[k], rtol=rtol, atol=atol):
                fail(f"step {c['step']} {k}: card {g[k]} vs CPU {c[k]}")
            if k != "step":
                worst = max(worst, abs(g[k] - c[k]) / max(abs(c[k]), 1e-30))
    batch = first_batch(root)
    grads = {dev: step_grads(torch, cfg, TrainState.create(cfg, device=dev),
                             batch, kernels)[1] for dev in ("cuda", "cpu")}
    grtol, gatol = CPU_GRAD_TOL
    gworst = 0.0
    for k, gc in grads["cpu"].items():
        scale = gc.abs().max().item()
        err = (grads["cuda"][k] - gc).abs().max().item()
        if not torch.allclose(grads["cuda"][k], gc, rtol=grtol,
                              atol=gatol * max(scale, 1e-30)):
            fail(f"gradient of {k}: card and CPU differ by {err} "
                 f"(largest entry {scale})")
        gworst = max(gworst, err / max(scale, 1e-30))
    log(f"CPU re-run of the first {CPU_STEPS} f32 training steps "
        f"(kernels={kernels}): metrics "
        f"agree, max relative diff {worst:.3e} (limit rtol {rtol}, atol "
        f"{atol}); one step's gradients agree, max |diff| / largest entry "
        f"{gworst:.3e} (limit rtol {grtol}, atol {gatol} x largest entry)")
    return {"metric_rel_diff": worst, "grad_rel_diff": gworst}


def check_pallas_vs_auto(torch, root: str, tmp: str) -> dict:
    """The first step's loss and gradients on the card, f32, from one
    initial state and batch: the pallas route (K3, K4f/K4b) against the
    auto route (dense products, autograd)."""
    from nafae_torch.train import TrainState

    cfg = train_cfg(root, os.path.join(tmp, "ck_routes"), "float32", 1)
    state = TrainState.create(cfg, device="cuda")
    batch = first_batch(root)
    (la, ga), (lp, gp) = (step_grads(torch, cfg, state, batch, route)
                          for route in ROUTES)
    rtol, frac = PALLAS_AUTO_TOL
    if not abs(lp - la) <= rtol * abs(la):
        fail(f"the pallas route's loss {lp} differs from the auto route's "
             f"{la} by more than rtol {rtol}")
    worst = 0.0
    for k, g in ga.items():
        scale = max(g.abs().max().item(), 1e-30)
        err = (gp[k] - g).abs().max().item()
        if err > frac * scale:
            fail(f"gradient of {k}: pallas and auto routes differ by {err} "
                 f"(largest entry {scale})")
        worst = max(worst, err / scale)
    log(f"first step, pallas route vs auto route (f32, same batch): loss "
        f"{lp:.8f} vs {la:.8f} (rel diff {abs(lp - la) / abs(la):.3e}, limit "
        f"{rtol}); gradients max |diff| / largest entry {worst:.3e} (limit "
        f"{frac})")
    return {"loss_pallas": lp, "loss_auto": la,
            "loss_rel_diff": abs(lp - la) / abs(la), "grad_rel_diff": worst}


# ------------------------------------------------------------- times


def device_ms(torch, fn, reps: int = 10, runs: int = 21) -> float:
    """Device time of one fn() call: `reps` calls captured into one CUDA
    graph (after a warm-up outside it), each replay timed with CUDA events;
    the median over `runs` replays, divided by reps. The graph keeps host
    overhead out of the device time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def profile_forward(torch, fn, reps: int = 5):
    """Device time per call by kernel name, from torch.profiler (CUPTI):
    ([(name, us per call)] largest first, total device ms per call, device
    operations per call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    count = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per[ev.name] = (per.get(ev.name, 0.0)
                            + ev.time_range.elapsed_us() / reps)
            count += 1
    if not per:
        fail("torch.profiler recorded no device time")
    top = sorted(per.items(), key=lambda kv: -kv[1])
    return ([(name[:80], us) for name, us in top[:8]],
            sum(per.values()) / 1e3, count / reps)


def ctx_bound_ms(torch, v_ext, fm_ext, rm_ext, w, flops_per_pair: int,
                 more_bytes: int) -> tuple[float, str]:
    """Least time for a context-mix kernel on these inputs: v_ext and the
    masks read once plus `more_bytes` (the kernel's other inputs and its
    outputs, each moved once), over the memory rate; flops_per_pair·R·R·E
    flops for each (video, centre frame, offset) with both frames valid
    (what the function needs: 4 for the forward, 8 for K1br, 10 for K1b),
    over the peak rate for the operands' type: f32 CUDA cores for f32,
    bf16 tensor cores for bf16."""
    b, t_ext, r, e = v_ext.shape
    t = t_ext - 2 * w
    fm_c = fm_ext[:, w:w + t]
    live = sum(int((fm_ext[:, w + o:w + o + t] * fm_c).count_nonzero())
               for o in range(-w, w + 1) if o != 0)
    return bound(torch, nbytes(v_ext, fm_ext, rm_ext) + more_bytes,
                 flops_per_pair * r * r * e * live, v_ext.dtype)


def fwd_bound_ms(torch, v_ext, fm_ext, rm_ext, w, residual=False):
    """K1f (u written) or K1fr (u and alpha written)."""
    b, t_ext, r, e = v_ext.shape
    t = t_ext - 2 * w
    more = b * t * r * e * 4
    if residual:
        more += b * t * 2 * w * r * r * v_ext.element_size()
    return ctx_bound_ms(torch, v_ext, fm_ext, rm_ext, w, 4, more)


def bwd_bound_ms(torch, v_ext, fm_ext, rm_ext, w, residual):
    """K1br (alpha and du read, dv written) or K1b (du read, dv written)."""
    b, t_ext, r, e = v_ext.shape
    t = t_ext - 2 * w
    more = b * t * r * e * 4 + b * t_ext * r * e * 4
    if residual:
        more += b * t * 2 * w * r * r * v_ext.element_size()
    return ctx_bound_ms(torch, v_ext, fm_ext, rm_ext, w,
                        8 if residual else 10, more)


def timings(torch, srv, segs) -> dict:
    """Device times of K1f and its plain version on the first serving
    batch's own inputs (and on the same embeddings with every frame valid),
    and of one full serving batch; plus the batch host to host."""
    from nafae_torch.ops import grounding as TG
    from nafae_torch.ops.kernels import ctx_mix as K

    w, temp = srv.model.ctx_window, srv.model.ctx_temp
    samples = [srv._pad_segment(s) for s in segs[:srv.batch_size]]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    dev = torch.device("cuda")
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    params = dict(srv.model.params.items())
    res = {}
    with torch.inference_mode():
        v_emb = TG.project_params(params, tb["feats"])
        v_ext, fm_ext, rm_ext = TG.extend_for_window(
            v_emb, tb["frame_mask"], tb["region_mask"], w)
        dense_fm = torch.nn.functional.pad(torch.ones_like(tb["frame_mask"]),
                                           (w, w))
        for tag, fm in (("", fm_ext), ("_dense", dense_fm)):
            for dt_tag, v in (("", v_ext), ("_bf16", v_ext.to(torch.bfloat16))):
                res["ms" + tag + dt_tag] = device_ms(
                    torch, lambda: K.launch_fwd(v, fm, w, temp, rm_ext))
                res["plain_ms" + tag + dt_tag] = device_ms(
                    torch, lambda: K.context_mix_plain(v, fm, w, temp,
                                                       rm_ext=rm_ext))
                res["bound_ms" + tag + dt_tag], res["bound_by" + tag + dt_tag] \
                    = fwd_bound_ms(torch, v, fm, rm_ext, w)
        res["batch_device_ms"] = device_ms(torch, lambda: srv._fn(
            tb["feats"], tb["boxes"], tb["word_ids"], tb["frame_mask"],
            tb["word_mask"], tb["region_mask"]))
        (res["kernels_by_device_time"], res["device_busy_ms"],
         _) = profile_forward(
            torch, lambda: srv._fn(tb["feats"], tb["boxes"], tb["word_ids"],
                                   tb["frame_mask"], tb["word_mask"],
                                   tb["region_mask"]))
    zero_counts()
    srv.run_batch(batch)
    res["launches_per_batch"] = K.launches["ctx_mix_fwd"]
    # one full batch as a caller sees it: host arrays in, host arrays out
    runs = []
    for i in range(25):
        t0 = time.perf_counter()
        srv.run_batch(batch)
        if i >= 5:
            runs.append((time.perf_counter() - t0) * 1e3)
    res["batch_host_ms"] = statistics.median(runs)
    frames = batch["feats"].shape[0] * batch["feats"].shape[1]
    res["batch_frames"] = frames
    res["frames_per_s_device"] = frames / res["batch_device_ms"] * 1e3
    res["frames_per_s_host"] = frames / res["batch_host_ms"] * 1e3
    res["shapes"] = {"B": int(v_ext.shape[0]), "T": int(v_ext.shape[1] - 2 * w),
                     "R": int(v_ext.shape[2]), "E": int(v_ext.shape[3]),
                     "w": w}
    return res


def train_timings(torch, root: str, tmp: str) -> dict:
    """On the first training batch (config4, B=16, T=20, its own masks),
    from the initial params: device times of K1fr, K1b and K1br and of
    their plain versions (autograd through context_mix_plain: its forward,
    which keeps its residuals, and its backward alone) in f32 and bf16;
    then one training step of each route in f32 and bf16 (step_timings)."""
    from nafae_torch.ops import grounding as TG
    from nafae_torch.ops.kernels import ctx_mix as K
    from nafae_torch.train import TrainState, batch_to_device

    dev = torch.device("cuda")
    batch = first_batch(root)
    tb = batch_to_device(batch, dev)
    cfg = train_cfg(root, os.path.join(tmp, "ck_time"), "float32", 1000)
    state = TrainState.create(cfg, device=dev)
    w, temp = cfg.loss.ctx_window, cfg.loss.ctx_temp
    with torch.no_grad():
        v_emb = TG.project_regions(tb["feats"], state.params["w_v"],
                                   state.params["b_v"])
        v32, fm_ext, rm_ext = TG.extend_for_window(
            v_emb, tb["frame_mask"], tb["region_mask"], w)
    b, t_ext, r, e = v32.shape
    du = torch.randn(b, t_ext - 2 * w, r, e,
                     generator=torch.Generator().manual_seed(SEED)).to(dev)
    res = {"shapes": {"B": b, "T": t_ext - 2 * w, "R": r, "E": e, "w": w}}
    for tag, v in (("", v32), ("_bf16", v32.to(torch.bfloat16))):
        dt_name = "bfloat16" if tag else "float32"
        res["errs" + tag] = compare_grad_kernels(
            torch, v, fm_ext, rm_ext, w, du, dt_name,
            f"{dt_name}, the first training batch")
        _, alpha = K.launch_fwd(v, fm_ext, w, temp, rm_ext, residual=True)
        res["fwd_res_ms" + tag] = device_ms(torch, lambda: K.launch_fwd(
            v, fm_ext, w, temp, rm_ext, residual=True))
        res["bwd_ms" + tag] = device_ms(torch, lambda: K.launch_bwd(
            v, fm_ext, w, temp, rm_ext, du))
        res["bwd_res_ms" + tag] = device_ms(torch, lambda: K.launch_bwd(
            v, fm_ext, w, temp, rm_ext, du, alpha))
        vp = v.detach().clone().requires_grad_()
        res["plain_fwd_res_ms" + tag] = profile_forward(
            torch, lambda: K.context_mix_plain(vp, fm_ext, w, temp,
                                               rm_ext=rm_ext))[1]
        up, _ = K.context_mix_plain(vp, fm_ext, w, temp, rm_ext=rm_ext)
        res["plain_bwd_ms" + tag] = profile_forward(
            torch, lambda: torch.autograd.grad(up, vp, du,
                                               retain_graph=True))[1]
        for key, bnd in (
                ("fwd_res", fwd_bound_ms(torch, v, fm_ext, rm_ext, w, True)),
                ("bwd", bwd_bound_ms(torch, v, fm_ext, rm_ext, w, False)),
                ("bwd_res", bwd_bound_ms(torch, v, fm_ext, rm_ext, w, True))):
            res[key + "_bound_ms" + tag], res[key + "_bound_by" + tag] = bnd

    frames = b * (t_ext - 2 * w)
    for route in ROUTES:
        for dt in TRAIN_STEPS:
            tag = (("" if route == "auto" else "_pallas")
                   + ("" if dt == "float32" else "_bf16"))
            res.update(step_timings(torch, root, tmp, batch, dt, route, tag,
                                    frames))
    return res


def step_timings(torch, root, tmp, batch, dt, route, tag, frames) -> dict:
    """One training step of `route` in `dt`: CUDA events around the step,
    host to host (numpy batch in, metrics ready), the same on a resident
    batch, the batch's copy alone, and torch.profiler's device busy time
    and kernels by device time. Keys end in `tag`."""
    from nafae_torch.train import (TrainState, batch_to_device,
                                   make_optimizer, train_step)

    dev = torch.device("cuda")
    tb = batch_to_device(batch, dev)
    cfg = train_cfg(root, os.path.join(tmp, "ck_time"), dt, 1000, route)
    tx = make_optimizer(cfg)
    st = TrainState.create(cfg, device=dev)
    for _ in range(3):
        st, _ = train_step(st, batch_to_device(batch, dev), cfg, tx)
    torch.cuda.synchronize()
    host, events = [], []
    for _ in range(12):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        st, m = train_step(st, batch_to_device(batch, dev), cfg, tx)
        z.record()
        float(m["loss"])                        # metrics ready on the host
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(a.elapsed_time(z))
    resident, h2d = [], []
    for _ in range(12):
        t0 = time.perf_counter()
        st, m = train_step(st, tb, cfg, tx)
        float(m["loss"])
        resident.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        batch_to_device(batch, dev)
        torch.cuda.synchronize()
        h2d.append((time.perf_counter() - t0) * 1e3)
    top, busy, ops = profile_forward(
        torch, lambda: train_step(st, tb, cfg, tx))
    res = {"step_host_ms_resident" + tag: statistics.median(resident),
           "step_h2d_ms" + tag: statistics.median(h2d),
           "step_device_ops" + tag: ops,
           "step_event_ms" + tag: statistics.median(events),
           "step_host_ms" + tag: statistics.median(host),
           "step_device_busy_ms" + tag: busy,
           "step_kernels" + tag: top}
    res["frames_per_s_event" + tag] = frames / res["step_event_ms" + tag] * 1e3
    res["frames_per_s_host" + tag] = frames / res["step_host_ms" + tag] * 1e3
    return res


def bound(torch, nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """(least ms, what bounds it): `nbytes` over the memory rate against
    `flops` over the peak rate for the operands' type (f32 CUDA cores, or
    bf16 tensor cores)."""
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs if x is not None)


def fused_timings(torch, root: str, tmp: str) -> dict:
    """On the first training batch (config4, B=16, K=8, T=20, R=20, E=256,
    Kc=67, its own masks), from the initial params, in f32 and bf16: device
    times (CUDA graphs) of K3, K4f and K4b, of their plain versions, and for
    K3 of the two PyTorch calls that compute the same max on the auto route
    (torch.matmul, then torch.max over R: no mask); their bounds from these
    inputs; and each kernel's max |error| against its plain version here."""
    from nafae_torch.ops import grounding as TG
    from nafae_torch.ops.kernels import cross_mil as K3
    from nafae_torch.ops.kernels import diag as K4
    from nafae_torch.train import TrainState, batch_to_device

    dev = torch.device("cuda")
    tb = batch_to_device(first_batch(root), dev)
    cfg = train_cfg(root, os.path.join(tmp, "ck_fused"), "float32", 1000,
                    "pallas")
    state = TrainState.create(cfg, device=dev)
    p, w = state.params, cfg.loss.ctx_window
    fm, rm = tb["frame_mask"], tb["region_mask"]
    with torch.no_grad():
        w_emb = TG.embed_words(tb["word_ids"], p["word_emb"],
                               m_sim=p.get("m_sim"))
        v_emb = TG.project_regions(tb["feats"], p["w_v"], p["b_v"])
        v_ext, fm_ext, rm_ext = TG.extend_for_window(v_emb, fm, rm, w)
        u, nbr = TG.context_mix(v_ext, fm_ext, w, cfg.loss.ctx_temp,
                                rm_ext=rm_ext)
    hc = (nbr.sum(-1) > 0).float()
    centers = state.centers
    b, t, r, e = v_emb.shape
    k, kc = w_emb.shape[1], centers.shape[0]
    m = b * k
    # what the data needs: the bounds count region rows of v̂ and u only
    # where the function reads them (padded frames have rm = 0)
    live = int((rm > 0).sum())                        # (b, t, r) regions
    on = int(((rm > 0) & (fm > 0)[..., None] & (hc > 0)[..., None]).sum())
    empty = int(((rm > 0).sum(-1) == 0).sum())        # all-masked frames
    res = {"shapes": {"B": b, "K": k, "T": t, "R": r, "E": e, "Kc": kc,
                      "live_regions": live, "ctx_regions": on,
                      "all_masked_frames": empty}}
    for tag, dt in (("", torch.float32), ("_bf16", torch.bfloat16)):
        wf = w_emb.reshape(m, e).to(dt).contiguous()
        wk, v, uu = w_emb.to(dt), v_emb.to(dt), u.to(dt)
        row = e * v.element_size()                    # one region of v̂ or u
        # K3: a and idx of every (video, word, frame) from the live regions;
        # an all-masked frame's a and idx need no region
        a, _ = K3.launch(wf, v, fm, rm)
        torch.cuda.synchronize()
        res["cross_mil_err" + tag] = (
            a - K3.cross_mil_plain(wf, v, fm, rm)[0]).abs().max().item()
        res["cross_mil_ms" + tag] = device_ms(
            torch, lambda: K3.launch(wf, v, fm, rm))
        res["cross_mil_plain_ms" + tag] = device_ms(
            torch, lambda: K3.cross_mil_plain(wf, v, fm, rm))
        v2 = v.reshape(b, t * r, e)
        res["cross_mil_library_ms" + tag] = device_ms(
            torch, lambda: torch.max(torch.matmul(v2, wf.T).reshape(
                b, t, r, m), dim=2))
        res["cross_mil_bound_ms" + tag], res["cross_mil_bound_by" + tag] = \
            bound(torch, nbytes(wf, fm, rm) + live * row + 2 * b * m * t * 4,
                  2 * m * e * live, dt)
        # K4f: s over live regions, ŝ over the ctx mask, sims everywhere;
        # it reads v̂ at the live regions and region 0 of all-masked frames
        # (its pick there), u at the ctx mask, and writes ctx, clu and f (its
        # residuals d, r* and c* are a choice of the design, not counted)
        fwd = K4.launch_fwd(wk, v, uu, centers, fm, hc, rm)
        torch.cuda.synchronize()
        want = K4.diag_fwd_plain(wk, v, uu, centers, fm, hc, rm)
        res["diag_err" + tag] = max((fwd[0] - want[0]).abs().max().item(),
                                    (fwd[3] - want[3]).abs().max().item())
        res["diag_ms" + tag] = device_ms(
            torch, lambda: K4.launch_fwd(wk, v, uu, centers, fm, hc, rm))
        res["diag_plain_ms" + tag] = device_ms(
            torch, lambda: K4.diag_fwd_plain(wk, v, uu, centers, fm, hc, rm))
        res["diag_bound_ms" + tag], res["diag_bound_by" + tag] = bound(
            torch, nbytes(wk, centers, fm, hc, rm, *fwd[:3])
            + (live + empty + on) * row,
            2 * e * k * (live + on) + 2 * e * kc * b * k * t, dt)
        # K4b on K4f's residuals, with random cotangents: it reads v̂ only
        # at the ctx mask (ds is 0 elsewhere) and only the centers in c*,
        # and writes dw and the whole of dv
        gen = torch.Generator().manual_seed(SEED + 5)
        dctx = torch.rand(fwd[0].shape, generator=gen).to(dev)
        dclu = torch.rand(fwd[1].shape, generator=gen).to(dev)
        res_args = (wk, v, centers, fwd[3], fwd[4], fwd[5], fwd[2], dctx,
                    dclu)
        dw, dv = K4.launch_bwd(*res_args)
        torch.cuda.synchronize()
        pdw, pdv = K4.diag_bwd_plain(*res_args)
        res["diag_bwd_err" + tag] = max((dw - pdw).abs().max().item(),
                                        (dv - pdv).abs().max().item())
        res["diag_bwd_ms" + tag] = device_ms(
            torch, lambda: K4.launch_bwd(*res_args))
        res["diag_bwd_plain_ms" + tag] = device_ms(
            torch, lambda: K4.diag_bwd_plain(*res_args))
        res["diag_bwd_bound_ms" + tag], res["diag_bwd_bound_by" + tag] = \
            bound(torch, nbytes(wk, *res_args[3:], dw, dv) + on * row
                  + int(fwd[5].unique().numel()) * e * centers.element_size(),
                  4 * e * k * on + 4 * e * b * k * t, dt)
    return res


def kernel_entry(name, source, replaces, launches, per, err, ms, plain, bound,
                 by, library_ms=None, **more) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_per_step_or_batch": per, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms, **more}


# -------------------------------------------------------------------- main


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one NVIDIA GPU")
    from nafae_torch.config import load_config
    from nafae_torch.ops.kernels import _build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    log(f"built {', '.join(SOURCES)} in {time.perf_counter() - t0:.1f} s "
        "(one nvcc each, in parallel)")
    for name in SOURCES:
        usage = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"{name} ptxas: " + " | ".join(usage))

    errs = check_ctx_mix(torch, torch.device("cuda"))
    gerrs = check_ctx_grad(torch, torch.device("cuda"))
    xerrs = check_cross_mil(torch, torch.device("cuda"))
    derrs = check_diag(torch, torch.device("cuda"))

    def cfg_of(dt):
        return load_config(preset_name="config4",
                           overrides=[f"model.dtype={dt}"])

    params = oracle_params()
    with tempfile.TemporaryDirectory() as tmp:
        segs, gts = make_requests(tmp)
        zero_counts()                               # serving starts here
        served = serve(torch, cfg_of, params, segs, gts)
        serve_counts = read_counts()                # ... and ends here
        log(f"serving: launches {serve_counts}")
        if serve_counts["ctx_mix_fwd"] == 0 or any(
                n for k, n in serve_counts.items() if k != "ctx_mix_fwd"):
            fail("the serving path must launch the ctx_mix kernel (K1f) "
                 "and no other")
        srv32 = served["float32"][0]
        check_cpu_rerun(torch, cfg_of("float32"), params, srv32, segs)

        make_train_data(tmp)
        trained = train(torch, tmp, tmp)
        cpu = {route: check_train_cpu_rerun(
            torch, tmp, tmp, trained[route]["float32"]["logs"], route)
            for route in ROUTES}
        routes = check_pallas_vs_auto(torch, tmp, tmp)

        tm = timings(torch, srv32, segs)
        tt = train_timings(torch, tmp, tmp)
        tf = fused_timings(torch, tmp, tmp)
    log(f"ctx_mix device time on the first serving batch: f32 kernel "
        f"{tm['ms']:.4f} ms, plain {tm['plain_ms']:.4f} ms, bound "
        f"{tm['bound_ms']:.4f} ms ({tm['bound_by']}); bf16 kernel "
        f"{tm['ms_bf16']:.4f} ms, plain {tm['plain_ms_bf16']:.4f} ms, bound "
        f"{tm['bound_ms_bf16']:.4f} ms ({tm['bound_by_bf16']}); every "
        f"frame valid: f32 kernel {tm['ms_dense']:.4f} ms, plain "
        f"{tm['plain_ms_dense']:.4f} ms, bound {tm['bound_ms_dense']:.4f} ms; "
        f"bf16 kernel {tm['ms_dense_bf16']:.4f} ms, bound "
        f"{tm['bound_ms_dense_bf16']:.4f} ms at {tm['shapes']} — {card}")
    log("device time per serving forward by kernel (torch.profiler): "
        + "; ".join(f"{us:.1f} us {name}"
                    for name, us in tm["kernels_by_device_time"])
        + f" — total {tm['device_busy_ms']:.4f} ms")
    log(f"serving batch (f32, B={srv32.batch_size}): device "
        f"{tm['batch_device_ms']:.4f} ms = {tm['frames_per_s_device']:.0f} "
        f"frames/s; host to host {tm['batch_host_ms']:.4f} ms = "
        f"{tm['frames_per_s_host']:.0f} frames/s — {card}")
    for tag, dt in (("", "f32"), ("_bf16", "bf16")):
        log(f"K1fr/K1b/K1br vs plain on the first training batch, {dt}: "
            "max |err| " + ", ".join(f"{k} {v:.3e}"
                                     for k, v in tt["errs" + tag].items()))
        log(f"training batch {tt['shapes']}, {dt}: K1fr "
            f"{tt['fwd_res_ms' + tag]:.4f} ms (bound "
            f"{tt['fwd_res_bound_ms' + tag]:.4f}, "
            f"{tt['fwd_res_bound_by' + tag]}; plain forward under autograd "
            f"{tt['plain_fwd_res_ms' + tag]:.4f}); K1br "
            f"{tt['bwd_res_ms' + tag]:.4f} ms (bound "
            f"{tt['bwd_res_bound_ms' + tag]:.4f}, "
            f"{tt['bwd_res_bound_by' + tag]}); K1b {tt['bwd_ms' + tag]:.4f} "
            f"ms (bound {tt['bwd_bound_ms' + tag]:.4f}, "
            f"{tt['bwd_bound_by' + tag]}); plain backward "
            f"{tt['plain_bwd_ms' + tag]:.4f} ms — {card}")
        log(f"fused kernels on the first training batch {tf['shapes']}, "
            f"{dt}: K3 cross_mil {tf['cross_mil_ms' + tag]:.4f} ms (bound "
            f"{tf['cross_mil_bound_ms' + tag]:.4f}, "
            f"{tf['cross_mil_bound_by' + tag]}; plain "
            f"{tf['cross_mil_plain_ms' + tag]:.4f}; torch.matmul + torch.max "
            f"{tf['cross_mil_library_ms' + tag]:.4f}); K4f diag_epilogue "
            f"{tf['diag_ms' + tag]:.4f} ms (bound "
            f"{tf['diag_bound_ms' + tag]:.4f}, {tf['diag_bound_by' + tag]}; "
            f"plain {tf['diag_plain_ms' + tag]:.4f}); K4b diag_epilogue_bwd "
            f"{tf['diag_bwd_ms' + tag]:.4f} ms (bound "
            f"{tf['diag_bwd_bound_ms' + tag]:.4f}, "
            f"{tf['diag_bwd_bound_by' + tag]}; plain "
            f"{tf['diag_bwd_plain_ms' + tag]:.4f}); max |err| vs plain "
            f"{tf['cross_mil_err' + tag]:.3e} / {tf['diag_err' + tag]:.3e} / "
            f"{tf['diag_bwd_err' + tag]:.3e} — {card}")
        for route in ROUTES:
            rt = ("" if route == "auto" else "_pallas") + tag
            log(f"training step ({dt}, kernels={route}, config4 B=16 T=20): "
                f"CUDA events {tt['step_event_ms' + rt]:.4f} ms = "
                f"{tt['frames_per_s_event' + rt]:.0f} frames/s; host to host "
                f"{tt['step_host_ms' + rt]:.4f} ms = "
                f"{tt['frames_per_s_host' + rt]:.0f} frames/s; device busy "
                f"{tt['step_device_busy_ms' + rt]:.4f} ms (torch.profiler) "
                f"in {tt['step_device_ops' + rt]:.0f} device operations; of "
                f"the host time: the batch's copy to the card alone "
                f"{tt['step_h2d_ms' + rt]:.4f} ms, the step on a resident "
                f"batch {tt['step_host_ms_resident' + rt]:.4f} ms — {card}")
            log(f"device time per training step ({dt}, kernels={route}) by "
                "kernel: " + "; ".join(f"{us:.1f} us {name}"
                                       for name, us in tt["step_kernels" + rt]))

    f32, steps = trained["auto"]["float32"]["launches"], TRAIN_STEPS["float32"]
    fused = trained["pallas"]["float32"]["launches"]
    rec = trained["recompute"]["launches"]
    k3_replaces = ("nafae_tpu/ops/pallas/fused_ground.py:82, "   # _fwd_kernel
                   "nafae_tpu/ops/pallas/fused_ground.py:118")  # _rollmax_kernel
    print(json.dumps({"kernels": [
        kernel_entry(
            "ctx_mix_fwd", "nafae_torch/csrc/ctx_mix.cu",
            "nafae_tpu/ops/pallas/fused_ctx.py:157",        # _fwd_kernel
            serve_counts["ctx_mix_fwd"], tm["launches_per_batch"],
            errs["float32"], tm["ms"], tm["plain_ms"], tm["bound_ms"],
            tm["bound_by"],
            # f32, the default dtype; every *_bf16 key is the same number
            # for bf16 input, every *_dense key with every frame valid
            max_abs_err_bf16=errs["bfloat16"], ms_bf16=tm["ms_bf16"],
            plain_ms_bf16=tm["plain_ms_bf16"],
            bound_ms_bf16=tm["bound_ms_bf16"],
            bound_by_bf16=tm["bound_by_bf16"], ms_dense=tm["ms_dense"],
            plain_ms_dense=tm["plain_ms_dense"],
            bound_ms_dense=tm["bound_ms_dense"],
            bound_by_dense=tm["bound_by_dense"],
            ms_dense_bf16=tm["ms_dense_bf16"],
            plain_ms_dense_bf16=tm["plain_ms_dense_bf16"],
            bound_ms_dense_bf16=tm["bound_ms_dense_bf16"],
            bound_by_dense_bf16=tm["bound_by_dense_bf16"],
            shapes=tm["shapes"], path="serving"),
        *(kernel_entry(
            name, src, rep, launches, launches / n,
            max(gerrs["float32"][name], tt["errs"][name]),
            tt[key + "_ms"], tt["plain_" + pkey + "_ms"],
            tt[key + "_bound_ms"], tt[key + "_bound_by"],
            max_abs_err_bf16=max(gerrs["bfloat16"][name],
                                 tt["errs_bf16"][name]),
            ms_bf16=tt[key + "_ms_bf16"],
            plain_ms_bf16=tt["plain_" + pkey + "_ms_bf16"],
            bound_ms_bf16=tt[key + "_bound_ms_bf16"],
            bound_by_bf16=tt[key + "_bound_by_bf16"],
            shapes=tt["shapes"], path=path)
          for name, src, rep, launches, n, key, pkey, path in (
              ("ctx_mix_fwd_res", "nafae_torch/csrc/ctx_mix.cu",
               "nafae_tpu/ops/pallas/fused_ctx.py:177",   # _fwd_kernel_res
               f32["ctx_mix_fwd_res"], steps, "fwd_res", "fwd_res",
               "training f32"),
              ("ctx_mix_bwd", "nafae_torch/csrc/ctx_mix_bwd.cu",
               "nafae_tpu/ops/pallas/fused_ctx.py:203",   # _bwd_kernel
               rec["ctx_mix_bwd"], CPU_STEPS, "bwd", "bwd",
               "training f32, ALPHA_RESIDUAL off"),
              ("ctx_mix_bwd_res", "nafae_torch/csrc/ctx_mix_bwd.cu",
               "nafae_tpu/ops/pallas/fused_ctx.py:256",   # _bwd_kernel_res
               f32["ctx_mix_bwd_res"], steps, "bwd_res", "bwd",
               "training f32"))),
        *(kernel_entry(
            name, "nafae_torch/csrc/" + src, rep, fused[name],
            fused[name] / steps, max(err["float32"], tf[key + "_err"]),
            tf[key + "_ms"], tf[key + "_plain_ms"], tf[key + "_bound_ms"],
            tf[key + "_bound_by"], library_ms=tf.get(key + "_library_ms"),
            max_abs_err_bf16=max(err["bfloat16"], tf[key + "_err_bf16"]),
            ms_bf16=tf[key + "_ms_bf16"],
            plain_ms_bf16=tf[key + "_plain_ms_bf16"],
            bound_ms_bf16=tf[key + "_bound_ms_bf16"],
            bound_by_bf16=tf[key + "_bound_by_bf16"],
            library_ms_bf16=tf.get(key + "_library_ms_bf16"),
            **({"library": "torch.matmul then torch.max over R: two calls, "
                "the auto route's product and max without the mask (bf16: "
                "bf16 output)"} if key == "cross_mil" else {}),
            shapes=tf["shapes"], path="training f32, kernels=pallas")
          for name, src, rep, key, err in (
              ("cross_mil", "cross_mil.cu", k3_replaces, "cross_mil", xerrs),
              ("diag_epilogue", "diag_epilogue.cu",
               "nafae_tpu/ops/pallas/fused_diag.py:117",   # _fwd_kernel
               "diag", {d: max(x[n] for n in ("ctx", "clu", "d"))
                        for d, x in derrs.items()}),
              ("diag_epilogue_bwd", "diag_epilogue_bwd.cu",
               "nafae_tpu/ops/pallas/fused_diag.py:130",   # _bwd_kernel
               "diag_bwd", {d: max(x["dw"], x["dv"])
                            for d, x in derrs.items()})))],
        "serving": {
            "batch_device_ms": tm["batch_device_ms"],
            "batch_host_ms": tm["batch_host_ms"],
            "frames_per_batch": tm["batch_frames"],
            "frames_per_s_device": tm["frames_per_s_device"],
            "frames_per_s_host": tm["frames_per_s_host"],
            "device_busy_ms": tm["device_busy_ms"],
            "device_idle_share_host": 1.0 - tm["device_busy_ms"]
            / tm["batch_host_ms"]},
        "training": {
            **{k: v for k, v in tt.items()
               if k.startswith(("step_", "frames_per_s")) and
               "kernels" not in k},
            **{"device_idle_share_host" + tag:
               1.0 - tt["step_device_busy_ms" + tag] / tt["step_host_ms" + tag]
               for tag in ("", "_bf16", "_pallas", "_pallas_bf16")},
            **{f"loss_first_last_{route}_{dt}": [
                trained[route][dt]["logs"][0]["loss"],
                trained[route][dt]["logs"][-1]["loss"]]
               for route in ROUTES for dt in TRAIN_STEPS},
            "cpu_rerun": cpu, "pallas_vs_auto": routes},
    }), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
