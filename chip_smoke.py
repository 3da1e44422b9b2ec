#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nafae_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (the kernels are built from `nafae_torch/csrc`
at first use) and nothing else: weights, requests, training data and videos
are made from seeds. Phases, each of which fails loudly (exit code != 0):

1. card: prints the card's name and power limit and torch's CUDA version;
2. build: compiles every kernel source (one nvcc each, all at once) and
   prints the build time and each kernel's registers and spills;
3. kernels against their plain PyTorch versions on the card, at the main
   paths' shapes and at edge shapes, in f32 and bf16: K1f (u), K1fr (u and
   alpha), K1b and K1br (dv_ext against autograd through the plain
   version; E from 4 to 512, R = 1 and 32, w >= T, a centre frame with no
   valid neighbour, an invalid centre frame between valid ones; two
   launches on one f32 input must give bitwise-equal u, alpha and dv),
   CtxMix end to end; the fused cross-MIL K3 (a, and idx where
   the top two scores are clear of ties; R from 1 to 100, M = 1 and 129,
   T = 1, E from 4 to 512, an all-masked frame, a video with no valid
   frame, exact ties across tiles and chunks resolved to the first
   region), the diag epilogue K4f (ctx,
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
7. eval (main path 4): `evaluate_config` under the config1 preset on the
   serving phase's 40 val segments, with the oracle params (equal to the
   server's box accuracy) and with the f32 config-4 checkpoint of phase 5,
   each re-run on the CPU with equal hit counts;
8. times from CUDA events (median of repeated runs after warm-up): each
   kernel, its plain version (and, for K3, the two PyTorch calls of the
   auto route and an empty kernel of its grid, the launch floor; for K1f,
   scaled_dot_product_attention over the (video, frame, offset) batch),
   one full serving batch and one training step of each
   route, with torch.profiler breakdowns;
9. config 5 (main path 5): planted-signal uncompressed AVIs written by the
   port's own writer (32 segments of 4-20 frames at 640x640, 1 fps); on
   the first batch's own detector inputs (320 rows x 24,000 anchors; a
   [320,40,40,1024] map with 20 boxes a frame) the NMS kernel K2 must give
   its plain version's survivors exactly, and the RoIAlign kernel K5 must
   agree with its plain version (f32 and bf16), as on the edge cases (ties,
   duplicates, zero-area boxes, IoU one f32 step either side of 0.7, a row
   of 100,000 boxes, more copies of the top box than K2's largest tier
   (1024 candidates) holds, equal scores across a tier's cut (in a row of
   3,072 boxes and in one of 30,000, past the keys K2 keeps in registers),
   rows exhausted
   beside scores at or below -1e9 (one whose first invalid slot is a box
   below -1e9 that a winner killed), a row shorter than a tier, NaN and
   signed-zero scores; each case prints how many rows took more than one
   tier; dead-slot, off-map and sub-cell boxes, H != W, C = 37,
   a frame of dead boxes, R = 1 and 33, maps staged in row bands and in
   16-channel slices, sampling ratios 1, 3 and 64);
   then `fit` on config5 at full width (ResNet-50, B=16, T=20): 6 steps f32
   with the preset (K2 once a step), 6 with `detector.roi_impl=pallas` (K2
   and K5 once a step) and 6 with a bf16 detector, each lowering the loss
   with exact launch counts; one inline step at 128x128 on the card and on
   the CPU must agree (proposals where clear of score ties, metrics within
   1e-3); `extract_segments` output must load through SegmentDataset and
   equal the inline detector's features at f16 rounding; times of K2 and
   K5 (kernel, plain, bound) and of one config-5 step of each run, with
   the frames' copy, device busy and idle share, and peak memory;
10. config 5 from real-format weights and annotations (main path 6): a
   faster-rcnn.pytorch VGG16 checkpoint, a torchvision resnet50 one, a
   YouCook2 annotation file, a YouCook2-BB box file (phase 9's planted
   boxes) and a GloVe-style vector file, all written from seeds; the VGG16
   checkpoint loaded by the port's converter on the card and on the CPU
   (equal bit for bit); `fit` on config5 with `detector.backbone=vgg16
   detector.weights=<.pth>` at full width: 6 steps with a bf16 detector and
   `detector.roi_impl=pallas` (K2 and K5 once a step) and 4 in f32 at
   B=8 (VGG_F32_CUT) with `model.word_vectors` and
   `loss.kmeans_init=plusplus` (K2 once a step), each lowering the loss
   with exact launch counts; K2 (survivors exactly)
   and K5 (C = 512, f32 and bf16) against their plain versions on the
   first batch's VGG16 inputs; the 128x128 inline VGG16 step on the card
   and on the CPU; `python -m nafae_torch.extract --youcook2-json ...
   --yc2bb-json ... --ckpt <resnet50 .pth>` on the card, its output read
   with ground truth and evaluated (config1) with equal hits on the card
   and CPU; times of K2 and K5 on the VGG16 inputs and of one VGG16
   config-5 step, f32 and bf16, with idle share and peak memory.

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
from dataclasses import replace

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
           "diag_epilogue_bwd", "nms", "roi_align")  # nafae_torch/csrc/<name>.cu
ROUTES = ("auto", "pallas")             # train.kernels of the training runs
# kernel against plain, rtol and atol: the plain version rounds like the
# kernel (bf16 operands, alpha rounded to bf16, f32 sums), so bf16 differs
# only by the order of the sums and an occasional alpha rounded the other way
CTX_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-3, 1e-4)}
# the context mix's cases on the card (B, T, R, E, w, region mask, edges:
# see ctx_inputs); check_ctx_grad adds more narrow E
CTX_CASES = [(16, 20, 20, 256, 3, True, False),    # config4 shapes
             (16, 20, 20, 256, 3, False, False),   # ... without a region mask
             (16, 7, 20, 256, 3, True, False),     # ragged T
             (16, 2, 20, 256, 3, True, False),     # w >= T
             (3, 5, 32, 512, 2, True, False),      # the widest R and E
             (4, 6, 20, 4, 2, True, False),        # E = 4: one slice, 4 columns
             (4, 6, 20, 68, 2, True, False),       # E = 68: 4 columns past 64
             (4, 9, 1, 64, 2, True, False),        # R = 1
             (2, 5, 32, 64, 4, True, False),       # R = 32 at w = 4
             (3, 10, 20, 256, 3, True, True)]      # cnt = 0; an invalid centre
# alpha of K1fr: f32 sums in another order; in bf16 a value may round to
# the neighbouring bf16 number (one ulp is at most 2^-7 relative)
ALPHA_TOL = {"float32": (1e-4, 1e-6), "bfloat16": (1e-2, 1e-6)}
# dv_ext of K1b/K1br against autograd through the plain version: f32 sums
# in another order; in bf16 the kernels round du_n, alpha and ds to bf16 as
# the TPU kernels do, the plain autograd rounds at its casts instead, so
# bf16 takes the reference tests' 2e-2
GRAD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}
# ... except below this E, where bf16 dv's atol is 2e-2 of the largest |dv|
# once that passes 1 (as tests/test_torch_ctx_grad.py holds the TPU kernel):
# ds, scaled up by 1/temp, is rounded before its products, so the error
# follows each sum's largest terms, which grow as E falls (a unit region's
# entries are about 1/2 at E = 4, about 1/16 at E = 256)
GRAD_NARROW_E = 8
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
# config 5 at full width (the preset: ResNet-50 C4/C5, 640x640 frames, 15
# anchors a cell, R=20, D=2048, E=256, K=8, B=16, T=20): planted-signal
# videos of 4-20 frames at 1 fps, and the steps of each run (depth is cut,
# widths are not)
C5_SEGMENTS = 32
C5_FRAMES = (4, 20)
C5_RUNS = {"float32": [], "pallas_roi": ["detector.roi_impl=pallas"],
           "bfloat16": ["detector.dtype=bfloat16"]}
C5_STEPS = {"float32": 6, "pallas_roi": 6, "bfloat16": 6}
C5_TIMED_STEPS = 3
# card against CPU at a reduced size (the CPU cannot run 640x640 in time)
C5_CPU = {"image": 128, "batch": 2, "frames": 4, "segments": 4}
# pixels: cuDNN's and the CPU's f32 convolutions differ by ~1e-6 relative,
# which moves a delta, times a 512-pixel anchor, by ~1e-3 pixel
C5_BOX_TOL = 1e-2
C5_EXTRACT = 3              # segments extracted and held against inline
# phase 10, config 5 from a converted checkpoint: the VGG16 detector at the
# preset's widths (conv5_3 [40,40,512], 15 anchors a cell, R=20, fc6/fc7 ->
# D=4096); per run its overrides and steps (depth is cut, widths are not);
# VGG_SEEDED also seeds word_emb from a vector file and the centers by
# k-means++; VGG_VAL segments form the YouCook2 file's validation subset
VGG_OVERRIDES = ["detector.backbone=vgg16", "detector.rpn_channels=512",
                 "model.feat_dim=4096"]
# the f32 VGG16 step at B=16 needs two 31.25 GiB maps at once (conv1_1's
# and conv1_2's), and the caching allocator's segments, split by the
# tensors a step keeps, do not hold a second one (CUDA out of memory in
# fit, 33.8 GiB allocated and 31.3 GiB reserved but free): f32 training
# runs at B=8; the kernels are still held on the B=16 batch's detector
# inputs (a forward alone fits)
VGG_F32_CUT = ["data.batch_size=8"]
VGG_RUNS = {"bf16_pallas_roi": (["detector.dtype=bfloat16",
                                 "detector.roi_impl=pallas"], 6),
            "float32": (VGG_F32_CUT, 4)}
VGG_SEEDED = "float32"
VGG_VAL = 8
# K5 against plain: the same weights (built in the same f32 order) and f32
# sums in another order: |err| <= rtol·|plain| + atol·max|plain|
K5_TOL = (1e-5, 1e-6)


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


def ctx_inputs(torch, gen, b, t, r, e, w, device, edges=False):
    """l2-normalized regions with random frame and region masks, incl. a
    valid frame whose regions are all invalid (the uniform-alpha group).
    edges (T >= 2w + 4): the last video gets a valid centre frame whose
    every neighbour is invalid (cnt = 0, u = 0) and an invalid centre frame
    between two valid ones."""
    F = torch.nn.functional
    v = torch.randn(b, t, r, e, generator=gen)
    v = v / v.norm(dim=-1, keepdim=True)
    fm = (torch.rand(b, t, generator=gen) > 0.25).float()
    rm = (torch.rand(b, t, r, generator=gen) > 0.3).float()
    fm[:, 0] = 1.0
    fm[0, min(1, t - 1)] = 1.0
    rm[0, min(1, t - 1)] = 0.0
    if edges:
        fm[-1] = 1.0
        fm[-1, :2 * w + 1] = 0.0
        fm[-1, w] = 1.0                   # frame w: no valid neighbour
        fm[-1, 2 * w + 2] = 0.0           # invalid, between valid frames
    return (F.pad(v, (0, 0, 0, 0, w, w)).to(device),
            F.pad(fm, (w, w)).to(device),
            F.pad(rm, (0, 0, w, w)).to(device))


def check_ctx_mix(torch, device) -> dict[str, float]:
    """K1f against its plain version on the card; returns the max |u| error
    per dtype."""
    from nafae_torch.ops.kernels import ctx_mix as K

    gen = torch.Generator().manual_seed(SEED)
    errs = {}
    for dt_name, dt in (("float32", None), ("bfloat16", torch.bfloat16)):
        rtol, atol = CTX_TOL[dt_name]
        worst = 0.0
        for b, t, r, e, w, with_rm, edges in CTX_CASES:
            v_ext, fm_ext, rm_ext = ctx_inputs(torch, gen, b, t, r, e, w,
                                               device, edges)
            rm_ext = rm_ext if with_rm else None
            u, nv = K.ctx_mix(v_ext, fm_ext, w, 0.1, dtype=dt, rm_ext=rm_ext)
            torch.cuda.synchronize()
            up, nvp = K.context_mix_plain(v_ext, fm_ext, w, 0.1, dtype=dt,
                                          rm_ext=rm_ext)
            case = (f"{dt_name} B={b} T={t} R={r} E={e} w={w} rm={with_rm} "
                    f"edges={edges}")
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
            f"(rtol {rtol}, atol {atol}, {len(CTX_CASES)} cases)")
    return errs


def compare_grad_kernels(torch, vc, fm_ext, rm_ext, w, du, dt_name,
                         case) -> dict[str, float]:
    """K1fr (u, alpha), K1b and K1br (dv_ext) on vc (in the compute dtype)
    against the plain version on the same card; fails beyond the limits,
    logs dv's errors beside the largest |dv| and returns the max |error| of
    each (and the largest |dv| as "dv_max")."""
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
    errs = {"dv_max": dvp.abs().max().item()}
    for name, got, want in (("ctx_mix_fwd_res", u, up.detach()),
                            ("alpha", alpha, ap),
                            ("ctx_mix_bwd", dv_rec, dvp),
                            ("ctx_mix_bwd_res", dv_res, dvp)):
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            fail(f"{name} gave non-finite values: {case}")
        rtol, atol = (CTX_TOL if name == "ctx_mix_fwd_res" else
                      ALPHA_TOL if name == "alpha" else GRAD_TOL)[dt_name]
        if (dt is not None and name.startswith("ctx_mix_bwd")
                and vc.shape[-1] < GRAD_NARROW_E):
            atol *= max(1.0, errs["dv_max"])
        errs[name] = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            fail(f"{name} differs from the plain version by {errs[name]} "
                 f"(rtol {rtol}, atol {atol}): {case}")
    log(f"dv, {case}: largest |dv| {errs['dv_max']:.4f}, max |err| K1b "
        f"{errs['ctx_mix_bwd']:.3e}, K1br {errs['ctx_mix_bwd_res']:.3e} "
        f"(atol {atol:.3e})")
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
    cases = CTX_CASES + [
        (4, 6, 20, 12, 3, True, False),     # E within one 64-column slice,
        (4, 6, 20, 36, 2, True, False),     # ... not a multiple of 8
        (4, 6, 20, 100, 2, True, False)]    # a ragged second slice
    errs = {}
    for dt_name, dt in (("float32", None), ("bfloat16", torch.bfloat16)):
        worst = dict.fromkeys(("ctx_mix_fwd_res", "alpha", "ctx_mix_bwd",
                               "ctx_mix_bwd_res"), 0.0)
        for b, t, r, e, w, with_rm, edges in cases:
            v_ext, fm_ext, rm_ext = ctx_inputs(torch, gen, b, t, r, e, w,
                                               device, edges)
            du = torch.randn(b, t, r, e, generator=gen).to(device)
            got = compare_grad_kernels(
                torch, v_ext.to(dt) if dt is not None else v_ext, fm_ext,
                rm_ext if with_rm else None, w, du, dt_name,
                f"{dt_name} B={b} T={t} R={r} E={e} w={w} rm={with_rm} "
                f"edges={edges}")
            worst = {k: max(worst[k], got[k]) for k in worst}
        errs[dt_name] = worst
        log(f"K1fr/K1b/K1br vs plain, {dt_name}: max |err| "
            + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
            + f" (u {CTX_TOL[dt_name]}, alpha {ALPHA_TOL[dt_name]}, dv "
            f"{GRAD_TOL[dt_name]} as rtol, atol, in bf16 below E = "
            f"{GRAD_NARROW_E} atol x largest |dv|; {len(cases)} cases)")

    # f32 u, alpha and dv are the same on every run: no atomics, one order
    # of sums
    v_ext, fm_ext, rm_ext = ctx_inputs(torch, gen, 16, 20, 20, 256, 3, device)
    du = torch.randn(16, 20, 20, 256, generator=gen).to(device)
    runs = [K.launch_fwd(v_ext, fm_ext, 3, 0.1, rm_ext, residual=res)
            for res in (False, False, True, True)]
    torch.cuda.synchronize()
    if not (torch.equal(runs[0][0], runs[1][0])
            and torch.equal(runs[2][0], runs[3][0])
            and torch.equal(runs[2][1], runs[3][1])):
        fail("K1f/K1fr: two launches on the same f32 inputs gave u or alpha "
             "that differ")
    alpha = runs[2][1]
    for name, a in (("ctx_mix_bwd_res", alpha), ("ctx_mix_bwd", None)):
        first = K.launch_bwd(v_ext, fm_ext, 3, 0.1, rm_ext, du, a)
        second = K.launch_bwd(v_ext, fm_ext, 3, 0.1, rm_ext, du, a)
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            fail(f"{name}: two launches on the same f32 inputs gave dv that "
                 "differ")
    log("K1f and K1fr: two launches give bitwise-equal f32 u and alpha; K1br "
        "and K1b: bitwise-equal f32 dv (config4 shapes)")

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


# K3's cases: I, M, T, R, E, region mask?, pairs of regions made equal (the
# first of a pair must win), a video with no valid frame?
CROSS_CASES = [
    (16, 128, 20, 20, 256, True, (), False),     # config4 training
    (16, 128, 20, 40, 256, True, (), False),     # K3a's domain
    (16, 128, 20, 20, 256, False, (), False),    # no region mask
    (3, 40, 7, 33, 64, True, ((8, 16), (0, 32)), False),   # r + 32, last row
    (3, 40, 7, 1, 64, True, (), True),           # R = 1: 80 frames a block
    (3, 40, 7, 7, 64, True, (), True),
    (3, 40, 5, 64, 64, True, ((3, 35), (1, 63)), True),
    (2, 33, 3, 81, 64, True, ((0, 80),), False),           # one past a chunk
    (2, 40, 3, 100, 64, True, ((7, 39), (2, 99), (40, 85)), True),  # 2 chunks
    (3, 1, 7, 20, 256, True, (), False),         # M = 1
    (2, 129, 5, 20, 64, True, (), True),         # one word past two tiles
    (4, 40, 1, 20, 256, True, (), True),         # T = 1
    (2, 40, 5, 20, 512, True, (), False),        # the widest E
    (2, 40, 5, 20, 4, True, (), False),          # the smallest E
    (2, 40, 5, 20, 20, False, ((2, 19),), True),  # E not a multiple of 8
]


def check_cross_mil(torch, device) -> dict[str, float]:
    """K3 against its plain version on the card, on CROSS_CASES: config4's
    training shapes (I=16 videos, M=B·K=128 words, T=20, R=20, E=256), R
    from 1 to 100 (one frame over two chunks of regions), M = 1 and 129,
    T = 1, E from 4 to 512, no region mask, a video with no valid frame,
    and exact ties between regions r and r + 32, r and the last row, and
    across a chunk; each masked case with a valid frame whose regions are
    all masked. Returns the max |a| error per dtype."""
    from nafae_torch.ops.kernels import cross_mil as K3

    gen = torch.Generator().manual_seed(SEED + 2)
    rtol, atol = CROSS_TOL
    errs = {}
    for dt_name, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        worst = 0.0
        for i, m, t, r, e, with_rm, ties, dead_video in CROSS_CASES:
            w = unit_rows(torch, gen, m, e)
            v = unit_rows(torch, gen, i, t, r, e)
            fm, rm = frame_region_masks(torch, gen, i, t, r)
            for first, later in ties:     # duplicate rows: exact ties
                v[:, :, later] = v[:, :, first]
                rm[:, :, later] = rm[:, :, first]
            if dead_video:
                fm[1] = 0.0
            w, v = w.to(dt).to(device), v.to(dt).to(device)
            fm, rm = fm.to(device), rm.to(device) if with_rm else None
            case = (f"{dt_name} I={i} M={m} T={t} R={r} E={e} rm={with_rm} "
                    f"ties={ties} dead_video={dead_video}")
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
            if any((idx == later).any() for _, later in ties):
                fail(f"cross_mil resolved an exact tie to the later region: "
                     f"{case}")
            if with_rm and not ((a[0, :, 0] == K3.NEG).all()
                                and (idx[0, :, 0] == 0).all()):
                fail(f"cross_mil: an all-masked valid frame must give -1e9 "
                     f"and idx 0: {case}")
            if dead_video and not (a[1] == 0).all():
                fail(f"cross_mil: a video with no valid frame must give 0: "
                     f"{case}")
            worst = max(worst, err)
        errs[dt_name] = worst
        log(f"cross_mil vs plain, {dt_name}: max |a err| {worst:.3e} (rtol "
            f"{rtol}, atol {atol}; idx equal where the top two differ by > "
            f"{TIE_GAP}, exact ties to the first region; {len(CROSS_CASES)} "
            f"cases)")
    return errs


def compare_diag(torch, w, v, u, centers, fm, hc, rm, case, later_r=(),
                 later_c=(), dead_video=False) -> dict[str, float]:
    """K4f and K4b against their plain versions on one input (K4b on K4f's
    residuals, with random cotangents); each launched twice, the two
    launches equal bit for bit. later_r / later_c: the later indices of
    exact ties (never picked); dead_video: video 1 has no valid frame (no
    ctx term). Returns the max |error| of each output."""
    from nafae_torch.ops.grounding import l2_normalize
    from nafae_torch.ops.kernels import diag as K4

    got = K4.launch_fwd(w, v, u, centers, fm, hc, rm)
    again = K4.launch_fwd(w, v, u, centers, fm, hc, rm)
    torch.cuda.synchronize()
    if not all(torch.equal(a, g) for a, g in zip(again, got)):
        fail(f"diag_epilogue: two launches on one input differ: {case}")
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
    if any((rstar == x).any() for x in later_r) \
            or any((cstar == x).any() for x in later_c):
        fail(f"diag_epilogue resolved an exact tie to the later index: {case}")
    if dead_video and ((ctx[1] != 0).any() or (d[1] != 0).any()):
        fail(f"diag_epilogue: a video with no valid frame must give ctx = 0 "
             f"and d = 0: {case}")
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
    dw2, dv2 = K4.launch_bwd(w, v, centers, d, rstar, cstar, f, dctx, dclu)
    torch.cuda.synchronize()
    if not (torch.equal(dw, dw2) and torch.equal(dv, dv2)):
        fail(f"diag_epilogue_bwd: two launches on one input differ: {case}")
    pdw, pdv = K4.diag_bwd_plain(w, v, centers, d, rstar, cstar, f, dctx,
                                 dclu)
    for name, g, wnt in (("dw", dw, pdw), ("dv", dv, pdv)):
        errs[name] = (g - wnt).abs().max().item()
        if not torch.isfinite(g).all() or not torch.allclose(
                g, wnt, rtol=rtol, atol=atol):
            fail(f"diag_epilogue_bwd {name} differs from the plain version "
                 f"by {errs[name]} (rtol {rtol}, atol {atol}): {case}")
    return errs


# K4f/K4b's cases: B, K, T, R, E, Kc, region mask?, the later index of each
# exact region tie and of each exact center tie (the earlier must win), a
# video with no valid frame?
DIAG_CASES = [
    (16, 8, 20, 20, 256, 67, True, (), (), False),     # config4 training
    (4, 7, 9, 40, 256, 67, True, ((8, 16),), ((2, 5),), False),
    (4, 8, 20, 20, 256, 67, False, (), (), False),     # no region mask
    (4, 1, 9, 20, 256, 67, True, (), (), False),       # K = 1
    (2, 32, 5, 20, 512, 67, True, (), (), False),      # K = 32 at E = 512
    (2, 32, 5, 20, 256, 67, True, (), (), False),      # the most shared memory
    (4, 8, 9, 20, 4, 67, True, (), (), False),         # the smallest E
    (4, 8, 9, 1, 256, 67, True, (), (), True),         # R = 1
    (4, 8, 9, 33, 256, 67, True, (), (), False),       # one past a chunk
    (4, 8, 9, 20, 256, 1, True, (), (), False),        # Kc = 1
    (4, 8, 9, 20, 256, 130, True, (), (), False),      # Kc = 130
    (4, 8, 1, 20, 256, 67, True, (), (), False),       # T = 1
    (4, 8, 9, 40, 256, 67, True, ((3, 35),), ((3, 35),), True),  # across 32
]


def check_diag(torch, device) -> dict[str, dict[str, float]]:
    """K4f and K4b against their plain versions on the card, on DIAG_CASES:
    config4's shapes (B=16, K=8, T=20, R=20, E=256, Kc=67), no region mask,
    K from 1 to 32 (at E = 256 and 512), E from 4 to 512, R from 1 to 40 (one past a chunk of 32
    regions), Kc from 1 to 130, T = 1, exact ties between regions and
    between centers (8 and 16, 2 and 5; 3 and 35, across 32) and a video
    with no valid frame; each masked case with a valid frame whose regions
    are all masked and frames without context. Every launch is repeated and
    must give the same bits. Returns the max errors by output and dtype."""
    gen = torch.Generator().manual_seed(SEED + 3)
    errs = {}
    for dt_name, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        worst: dict[str, float] = {}
        for b, k, t, r, e, kc, with_rm, ties_r, ties_c, dead in DIAG_CASES:
            w = unit_rows(torch, gen, b, k, e)
            v = unit_rows(torch, gen, b, t, r, e)
            u = 0.5 * torch.randn(b, t, r, e, generator=gen)
            centers = unit_rows(torch, gen, kc, e)
            fm, rm = frame_region_masks(torch, gen, b, t, r)
            hc = (torch.rand(b, t, generator=gen) > 0.2).float()
            for first, later in ties_r:       # duplicate rows: exact ties
                v[:, :, later] = v[:, :, first]
                rm[:, :, later] = rm[:, :, first]
            for first, later in ties_c:
                centers[later] = centers[first]
            if dead:
                fm[1] = 0.0
            got = compare_diag(
                torch, *(x.to(dt).to(device) for x in (w, v, u)),
                *(x.to(device) for x in (centers, fm, hc)),
                rm.to(device) if with_rm else None,
                f"{dt_name} B={b} K={k} T={t} R={r} E={e} Kc={kc} "
                f"rm={with_rm} ties={ties_r}/{ties_c} dead_video={dead}",
                [x for _, x in ties_r], [x for _, x in ties_c], dead)
            worst = {n: max(worst.get(n, 0.0), got.get(n, 0.0))
                     for n in {**worst, **got}}
        errs[dt_name] = worst
        log(f"diag_epilogue (K4f) / diag_epilogue_bwd (K4b) vs plain, "
            f"{dt_name}: max |err| " + ", ".join(
                f"{n} {int(x)}" if n.endswith("other_way") else
                f"{n} {x:.3e}" for n, x in sorted(worst.items()))
            + f" ({DIAG_TOL} as rtol, atol, ctx against plain plus its "
            f"terms rounded the other way; r*, f, c* equal where clear of "
            f"ties, exact ties to the first index; every launch twice, "
            f"equal bit for bit; {len(DIAG_CASES)} cases)")
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
    from nafae_torch.ops.kernels import cross_mil, ctx_mix, diag, nms, \
        roi_align

    return ctx_mix, cross_mil, diag, nms, roi_align


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


# ------------------------------------------------------------- eval


def eval_cfg(root: str, ckpt: str):
    from nafae_torch.config import load_config

    return load_config(preset_name="config1", overrides=[
        f"data.root={root}", f"train.ckpt_dir={ckpt}"])


def eval_near_ties(torch, cfg, params) -> int:
    """Annotated (word, frame) pairs whose top two region scores on the CPU
    are within TIE_GAP: their argmax may go either way on another device."""
    from nafae_torch.data.loader import BatchLoader
    from nafae_torch.data.youcook2 import SegmentDataset
    from nafae_torch.evaluate import masked_scores

    ds = SegmentDataset(cfg.data.root, "val", cfg.data.max_frames,
                        cfg.data.num_regions, cfg.data.feat_dim,
                        cfg.data.max_words, with_gt=True)
    params = {k: torch.as_tensor(v).cpu() for k, v in params.items()}
    near = 0
    for batch in BatchLoader(ds, cfg.data.batch_size, shuffle=False,
                             drop_remainder=False):
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        top2 = masked_scores(params, tb).topk(2, dim=-1).values
        near += int(((top2[..., 0] - top2[..., 1] <= TIE_GAP)
                     & (tb["gt_mask"] > 0)).sum())
    return near


def check_eval(torch, root: str, tmp: str, served_acc: float) -> dict:
    """The eval path (main path 4): `evaluate_config` under the config1
    preset, on the card, over the val split (written here if the data has
    none), first with the planted-signal oracle params (its micro accuracy
    must equal the f32 server's box accuracy on the same segments), then on
    the config-4 state that the f32 auto training run checkpointed, restored
    from its directory; both re-run on the CPU, where num_annotations and
    the hit counts must be equal (a pair whose top two scores are within
    TIE_GAP may go either way). Eval launches no kernel of the port."""
    from nafae_torch.evaluate import evaluate_config
    from nafae_torch.utils.checkpoint import load_eval_params

    if not os.path.exists(os.path.join(root, "val", "index.jsonl")):
        make_requests(root)
    ckpt = os.path.join(tmp, f"ck_{ROUTES[0]}_float32")
    cfg = eval_cfg(root, ckpt)
    out = {}
    for name, params in (("oracle", oracle_params()), ("trained", None)):
        zero_counts()                           # eval starts here
        t0 = time.perf_counter()
        card = evaluate_config(cfg, params=params, require_checkpoint=True,
                               device="cuda")
        wall = time.perf_counter() - t0
        counts = read_counts()                  # ... and ends here
        if any(counts.values()):
            fail(f"eval launched {counts}; it runs no kernel of the port")
        cpu = evaluate_config(cfg, params=params, require_checkpoint=True,
                              device="cpu")
        hits = {d: round(r["box_acc_micro"] * r["num_annotations"])
                for d, r in (("card", card), ("cpu", cpu))}
        if card["num_annotations"] != cpu["num_annotations"]:
            fail(f"eval ({name}): num_annotations {card['num_annotations']} "
                 f"on the card, {cpu['num_annotations']} on the CPU")
        near = 0
        if hits["card"] != hits["cpu"]:
            near = eval_near_ties(torch, cfg, params if params is not None
                                  else load_eval_params(cfg, device="cpu"))
            if abs(hits["card"] - hits["cpu"]) > near:
                fail(f"eval ({name}): {hits['card']} hits on the card, "
                     f"{hits['cpu']} on the CPU, {near} near ties")
        if not all(np.isfinite(card[k]) for k in ("box_acc_micro",
                                                  "box_acc_macro")):
            fail(f"eval ({name}) gave non-finite accuracies: {card}")
        out[name] = {"card": {k: v for k, v in card.items()
                              if k != "per_class_acc"},
                     "hits": hits, "near_ties": near, "wall_s": wall}
        log(f"eval ({name} params, config1 preset, {card['num_annotations']} "
            f"annotations): box accuracy micro {card['box_acc_micro']:.6f}, "
            f"macro {card['box_acc_macro']:.6f} on the card in {wall:.2f} s; "
            f"hits card {hits['card']} / CPU {hits['cpu']}")
    if abs(out["oracle"]["card"]["box_acc_micro"] - served_acc) > 1e-12:
        fail(f"eval of the oracle params {out['oracle']['card']} differs from "
             f"the server's box accuracy {served_acc}")
    return out


# ------------------------------------------------------------- config 5


def write_c5_videos(root: str, n: int, size: int, seed: int) -> str:
    """Planted-signal videos (uncompressed AVI at 1 fps, written with the
    port's own writer) and their segments.jsonl: each segment names 1-8
    object classes, and each of its 4-20 frames shows a fixed texture of
    each named class at a random place on a blocky background. The planted
    boxes go beside it, as boxes_<size>.json: {segment id: {class: [[x1,
    y1, x2, y2] a frame]}}."""
    from nafae_torch.data.avi import write_avi
    from nafae_torch.data.vocab import DEFAULT_CLASSES

    rng = np.random.RandomState(seed)
    patch = size // 10
    tex = np.repeat(np.repeat(rng.randint(0, 256, (len(DEFAULT_CLASSES), 8, 8,
                                                    3)), patch // 8 + 1, 1),
                    patch // 8 + 1, 2)[:, :patch, :patch].astype(np.uint8)
    lines, planted = [], {}
    for i in range(n):
        t = int(rng.randint(C5_FRAMES[0], C5_FRAMES[1] + 1))
        classes = rng.choice(len(DEFAULT_CLASSES), int(rng.randint(1, 9)),
                             replace=False)
        cell = -(-size // 20)
        base = np.repeat(np.repeat(rng.randint(60, 196, (20, 20, 3)), cell, 0),
                         cell, 1)[:size, :size].astype(np.uint8)
        frames = []
        boxes = {DEFAULT_CLASSES[c]: [] for c in classes}
        for _ in range(t):
            f = base.copy()
            for c in classes:
                y, x = rng.randint(0, size - patch, 2)
                f[y:y + patch, x:x + patch] = tex[c]
                boxes[DEFAULT_CLASSES[c]].append(
                    [int(x), int(y), int(x + patch), int(y + patch)])
            frames.append(f)
        planted[f"c5_{size}_{i:02d}"] = boxes
        path = os.path.join(root, f"c5_{size}_{i:02d}.avi")
        write_avi(path, frames, 1.0)
        words = " and ".join(DEFAULT_CLASSES[c].replace("_", " ")
                             for c in classes)
        lines.append(json.dumps({"id": f"c5_{size}_{i:02d}", "video": path,
                                 "sentence": f"add the {words}",
                                 "split": "train"}))
    ann = os.path.join(root, f"segments_{size}.jsonl")
    with open(ann, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, f"boxes_{size}.json"), "w") as f:
        json.dump(planted, f)
    return ann


def c5_cfg(ann: str, ckpt: str, run: str, steps: int, extra=()):
    from nafae_torch.config import load_config

    return load_config(preset_name="config5", overrides=TRAIN_OVERRIDES + [
        "data.from_videos=true", f"data.annotations={ann}",
        f"train.ckpt_dir={ckpt}", f"train.steps={steps}",
        *C5_RUNS[run], *extra])


def c5_first_batch(cfg):
    """The first batch (numpy) of fit's loader on the videos."""
    from nafae_torch.data.loader import BatchLoader
    from nafae_torch.data.video_dataset import VideoSegmentDataset
    from nafae_torch.data.vocab import vocab_from_config

    ds = VideoSegmentDataset(cfg.data.annotations, cfg.data.max_frames,
                             cfg.detector.image_size, cfg.data.max_words,
                             frame_rate=cfg.detector.frame_rate,
                             vocab=vocab_from_config(cfg.data))
    return next(iter(BatchLoader(ds, cfg.data.batch_size, shuffle=True,
                                 seed=cfg.train.seed)))


def c5_detector(torch, cfg, device="cuda"):
    """The detector fit builds for cfg (random weights from train.seed)."""
    from nafae_torch.models.detector.faster_rcnn import init_detector

    return init_detector(cfg.detector,
                         torch.Generator().manual_seed(cfg.train.seed),
                         device=device)


def detector_inputs(torch, model, frames):
    """What the detector hands its two kernels on these frames [N,S,S,3]:
    the decoded coordinate planes and objectness [N, h·w·A] of K2, and the
    feature map [N,h,w,C] and NMS boxes [N,R,4] of K5."""
    from nafae_torch.models.detector.anchors import decode_delta_planes
    from nafae_torch.models.detector.rpn import select_proposals_batched

    cfg = model.cfg
    with torch.no_grad():
        feat = model.backbone(frames)
        b, fh, fw, _ = feat.shape
        anchors = model.anchors(fh, fw, feat.device)
        obj, raw = model.rpn(feat, raw=True)
        d = [raw[..., c::4].reshape(b, -1) for c in range(4)]
        planes = [p.contiguous() for p in
                  decode_delta_planes(anchors, *d, cfg.image_size)]
        boxes, _, _ = select_proposals_batched(
            obj, None, anchors, cfg.image_size, cfg.rpn_pre_nms_topk,
            cfg.num_proposals, cfg.nms_iou_thresh, nms_impl="pallas",
            topk_impl="none", deltas_raw=raw)
    return planes, obj.contiguous(), feat, boxes.contiguous()


def nms_edge_cases(torch, gen):
    """(name, boxes [B,N,4], scores, iou) rows as the CPU tests build them:
    ties of equal score, duplicate boxes, zero-area boxes, rows with fewer
    survivors than 20, boxes one f32 step either side of IoU 0.7, one row
    of N = 100,000; and the edges of the kernel's tiers: more copies of the
    top box than a tier holds, equal scores straddling a tier's last
    candidate (in a short row and in one longer than the keys the kernel
    keeps in registers), rows that exhaust beside scores at, below -1e9 and
    -inf (one whose first invalid slot is not index 0), a row shorter than
    a tier, NaN and signed-zero scores."""
    from nafae_torch.ops.kernels import nms as K2

    def rand(b, n, size=80.0):
        xy = torch.rand(b, n, 2, generator=gen) * size
        wh = torch.rand(b, n, 2, generator=gen) * 40 + 2
        return torch.cat([xy, xy + wh], -1), torch.rand(b, n, generator=gen)

    cases = []
    bx, sc = rand(3, 60)
    cases.append(("ties", bx, torch.round(sc * 4) / 4, 0.5))
    bx, sc = rand(3, 40)
    bx[:, 10:20] = bx[:, :10]
    bx[:, 20:25], sc[:, 20:25] = bx[:, :5], sc[:, :5]
    cases.append(("duplicates", bx, sc, 0.5))
    bx, sc = rand(2, 30)
    bx[:, ::3, 2] = bx[:, ::3, 0]
    bx[:, 1::5, 3] = bx[:, 1::5, 1]
    bx[1] = 0.0
    cases.append(("zero_area", bx, sc, 0.5))
    bx = torch.tensor([10.0, 10, 50, 50]).repeat(2, 12, 1) \
        + torch.rand(2, 12, 4, generator=gen) * 0.5
    bx[0, 6:] += 100.0
    cases.append(("few_survivors", bx, torch.rand(2, 12, generator=gen), 0.5))
    seven = torch.tensor(7.0)
    hs = [torch.nextafter(seven, torch.tensor(0.0)), seven,
          torch.nextafter(seven, torch.tensor(20.0))]
    bx = torch.zeros(3, 6, 4)
    for r, h in enumerate(hs):
        bx[r, 0] = torch.tensor([0.0, 0, 10, 10])
        bx[r, 1] = torch.stack([torch.tensor(0.0), torch.tensor(0.0),
                                torch.tensor(10.0), h])
        for j in range(2, 6):
            bx[r, j] = torch.tensor([30.0 * j, 30 * j, 30 * j + 5, 30 * j + 5])
    cases.append(("threshold", bx, torch.tensor(
        [[0.9, 0.8, 0.5, 0.4, 0.3, 0.2]]).repeat(3, 1), 0.7))
    bx, sc = rand(1, 100_000, size=600.0)
    cases.append(("N=100000", bx, sc, 0.7))
    # the edges of the kernel's tiered walk (TIER_BOXES candidates a tier)
    tier = K2.TIER_BOXES
    n = tier + 476
    bx, sc = rand(2, n, size=300.0)
    at = torch.randperm(n, generator=gen)[:tier + 76]
    bx[:, at] = bx[:, at[:1]]
    sc[:, at] = 2.0
    cases.append(("over-tier duplicates", bx, sc, 0.7))
    n = 3 * tier
    bx, sc = rand(2, n, size=300.0)
    tied = torch.randperm(n, generator=gen)[:tier + 100]
    bx[:, tied] = bx[:, tied[torch.randint(0, 10, (tied.numel(),),
                                           generator=gen)]]
    sc[:, tied] = 1.5
    cases.append(("ties at the tier's cut", bx, sc, 0.7))
    n = 30_000                # past the keys a block keeps in registers
    bx, sc = rand(1, n, size=600.0)
    tied = torch.randperm(n, generator=gen)[:tier + 76]
    bx[:, tied] = bx[:, tied[torch.randint(0, 10, (tied.numel(),),
                                           generator=gen)]]
    sc[:, tied] = 1.5
    cases.append(("long row, ties at the tier's cut", bx, sc, 0.7))
    bx, sc = rand(4, 40)
    sc[0, 5:] = -1e9
    sc[1] = -2e9
    sc[1, 0] = -1e9
    sc[2, 1::2] = -float("inf")
    sc[2, 2::4] = -3e9
    sc[3] = -5e9
    sc[3, 7] = -1e9
    sc[3, 11:14] = 0.5
    bx[3, 2] = bx[3, 11]     # killed by winner 11: reads -1e9, before box 7
    cases.append(("exhausted beside scores <= -1e9", bx, sc, 0.5))
    xy = torch.rand(5, 2, generator=gen)[torch.randint(
        0, 5, (2, 400), generator=gen)] * 500 + torch.rand(2, 400, 2,
                                                           generator=gen)
    cases.append(("N=400 < tier", torch.cat([xy, xy + 60], -1),
                  torch.rand(2, 400, generator=gen), 0.7))
    bx, sc = rand(2, 50)
    sc[0, ::3] = float("nan")
    sc[1, ::2] = 0.0
    sc[1, 1::4] = -0.0
    cases.append(("NaN and signed-zero scores", bx, sc, 0.5))
    return cases


def check_nms(torch, planes, scores) -> dict:
    """K2 against its plain version on the card: the config-5 detector's
    own planes (320 rows x 24,000 anchors, num_keep 20), then the edge
    cases; survivors (idx and valid) must be exactly equal."""
    gen = torch.Generator().manual_seed(SEED + 6)
    cases = [("config5 detector", *planes, scores, 0.7)]
    for name, bx, sc, iou in nms_edge_cases(torch, gen):
        bx, sc = bx.cuda(), sc.cuda()
        cases.append((name, *(bx[..., c].contiguous() for c in range(4)),
                      sc.contiguous(), iou))
    kept, cont, worst = {}, {}, 0.0
    for name, *planes_i, sc, iou in cases:
        err, kept[name], cont[name] = nms_vs_plain(torch, name, *planes_i,
                                                   sc, iou)
        worst = max(worst, err)
    for name in ("over-tier duplicates", "ties at the tier's cut",
                 "long row, ties at the tier's cut"):
        if cont[name] == 0:
            fail(f"nms case {name!r} was built to take a second tier; no "
                 "row did")
    log(f"nms (K2) vs plain: survivors exactly equal in all {len(cases)} "
        f"cases (valid slots: {kept}; rows that took the continuation, "
        f"more than one tier: {cont})")
    return {"cases": len(cases), "valid_slots": kept,
            "continuation_rows": cont, "max_abs_err": worst}


def nms_vs_plain(torch, name, x1, y1, x2, y2, sc,
                 iou) -> tuple[float, int, int]:
    """K2 and its plain version (num_keep 20) on one case: fails unless
    idx and valid are exactly equal; returns (max |kernel - plain| over
    idx and valid, valid slots, rows that took more than one tier)."""
    from nafae_torch.ops import nms as P
    from nafae_torch.ops.kernels import nms as K2

    tiers = torch.zeros(sc.shape[0], dtype=torch.int32, device=sc.device)
    gi, gv = K2.launch(x1, y1, x2, y2, sc, 20, iou, tiers=tiers)
    torch.cuda.synchronize()
    pi, pv = P.nms_planes(x1, y1, x2, y2, sc, 20, iou)
    bad = int(((gi != pi) | (gv != pv)).sum())
    if bad:
        fail(f"nms kernel differs from the plain version in {bad} "
             f"slots: {name} [{sc.shape[0]}, {sc.shape[1]}]")
    err = 0.0
    if gi.numel():
        err = float(max((gi - pi).abs().max().item(),
                        (gv - pv).abs().max().item()))
    return err, int(gv.sum().item()), int((tiers > 1).sum().item())


def roi_edge_cases(torch, gen):
    """(name, feat, boxes, scale, sampling ratio): edge boxes (the all-zero
    boxes of dead NMS slots, off the map, smaller than a cell, the whole
    map, a line) on H != W maps with C = 37 and C = 33; a frame whose boxes
    are all dead; the whole map next to sub-cell boxes; R = 1 and R = 33;
    the config-5 map's width (C = 1024, 40 x 40); maps staged in bands of
    rows (200 x 136) and in slices of 16 channels (a row of 2048 columns);
    sampling ratios 1, 3 and 64 (the last takes the boxes in groups)."""
    def edge(h, w, scale):
        H, W = h / scale, w / scale
        return torch.tensor([[0, 0, 0, 0], [-40, -30, 5, 6],
                             [W - 4, H - 3, W + 50, H + 70],
                             [-100, -100, -50, -60], [3.1, 3.1, 3.3, 3.2],
                             [0, 0, W, H], [7.5, 2.0, 7.5, 20.0]])

    def rand(f, r, h, w, scale):
        size = torch.tensor([w / scale, h / scale])
        xy = torch.rand(f, r, 2, generator=gen) * size * 0.8
        wh = torch.rand(f, r, 2, generator=gen) * size * 0.6 + 2
        return torch.cat([xy, xy + wh], -1)

    out = []
    for f, h, w, c, scale in ((3, 9, 16, 37, 0.25), (2, 40, 24, 33, 1 / 16)):
        feat = torch.randn(f, h, w, c, generator=gen)
        out.append((f"edge boxes H={h} W={w} C={c}", feat,
                    edge(h, w, scale).repeat(f, 1, 1), scale, 2))
    bx = rand(2, 6, 12, 12, 0.5)
    bx[0] = 0.0
    out.append(("a frame of dead boxes", torch.randn(2, 12, 12, 64,
                                                     generator=gen), bx, 0.5, 2))
    bx = torch.tensor([[0.0, 0, 640, 640]] + [
        [x, y, x + 3.0, y + 2.0] for x, y in ((5, 7), (300, 20), (630, 630),
                                              (17, 333), (0, 0))])
    out.append(("the whole map beside sub-cell boxes",
                torch.randn(1, 40, 40, 64, generator=gen), bx[None], 1 / 16, 2))
    for r in (1, 33):
        out.append((f"R={r}", torch.randn(2, 20, 24, 40, generator=gen),
                    rand(2, r, 20, 24, 0.25), 0.25, 2))
    out.append(("C=1024 H=W=40", torch.randn(1, 40, 40, 1024, generator=gen),
                rand(1, 20, 40, 40, 1 / 16), 1 / 16, 2))
    bx = rand(1, 9, 200, 136, 0.125)
    bx[0, 0] = torch.tensor([0.0, 0, 136 / 0.125, 200 / 0.125])
    out.append(("row bands H=200 W=136 C=64",
                torch.randn(1, 200, 136, 64, generator=gen), bx, 0.125, 2))
    bx = rand(1, 5, 3, 2048, 1.0)
    bx[0, 0] = torch.tensor([0.0, 0, 2048, 3])
    out.append(("a row of 2048 columns C=20",
                torch.randn(1, 3, 2048, 20, generator=gen), bx, 1.0, 2))
    for sr in (1, 3):
        out.append((f"sampling ratio {sr}",
                    torch.randn(2, 14, 10, 36, generator=gen),
                    rand(2, 8, 14, 10, 0.5), 0.5, sr))
    bx = rand(1, 20, 130, 130, 1.0)
    bx[0, 0] = torch.tensor([0.0, 0, 130, 130])
    out.append(("sampling ratio 64, boxes in groups",
                torch.randn(1, 130, 130, 8, generator=gen), bx, 1.0, 64))
    return out


def k5_close(torch, got, want):
    """|kernel - plain| <= rtol·|plain| + atol·max|plain| (K5_TOL)."""
    rtol, atol = K5_TOL
    lim = rtol * want.abs() + atol * want.abs().max()
    return bool(((got - want).abs() <= lim).all())


def roi_vs_plain(torch, name, feat, boxes, scale, sr=2) -> float:
    """K5 and its plain version on one case: fails on a non-finite value or
    beyond K5_TOL; returns max |kernel - plain|."""
    from nafae_torch.ops.kernels import roi_align as K5

    got = K5.launch(feat, boxes, scale, sr)
    torch.cuda.synchronize()
    want = K5.roi_align_plain(feat, boxes, 7, scale, sr)
    if not torch.isfinite(got).all():
        fail(f"roi_align kernel gave non-finite values: {name}")
    err = (got - want).abs().max().item()
    if not k5_close(torch, got, want):
        fail(f"roi_align kernel differs from the plain version by {err} "
             f"(rtol {K5_TOL[0]}, atol {K5_TOL[1]} x largest |plain|): {name}")
    return err


def check_roi_align(torch, feat, boxes) -> dict:
    """K5 against its plain version on the card, f32 and bf16 features: the
    config-5 detector's own map [320,40,40,1024] with its 20 NMS boxes a
    frame, then the edge cases. Returns the max |error| per dtype."""
    gen = torch.Generator().manual_seed(SEED + 7)
    cases = [("config5 detector", feat, boxes, 1 / 16, 2)]
    cases += [(n, f.cuda(), b.cuda(), s, sr)
              for n, f, b, s, sr in roi_edge_cases(torch, gen)]
    errs = {}
    for dt_name, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        errs[dt_name] = max(
            roi_vs_plain(torch, f"{dt_name} {name}", f.to(dt).contiguous(), b,
                         scale, sr) for name, f, b, scale, sr in cases)
        log(f"roi_align (K5) vs plain, {dt_name}: max |err| "
            f"{errs[dt_name]:.3e} "
            f"(rtol {K5_TOL[0]}, atol {K5_TOL[1]} x largest |plain|; "
            f"{len(cases)} cases)")
    return errs


def c5_launches(cfg) -> dict[str, int]:
    """Launches of each kernel in one config-5 step of cfg: K1fr and K1br,
    K2, and K5 with detector.roi_impl=pallas."""
    want = per_step_launches("auto")
    want["nms"] = 1
    want["roi_align"] = 1 if cfg.detector.roi_impl == "pallas" else 0
    return want


def train_c5(torch, ann: str, tmp: str, runs=None, tag: str = "") -> dict:
    """Config-5 training at full width through fit, one run each of `runs`
    ({name: (overrides, steps)}; by default C5_RUNS for C5_STEPS), each
    read with the launch counts zeroed just before it."""
    out = {}
    runs = runs or {run: (C5_RUNS[run], steps)
                    for run, steps in C5_STEPS.items()}
    for run, (extra, steps) in runs.items():
        cfg = c5_cfg(ann, os.path.join(tmp, f"ck5{tag}_{run}"), "float32",
                     steps, extra)
        label = f"{tag.strip('_')} {run}".strip()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()                           # main path starts here
        t0 = time.perf_counter()
        logs = run_fit(torch, cfg)
        wall = time.perf_counter() - t0
        counts = read_counts()                  # ... and ends here
        want = {k: n * steps for k, n in c5_launches(cfg).items()}
        if counts != want:
            fail(f"config-5 training ({label}) launched {counts}, "
                 f"expected {want}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        first = statistics.mean(m["loss"] for m in logs[:2])
        last = statistics.mean(m["loss"] for m in logs[-2:])
        log(f"trained config5 {steps} steps ({label}: "
            f"{cfg.detector.backbone} detector {cfg.detector.dtype}, "
            f"weights {os.path.basename(cfg.detector.weights) or 'random'}, "
            f"word_vectors {bool(cfg.model.word_vectors)}, kmeans_init "
            f"{cfg.loss.kmeans_init}, roi_impl {cfg.detector.roi_impl}, "
            f"nms_impl {cfg.detector.nms_impl}) in {wall:.2f} s incl. "
            f"set-up: loss {logs[0]['loss']:.5f} -> {logs[-1]['loss']:.5f} "
            f"(mean of first 2 {first:.5f}, last 2 {last:.5f}); launches "
            f"{counts}; peak device memory {peak:.2f} GiB")
        if not last < first:
            fail(f"config-5 training ({label}) did not lower the loss: "
                 f"{first} -> {last}")
        out[run] = {"logs": logs, "launches": counts, "peak_gib": peak,
                    "wall_s": wall}
    return out


def check_c5_cpu(torch, ann_small: str, tmp: str, extra=()) -> dict:
    """One inline config-5 step at a reduced image size (C5_CPU) on the card
    and on the CPU: the same frames, detector weights and initial state
    (`extra`: more overrides, the VGG16 detector's). Proposals must agree
    where a frame's surviving scores are clear of ties (boxes within
    C5_BOX_TOL pixels), the metrics within CPU_METRIC_TOL."""
    from nafae_torch.train import TrainState, batch_to_device, train_step

    cfg = c5_cfg(ann_small, os.path.join(tmp, "ck5_cpu"), "float32", 1,
                 [f"detector.image_size={C5_CPU['image']}",
                  f"data.batch_size={C5_CPU['batch']}",
                  f"data.max_frames={C5_CPU['frames']}", *extra])
    batch = c5_first_batch(cfg)
    cpu_det = c5_detector(torch, cfg, "cpu")
    gpu_det = c5_detector(torch, cfg, "cuda")
    res, metrics = {}, {}
    for dev, det in (("cuda", gpu_det), ("cpu", cpu_det)):
        tb = batch_to_device(batch, torch.device(dev))
        frames = tb["frames"].reshape((-1,) + tb["frames"].shape[2:])
        res[dev] = {k: v.cpu() for k, v in det(frames).items()}
        _, m = train_step(TrainState.create(cfg, device=dev), tb, cfg,
                          extractor=det)
        metrics[dev] = {k: float(v) for k, v in m.items()}
    valid_equal = torch.equal(res["cuda"]["region_valid"],
                              res["cpu"]["region_valid"])
    sc, rv = res["cpu"]["scores"], res["cpu"]["region_valid"]
    live = torch.where(rv > 0, sc, torch.full_like(sc, float("nan")))
    srt = torch.sort(live, dim=-1).values
    gaps = torch.nan_to_num(srt[:, 1:] - srt[:, :-1], nan=1.0)
    clear = (gaps > TIE_GAP).all(-1)
    box_err = (res["cuda"]["boxes"] - res["cpu"]["boxes"]).abs()[clear]
    box_err = box_err.max().item() if box_err.numel() else 0.0
    if not clear.any():
        fail("card vs CPU: no frame's proposals are clear of ties")
    if not torch.equal(res["cuda"]["region_valid"][clear], rv[clear]) \
            or box_err > C5_BOX_TOL:
        fail(f"card vs CPU: proposals differ where clear of ties (boxes by "
             f"{box_err} px)")
    rtol, atol = CPU_METRIC_TOL
    worst = 0.0
    for k, c in metrics["cpu"].items():
        g = metrics["cuda"][k]
        if not np.isclose(g, c, rtol=rtol, atol=atol):
            fail(f"config-5 step {k}: card {g} vs CPU {c}")
        worst = max(worst, abs(g - c) / max(abs(c), 1e-30))
    feat_err = (res["cuda"]["feats"] - res["cpu"]["feats"])[clear].abs().max()
    log(f"config-5 card vs CPU ({cfg.detector.backbone}) at image_size "
        f"{C5_CPU['image']}, B="
        f"{C5_CPU['batch']}, T={C5_CPU['frames']}: {int(clear.sum())} of "
        f"{clear.numel()} frames clear of score ties, region_valid equal "
        f"{valid_equal} (where clear: yes), boxes within {box_err:.3e} px "
        f"(limit {C5_BOX_TOL}), feats within {feat_err.item():.3e}; step "
        f"metrics max relative diff {worst:.3e} (limit rtol {rtol}, atol "
        f"{atol})")
    return {"frames_clear": int(clear.sum()), "frames": clear.numel(),
            "box_abs_diff": box_err, "metric_rel_diff": worst,
            "region_valid_equal": valid_equal}


def check_c5_extract(torch, ann: str, tmp: str) -> dict:
    """extract_segments on C5_EXTRACT segments with the f32 run's detector:
    the files load through SegmentDataset and their f16 feats equal the
    inline detector's feats of the same frames at f16 rounding."""
    from nafae_torch.data.youcook2 import SegmentDataset
    from nafae_torch.extract import decode_segment, extract_segments

    cfg = c5_cfg(ann, os.path.join(tmp, "ck5_x"), "float32", 1)
    with open(ann) as f:
        anns = [json.loads(ln) for ln in f if ln.strip()][:C5_EXTRACT]
    model = c5_detector(torch, cfg)
    out = os.path.join(tmp, "c5x", "train")
    t0 = time.perf_counter()
    extract_segments(cfg, anns, out, model=model)
    wall = time.perf_counter() - t0
    ds = SegmentDataset(os.path.dirname(out), "train", cfg.data.max_frames,
                        cfg.detector.num_proposals, 2048, cfg.data.max_words)
    if len(ds) != len(anns):
        fail(f"SegmentDataset loaded {len(ds)} of {len(anns)} extracted "
             "segments")
    worst = 0.0
    for ann_i in anns:
        with np.load(os.path.join(out, ann_i["id"] + ".npz")) as z:
            got = z["feats"].astype(np.float32)
        frames = decode_segment(ann_i["video"], cfg.detector.frame_rate,
                                cfg.data.max_frames, cfg.detector.image_size)
        want = model(torch.from_numpy(frames).cuda())["feats"].cpu().numpy()
        if got.shape != want.shape:
            fail(f"extracted feats {got.shape} vs inline {want.shape}")
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max()) / scale
        if not np.allclose(got, want, rtol=2 ** -10, atol=1e-6 * scale):
            fail(f"extracted feats differ from the inline detector's beyond "
                 f"f16 rounding: {err}")
        worst = max(worst, err)
    sample = ds[0]
    log(f"extracted {len(anns)} segments in {wall:.2f} s; SegmentDataset "
        f"reads them (feats {sample['feats'].shape}); feats equal the inline "
        f"detector's at f16 rounding (max |diff| / largest {worst:.3e})")
    return {"segments": len(anns), "wall_s": wall, "max_rel_diff": worst}


# ------------------------------------------------- config 5, real weights


def write_vgg_pth(torch, path: str, seed: int) -> None:
    """A faster-rcnn.pytorch VGG16 checkpoint of seeded random weights:
    RCNN_base (vgg16.features[:-1]) and RCNN_top (fc6, fc7) He-normal with
    small biases, the 512-wide RPN (2A bg/fg logits, 4A deltas, A = 15)
    and a 68-way detection head, nested under "model" with DataParallel's
    "module." prefixes, as the lineage saves it."""
    from nafae_torch.models.detector.vgg import VGG16_CONV_LAYERS

    gen = torch.Generator().manual_seed(seed)

    def he(*shape):
        fan_in = int(np.prod(shape[1:]))
        return torch.randn(*shape, generator=gen) * (2.0 / fan_in) ** 0.5

    def small(*shape, std=0.01):
        return torch.randn(*shape, generator=gen) * std

    sd, cin, a = {}, 3, 15
    for li, cout in VGG16_CONV_LAYERS:
        sd[f"RCNN_base.{li}.weight"] = he(cout, cin, 3, 3)
        sd[f"RCNN_base.{li}.bias"] = small(cout)
        cin = cout
    sd["RCNN_top.0.weight"] = he(4096, 512 * 7 * 7)
    sd["RCNN_top.0.bias"] = small(4096)
    sd["RCNN_top.3.weight"] = he(4096, 4096)
    sd["RCNN_top.3.bias"] = small(4096)
    sd["RCNN_rpn.RPN_Conv.weight"] = he(512, 512, 3, 3)
    sd["RCNN_rpn.RPN_Conv.bias"] = small(512)
    sd["RCNN_rpn.RPN_cls_score.weight"] = small(2 * a, 512, 1, 1)
    sd["RCNN_rpn.RPN_cls_score.bias"] = small(2 * a)
    sd["RCNN_rpn.RPN_bbox_pred.weight"] = small(4 * a, 512, 1, 1, std=1e-3)
    sd["RCNN_rpn.RPN_bbox_pred.bias"] = torch.zeros(4 * a)
    sd["RCNN_cls_score.weight"] = small(68, 4096)
    sd["RCNN_cls_score.bias"] = torch.zeros(68)
    sd["RCNN_bbox_pred.weight"] = small(68 * 4, 4096, std=1e-3)
    sd["RCNN_bbox_pred.bias"] = torch.zeros(68 * 4)
    torch.save({"model": {"module." + k: v for k, v in sd.items()},
                "epoch": 1}, path)


def write_resnet50_pth(torch, path: str, seed: int) -> None:
    """A torchvision resnet50 state dict of seeded random weights:
    He-normal convolutions, BN statistics near the identity (each block's
    last BN scaled down, so that the residual sums stay moderate)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[name + ".weight"] = (torch.randn(cout, cin, k, k, generator=gen)
                                * (2.0 / (cin * k * k)) ** 0.5)

    def bn(name, c, gain=1.0):
        sd[name + ".weight"] = gain * (0.5 + 0.5 * torch.rand(c, generator=gen))
        sd[name + ".bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[name + ".running_mean"] = 0.1 * torch.randn(c, generator=gen)
        sd[name + ".running_var"] = 0.5 + torch.rand(c, generator=gen)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for stage, blocks in enumerate((3, 4, 6, 3), start=1):
        mid = 64 * 2 ** (stage - 1)
        for b in range(blocks):
            p, c0 = f"layer{stage}.{b}", (cin if b == 0 else mid * 4)
            conv(p + ".conv1", mid, c0, 1)
            bn(p + ".bn1", mid)
            conv(p + ".conv2", mid, mid, 3)
            bn(p + ".bn2", mid)
            conv(p + ".conv3", mid * 4, mid, 1)
            bn(p + ".bn3", mid * 4, gain=0.2)
            if b == 0:
                conv(p + ".downsample.0", mid * 4, c0, 1)
                bn(p + ".downsample.1", mid * 4)
        cin = mid * 4
    torch.save(sd, path)


def write_release_files(root: str, ann: str, seed: int
                        ) -> tuple[str, str, str]:
    """From config 5's planted-signal segments (`ann` and the planted boxes
    beside it): a YouCook2 annotation file (the first VGG_VAL segments in
    the validation subset, the rest training, each over its video's whole
    span), a YouCook2-BB file with each named class's planted box in every
    frame (at the videos' resolution), and a GloVe-style text file of
    256-d vectors for every other class. Returns the three paths."""
    from nafae_torch.data.avi import read_avi
    from nafae_torch.data.vocab import DEFAULT_CLASSES

    with open(ann) as f:
        segs = [json.loads(ln) for ln in f if ln.strip()]
    with open(ann.replace("segments_", "boxes_").replace(".jsonl",
                                                         ".json")) as f:
        planted = json.load(f)
    yc2, bb = {}, {}
    for i, seg in enumerate(segs):
        _, n, frame = read_avi(seg["video"])
        h, w = frame(0).shape[:2]
        vid = seg["id"]
        yc2[vid] = {"duration": float(n),
                    "subset": "validation" if i < VGG_VAL else "training",
                    "annotations": [{"id": 0, "segment": [0, n - 1],
                                     "sentence": seg["sentence"]}]}
        bb[vid] = {"rwidth": w, "rheight": h, "segments": {"0": {
            "objects": [{"label": cls, "boxes": [
                {"x1": x1, "y1": y1, "x2": x2, "y2": y2, "outside": 0}
                for x1, y1, x2, y2 in frames]}
                for cls, frames in planted[vid].items()]}}}
    paths = [os.path.join(root, name) for name in
             ("youcookii_annotations.json", "yc2_bb_annotations.json",
              "vectors.txt")]
    for path, db in zip(paths, (yc2, bb)):
        with open(path, "w") as f:
            json.dump({"database": db}, f)
    rng = np.random.RandomState(seed)
    with open(paths[2], "w") as f:
        for cls in DEFAULT_CLASSES[::2]:
            vec = rng.randn(256) / 16
            f.write(cls + " " + " ".join(f"{x:.6f}" for x in vec) + "\n")
    return tuple(paths)


def check_vgg_load(torch, cfg) -> dict:
    """The port's loader on cfg.detector.weights, on the card and on the
    CPU, each into a VGG16 detector from the same random start: the two
    state dicts must be equal bit for bit, key by key, and differ from the
    start where the checkpoint has weights."""
    from nafae_torch.models.detector.faster_rcnn import init_detector
    from nafae_torch.utils.torch_convert import load_detector_weights

    dc = replace(cfg.detector, weights="")
    sds, secs = {}, {}
    for dev in ("cuda", "cpu"):
        model = init_detector(dc, torch.Generator().manual_seed(SEED),
                              device=dev)
        start = model.backbone.Conv_0.weight.clone()
        t0 = time.perf_counter()
        load_detector_weights(cfg.detector.weights, model,
                              num_scales=len(dc.anchor_scales),
                              num_ratios=len(dc.anchor_ratios))
        if dev == "cuda":
            torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
        if torch.equal(model.backbone.Conv_0.weight, start):
            fail(f"load_detector_weights left conv1_1 as it was ({dev})")
        sds[dev] = {k: v.cpu() for k, v in model.state_dict().items()}
        del model
    if set(sds["cuda"]) != set(sds["cpu"]):
        fail("the loaded state dicts have other keys on the card and CPU")
    differ = [k for k in sds["cpu"] if not torch.equal(sds["cuda"][k],
                                                        sds["cpu"][k])]
    if differ:
        fail(f"the checkpoint loaded differently on the card: {differ[:5]}")
    n = sum(v.numel() for v in sds["cpu"].values())
    log(f"loaded the VGG16 faster-rcnn.pytorch checkpoint "
        f"({os.path.getsize(cfg.detector.weights) / 1e6:.0f} MB, {n} "
        f"numbers) on the card in {secs['cuda']:.2f} s and on the CPU in "
        f"{secs['cpu']:.2f} s: {len(sds['cpu'])} tensors equal bit for bit")
    return {"tensors": len(sds["cpu"]), "numbers": n, "load_s": secs}


def check_release_extract(torch, tmp: str, ann: str, yc2: str, bb: str,
                          ckpt: str) -> dict:
    """`python -m nafae_torch.extract` as a user runs it on the release's
    files: the YouCook2 annotations' validation subset, the YC2-BB ground
    truth merged, the torchvision resnet50 checkpoint `ckpt` converted, on
    the card. The output must load through SegmentDataset(with_gt=True)
    and carry the planted boxes of `ann`'s videos as its ground truth (the
    named classes as word ids, a box in every frame);
    `evaluate_config` (config1) with config 5's f32 checkpoint on it must
    give the same hit counts on the card and on the CPU."""
    from nafae_torch.data.vocab import Vocab
    from nafae_torch.data.youcook2 import SegmentDataset
    from nafae_torch.evaluate import evaluate_config

    root = os.path.join(tmp, "yc2x")
    cmd = [sys.executable, "-m", "nafae_torch.extract", "--youcook2-json",
           yc2, "--video-dir", tmp, "--video-ext", ".avi", "--subset", "val",
           "--yc2bb-json", bb, "--ckpt", ckpt, "--out",
           os.path.join(root, "val")]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        fail(f"extract CLI failed ({run.returncode}): {run.stderr[-2000:]}")
    printed = json.loads(run.stdout.strip().splitlines()[-1])
    if printed.get("segments") != VGG_VAL or \
            printed.get("gt_merged") != VGG_VAL:
        fail(f"extract CLI printed {printed}; expected {VGG_VAL} segments, "
             "each with ground truth merged")
    ds = SegmentDataset(root, "val", 20, 20, 2048, 8, with_gt=True)
    gt_pairs = sum(float(ds[i]["gt_mask"].sum()) for i in range(len(ds)))
    if len(ds) != VGG_VAL or gt_pairs == 0:
        fail(f"SegmentDataset(with_gt=True) read {len(ds)} segments with "
             f"{gt_pairs} ground-truth pairs")
    with open(ann.replace("segments_", "boxes_").replace(".jsonl",
                                                         ".json")) as f:
        planted = json.load(f)
    vocab, box_err = Vocab(), 0.0
    for meta in ds.index:
        want = planted[meta["id"].rsplit("_", 1)[0]]
        with np.load(os.path.join(root, "val", meta["file"])) as z:
            ids, gtb, gtm = z["word_ids"], z["gt_boxes"], z["gt_mask"]
        if list(ids) != [vocab.lookup(c) for c in want] or not gtm.all():
            fail(f"{meta['id']}: merged word ids {list(ids)} / mask "
                 f"{gtm.sum()} do not match the planted classes {list(want)}")
        box_err = max(box_err, float(np.abs(
            gtb - np.asarray(list(want.values()), np.float32)).max()))
    if box_err > 1e-3:
        fail(f"merged ground-truth boxes are {box_err} px off the planted")
    cfg = eval_cfg(root, os.path.join(tmp, "ck5_float32"))
    res = {d: evaluate_config(cfg, require_checkpoint=True, device=d)
           for d in ("cuda", "cpu")}
    hits = {d: round(r["box_acc_micro"] * r["num_annotations"])
            for d, r in res.items()}
    if res["cuda"]["num_annotations"] != res["cpu"]["num_annotations"] \
            or hits["cuda"] != hits["cpu"]:
        fail(f"eval of the extracted features: card {res['cuda']}, CPU "
             f"{res['cpu']}")
    log(f"extract CLI (--youcook2-json --subset val --yc2bb-json --ckpt "
        f"resnet50) on the card in {wall:.1f} s incl. start-up: {printed}; "
        f"ground truth = the planted boxes (within {box_err:.1e} px); "
        f"config1 eval of config 5's f32 checkpoint on them: "
        f"{res['cuda']['num_annotations']} annotations, hits card "
        f"{hits['cuda']} / CPU {hits['cpu']}")
    return {"printed": {k: v for k, v in printed.items() if k != "index"},
            "wall_s": wall, "num_annotations": res["cuda"]["num_annotations"],
            "hits": hits, "gt_pairs": gt_pairs, "gt_box_err_px": box_err}


def roi_bound_ms(torch, feat, boxes, scale=1 / 16) -> tuple[float, str]:
    """Least time for K5 on these inputs: the feature cells some box of the
    frame reads (each once) and the boxes, plus the f32 output written
    once, over the memory rate; 2 flops for each non-zero (wy, wx) pair of
    each output cell and channel, over the rate for feat's type."""
    from nafae_torch.ops.roi_align import _weights

    f, h, w, c = feat.shape
    b = boxes.float() * scale
    wy = _weights(b[..., 1], b[..., 3], h, 7, 2) != 0        # [F,R,P,H]
    wx = _weights(b[..., 0], b[..., 2], w, 7, 2) != 0        # [F,R,Q,W]
    cells = (wy.any(2)[..., :, None] & wx.any(2)[..., None, :]).any(1)
    pairs = (wy.sum(-1)[..., :, None] * wx.sum(-1)[..., None, :]).sum()
    nbytes_ = (int(cells.sum()) * c * feat.element_size()
               + boxes.numel() * 4 + f * boxes.shape[1] * 49 * c * 4)
    return bound(torch, nbytes_, 2 * int(pairs) * c, feat.dtype)


def nms_bound_ms(torch, scores, idx, valid) -> tuple[float, str]:
    """Least time for K2 on these rows, counted from what the function
    needs: every score read once; the four coordinates of every box ranked
    at or above the row's last valid winner (score descending, index
    ascending: each must be tested against the winners), or, in a row that
    exhausts, of every box scoring above -1e9; idx and valid written once;
    one IoU (20 flops) for each (winner, such box)."""
    b, n = scores.shape
    keep = idx.shape[1]
    wins = valid.sum(1).long()
    last = idx.long().gather(1, (wins - 1).clamp(min=0)[:, None])
    last_score = scores.gather(1, last)
    j = torch.arange(n, device=scores.device)
    ranked = (scores > last_score) | ((scores == last_score) & (j <= last))
    tested = torch.where((wins < keep)[:, None], scores > -1e9, ranked)
    boxes = tested.sum(1)
    return bound(torch, nbytes(scores) + 16 * int(boxes.sum()) + b * keep * 8,
                 20 * int((wins * boxes).sum()), torch.float32)


def detector_kernel_times(torch, det, frames, label: str) -> dict:
    """K2 and K5 on this detector's own inputs for `frames` [N,S,S,3]:
    against their plain versions (survivors exactly; K5_TOL), their device
    times (CUDA graphs), the plain versions' (torch.profiler device time)
    and bounds; also the peak device memory of the detector's forward up to
    its kernels' inputs (GiB above what was allocated before)."""
    from nafae_torch.ops import nms as P
    from nafae_torch.ops.kernels import nms as K2
    from nafae_torch.ops.kernels import roi_align as K5

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    planes, scores, feat, boxes = detector_inputs(torch, det, frames)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    fk = feat.contiguous()
    del feat
    res = {"detector_peak_gib": peak}
    res["nms_err"], _, res["nms_continuation_rows"] = nms_vs_plain(
        torch, label, *planes, scores, 0.7)
    res["roi_align_err"] = roi_vs_plain(torch, label, fk, boxes, 1 / 16)
    res["nms_ms"] = device_ms(torch, lambda: K2.launch(*planes, scores, 20,
                                                       0.7))
    res["nms_plain_ms"] = profile_forward(
        torch, lambda: P.nms_planes(*planes, scores, 20, 0.7), reps=2)[1]
    idx, valid = K2.launch(*planes, scores, 20, 0.7)
    res["nms_bound_ms"], res["nms_bound_by"] = nms_bound_ms(torch, scores,
                                                            idx, valid)
    res["roi_align_ms"] = device_ms(
        torch, lambda: K5.launch(fk, boxes, 1 / 16), reps=2, runs=11)
    res["roi_align_plain_ms"] = profile_forward(
        torch, lambda: K5.roi_align_plain(fk, boxes, 7, 1 / 16), reps=2)[1]
    res["roi_align_bound_ms"], res["roi_align_bound_by"] = roi_bound_ms(
        torch, fk, boxes)
    res["shapes"] = {"rows": scores.shape[0], "anchors": scores.shape[1],
                     "feat": list(fk.shape), "feat_dtype": str(fk.dtype),
                     "boxes": list(boxes.shape)}
    return res


def c5_timings(torch, ann: str, tmp: str, extra=(), runs=None) -> dict:
    """On the first config-5 batch (B=16, T=20, 640x640), for the f32 and
    the bf16 detector (`extra`: more overrides): K2 and K5 on the
    detector's own inputs (detector_kernel_times; keys of the bf16
    detector end in _bf16); then one training step of each run of `runs`
    ({name: overrides}, by default C5_RUNS; c5_step_timings)."""
    res = {}
    torch.cuda.empty_cache()    # no cached segment may hold the frames
    cfg = c5_cfg(ann, os.path.join(tmp, "ck5_t"), "float32", 1000, extra)
    batch = c5_first_batch(cfg)
    frames = torch.from_numpy(batch["frames"]).cuda()
    frames = frames.reshape((-1,) + frames.shape[2:])
    res["valid_frames"] = int(batch["frame_mask"].sum())
    for tag, run in (("", "float32"), ("_bf16", "bfloat16")):
        det = c5_detector(torch, c5_cfg(ann, os.path.join(tmp, "ck5_t"), run,
                                        1000, extra))
        times = detector_kernel_times(
            torch, det, frames,
            f"config5 {cfg.detector.backbone} {run} detector")
        del det
        res.update({k + tag: v for k, v in times.items()})
        torch.cuda.empty_cache()
    del frames
    runs = runs or C5_RUNS
    for run, more in runs.items():
        res.update(c5_step_timings(torch, ann, tmp, batch, run,
                                   [*extra, *more]))
    return res


def c5_step_timings(torch, ann, tmp, batch, run, extra) -> dict:
    """One config-5 step of `run` (the overrides `extra` on the preset):
    host to host (numpy batch in, metrics ready), the same on a resident
    batch, the frames' copy alone, device busy time and kernels by device
    time (torch.profiler). Keys end in _<run>."""
    from nafae_torch.train import (TrainState, batch_to_device,
                                   make_optimizer, train_step)

    dev = torch.device("cuda")
    cfg = c5_cfg(ann, os.path.join(tmp, "ck5_t"), "float32", 1000, extra)
    batch = {k: v[:cfg.data.batch_size] for k, v in batch.items()}
    torch.cuda.empty_cache()
    det = c5_detector(torch, cfg)
    tx = make_optimizer(cfg)
    st = TrainState.create(cfg, device=dev)
    tb = batch_to_device(batch, dev)
    for _ in range(2):
        st, _ = train_step(st, tb, cfg, tx, det)
    torch.cuda.synchronize()
    host, resident, h2d = [], [], []
    for _ in range(C5_TIMED_STEPS):
        t0 = time.perf_counter()
        st, m = train_step(st, batch_to_device(batch, dev), cfg, tx, det)
        float(m["loss"])
        host.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        st, m = train_step(st, tb, cfg, tx, det)
        float(m["loss"])
        resident.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        batch_to_device(batch, dev)
        torch.cuda.synchronize()
        h2d.append((time.perf_counter() - t0) * 1e3)
    top, busy, ops = profile_forward(
        torch, lambda: train_step(st, tb, cfg, tx, det), reps=2)
    slots = int(np.prod(batch["frame_mask"].shape))
    t = "_" + run
    res = {"step_batch_size" + t: cfg.data.batch_size,
           "step_host_ms" + t: statistics.median(host),
           "step_host_ms_resident" + t: statistics.median(resident),
           "step_h2d_ms" + t: statistics.median(h2d),
           "step_device_busy_ms" + t: busy, "step_device_ops" + t: ops,
           "step_kernels" + t: top}
    res["frames_per_s_host" + t] = slots / res["step_host_ms" + t] * 1e3
    res["device_idle_share_host" + t] = 1.0 - busy / res["step_host_ms" + t]
    return res



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


def sdpa_mix(torch, v_ext, fm_ext, rm_ext, w, temp):
    """K1f's library yardstick: the context mix as
    scaled_dot_product_attention over the (video, centre frame, offset)
    batch (q = v[t], k = v = v[t+o], an additive -1e9 mask over the
    neighbour's regions, scale 1/temp), then the nv-weighted sum over the
    offsets and the division, from v_ext (the neighbours' gather included).
    Timed only; the port never calls it."""
    F = torch.nn.functional
    b, t_ext, r, e = v_ext.shape
    t = t_ext - 2 * w
    # built on the device, with no copy from the host and no sync: it runs
    # inside a CUDA graph
    dev = v_ext.device
    offs = torch.cat([torch.arange(-w, 0, device=dev),
                      torch.arange(1, w + 1, device=dev)])
    idx = torch.arange(t, device=dev)[:, None] + w + offs[None]  # [T,2w]
    kv = v_ext[:, idx].reshape(b * t, 2 * w, r, e)
    q = v_ext[:, w:w + t, None].expand(b, t, 2 * w, r, e).reshape(kv.shape)
    nv = fm_ext[:, idx] * fm_ext[:, w:w + t, None]               # [B,T,2w]
    mask = None
    if rm_ext is not None:
        mask = torch.where(rm_ext[:, idx] > 0, 0.0, -1e9).to(v_ext.dtype)
        mask = mask.reshape(b * t, 2 * w, 1, r)
    out = F.scaled_dot_product_attention(q, kv, kv, attn_mask=mask,
                                         scale=1.0 / temp)
    out = out.float().reshape(b, t, 2 * w, r, e) * nv[..., None, None]
    return out.sum(2) / torch.clamp(nv.sum(-1), min=1.0)[..., None, None]


def timings(torch, srv, segs) -> dict:
    """Device times of K1f and its plain version on the first serving
    batch's own inputs (and on the same embeddings with every frame valid),
    of K1f's SDPA yardstick (sdpa_mix) on the first, with its error against
    the plain version, and of one full serving batch; plus the batch host
    to host."""
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
                if tag:
                    continue
                dt_name = "bfloat16" if dt_tag else "float32"
                res["library_ms" + dt_tag] = device_ms(
                    torch, lambda: sdpa_mix(torch, v, fm, rm_ext, w, temp))
                want, _ = K.context_mix_plain(
                    v, fm, w, temp, rm_ext=rm_ext,
                    dtype=torch.bfloat16 if dt_tag else None)
                got = sdpa_mix(torch, v, fm, rm_ext, w, temp)
                rtol, atol = CTX_TOL[dt_name]
                res["library_err" + dt_tag] = (got - want).abs().max().item()
                res["library_within_tol" + dt_tag] = bool(torch.allclose(
                    got, want, rtol=rtol, atol=atol))
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


def fused_inputs(torch, root: str, tmp: str):
    """The fused route's inputs on the first training batch (config4, B=16,
    K=8, T=20, R=20, E=256, Kc=67, its own masks), from the initial params:
    (w_emb, v_emb, u, centers, fm, rm, hc) on the card, f32."""
    from nafae_torch.ops import grounding as TG
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
    return w_emb, v_emb, u, state.centers, fm, rm, hc


def diag_bounds(torch, wk, v, centers, fm, hc, rm, fwd, dctx, dclu, dw,
                dv):
    """(K4f's, K4b's) (least ms, what bounds it) on these inputs. K4f: s
    over live regions, ŝ over the ctx mask, sims everywhere; it reads v̂ at
    the live regions and region 0 of all-masked frames (its pick there), u
    at the ctx mask, and writes ctx, clu and f (its residuals d, r* and c*
    are a choice of the design, not counted). K4b on K4f's residuals: it
    reads v̂ only at the ctx mask (ds is 0 elsewhere) and only the centers
    in c*, and writes dw and the whole of dv."""
    b, t, r, e = v.shape
    k, kc = wk.shape[1], centers.shape[0]
    row = e * v.element_size()                    # one region of v̂ or u
    live = int((rm > 0).sum())                        # (b, t, r) regions
    on = int(((rm > 0) & (fm > 0)[..., None] & (hc > 0)[..., None]).sum())
    empty = int(((rm > 0).sum(-1) == 0).sum())        # all-masked frames
    fwd_bound = bound(torch, nbytes(wk, centers, fm, hc, rm, *fwd[:3])
                      + (live + empty + on) * row,
                      2 * e * k * (live + on) + 2 * e * kc * b * k * t,
                      v.dtype)
    bwd_bound = bound(torch, nbytes(wk, *fwd[3:6], fwd[2], dctx, dclu, dw,
                                    dv) + on * row
                      + int(fwd[5].unique().numel()) * e
                      * centers.element_size(),
                      4 * e * k * on + 4 * e * b * k * t, v.dtype)
    return fwd_bound, bwd_bound


def fused_timings(torch, root: str, tmp: str) -> dict:
    """On the first training batch (config4, B=16, K=8, T=20, R=20, E=256,
    Kc=67, its own masks), from the initial params, in f32 and bf16: device
    times (CUDA graphs) of K3, K4f and K4b, of their plain versions, of an
    empty kernel of each one's grid (K4f: two, as it launches), and for K3
    of the two PyTorch calls that compute the same max on the auto route
    (torch.matmul, then torch.max over R: no mask); K4f and K4b also with
    every region live and every frame valid and with context (the dense
    variant); their bounds from these inputs; and each kernel's max |error|
    against its plain version here."""
    from nafae_torch.ops.kernels import cross_mil as K3
    from nafae_torch.ops.kernels import diag as K4

    dev = torch.device("cuda")
    w_emb, v_emb, u, centers, fm, rm, hc = fused_inputs(torch, root, tmp)
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
    ones_t, ones_r = torch.ones_like(fm), torch.ones_like(rm)
    for tag, dt in (("", torch.float32), ("_bf16", torch.bfloat16)):
        wf = w_emb.reshape(m, e).to(dt).contiguous()
        wk, v, uu = w_emb.to(dt), v_emb.to(dt), u.to(dt)
        bf16 = dt == torch.bfloat16
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
        # an empty kernel with K3's grid, block and shared memory: the floor
        # that any kernel launched in that shape pays
        res["cross_mil_floor_ms" + tag] = device_ms(
            torch, lambda: K3.launch_floor(b, m, t, r, e, bf16, dev))
        res["cross_mil_bound_ms" + tag], res["cross_mil_bound_by" + tag] = \
            bound(torch, nbytes(wf, fm, rm) + live * row + 2 * b * m * t * 4,
                  2 * m * e * live, dt)
        res["diag_floor_ms" + tag] = device_ms(
            torch, lambda: K4.launch_floor_fwd(b, k, t, r, e, kc, bf16, dev))
        res["diag_bwd_floor_ms" + tag] = device_ms(
            torch, lambda: K4.launch_floor_bwd(b, k, t, r, e, bf16, dev))
        gen = torch.Generator().manual_seed(SEED + 5)
        dctx = torch.rand((b, k, t), generator=gen).to(dev)
        dclu = torch.rand((b, k, t), generator=gen).to(dev)
        for var, (fmv, hcv, rmv) in (("", (fm, hc, rm)),
                                     ("_dense", (ones_t, ones_t, ones_r))):
            key = var + tag
            fwd = K4.launch_fwd(wk, v, uu, centers, fmv, hcv, rmv)
            torch.cuda.synchronize()
            res["diag_ms" + key] = device_ms(
                torch, lambda: K4.launch_fwd(wk, v, uu, centers, fmv, hcv,
                                             rmv))
            # K4b on K4f's residuals, with random cotangents
            res_args = (wk, v, centers, fwd[3], fwd[4], fwd[5], fwd[2], dctx,
                        dclu)
            dw, dv = K4.launch_bwd(*res_args)
            torch.cuda.synchronize()
            res["diag_bwd_ms" + key] = device_ms(
                torch, lambda: K4.launch_bwd(*res_args))
            (res["diag_bound_ms" + key], res["diag_bound_by" + key]), \
                (res["diag_bwd_bound_ms" + key],
                 res["diag_bwd_bound_by" + key]) = diag_bounds(
                    torch, wk, v, centers, fmv, hcv, rmv, fwd, dctx, dclu,
                    dw, dv)
            if var:
                continue
            want = K4.diag_fwd_plain(wk, v, uu, centers, fm, hc, rm)
            res["diag_err" + tag] = max(
                (fwd[0] - want[0]).abs().max().item(),
                (fwd[3] - want[3]).abs().max().item())
            res["diag_plain_ms" + tag] = device_ms(
                torch, lambda: K4.diag_fwd_plain(wk, v, uu, centers, fm, hc,
                                                 rm))
            pdw, pdv = K4.diag_bwd_plain(*res_args)
            res["diag_bwd_err" + tag] = max((dw - pdw).abs().max().item(),
                                            (dv - pdv).abs().max().item())
            res["diag_bwd_plain_ms" + tag] = device_ms(
                torch, lambda: K4.diag_bwd_plain(*res_args))
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

    t_start = time.perf_counter()
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
        evals = check_eval(torch, tmp, tmp, box_accuracy(
            torch, segs, served["float32"][1], gts))

        tm = timings(torch, srv32, segs)
        tt = train_timings(torch, tmp, tmp)
        tf = fused_timings(torch, tmp, tmp)

        # config 5 (main paths 5-7): the detector's kernels on its own
        # full-width inputs, then training through fit, card vs CPU,
        # extraction and times
        t5 = time.perf_counter()
        ann = write_c5_videos(tmp, C5_SEGMENTS, 640, SEED)
        ann_small = write_c5_videos(tmp, C5_CPU["segments"], C5_CPU["image"],
                                    SEED + 1)
        size = sum(os.path.getsize(os.path.join(tmp, f))
                   for f in os.listdir(tmp) if f.endswith(".avi"))
        log(f"wrote {C5_SEGMENTS} + {C5_CPU['segments']} planted-signal AVIs "
            f"({size / 1e9:.2f} GB) in {time.perf_counter() - t5:.1f} s")
        cfg5 = c5_cfg(ann, os.path.join(tmp, "ck5_k"), "float32", 1)
        frames5 = torch.from_numpy(c5_first_batch(cfg5)["frames"]).cuda()
        planes, scores, feat5, boxes5 = detector_inputs(
            torch, c5_detector(torch, cfg5),
            frames5.reshape((-1,) + frames5.shape[2:]))
        nms_info = check_nms(torch, planes, scores)
        rerrs = check_roi_align(torch, feat5, boxes5)
        del frames5, planes, scores, feat5, boxes5
        torch.cuda.empty_cache()
        c5 = train_c5(torch, ann, tmp)
        c5_cpu = check_c5_cpu(torch, ann_small, tmp)
        c5_x = check_c5_extract(torch, ann, tmp)
        t5m = c5_timings(torch, ann, tmp)

        # config 5 from real-format weights and annotations (main path 6):
        # the converted VGG16 detector trained through fit, card vs CPU,
        # the release's files through the extract CLI and eval, times
        t10 = time.perf_counter()
        vgg_pth = os.path.join(tmp, "faster_rcnn_vgg16.pth")
        rn_pth = os.path.join(tmp, "resnet50.pth")
        write_vgg_pth(torch, vgg_pth, SEED + 10)
        write_resnet50_pth(torch, rn_pth, SEED + 11)
        yc2, bb, vectors = write_release_files(tmp, ann, SEED + 12)
        log(f"wrote the VGG16 and resnet50 checkpoints and the release-format "
            f"files in {time.perf_counter() - t10:.1f} s")
        vgg = [*VGG_OVERRIDES, f"detector.weights={vgg_pth}"]
        vgg_load = check_vgg_load(torch, c5_cfg(ann, tmp, "float32", 1, vgg))
        seeded = [f"model.word_vectors={vectors}", "loss.kmeans_init=plusplus"]
        c5v = train_c5(torch, ann, tmp, {
            run: ([*vgg, *more, *(seeded if run == VGG_SEEDED else [])], n)
            for run, (more, n) in VGG_RUNS.items()}, tag="_vgg")
        c5v_cpu = check_c5_cpu(torch, ann_small, tmp, vgg)
        c5v_x = check_release_extract(torch, tmp, ann, yc2, bb, rn_pth)
        t10m = c5_timings(torch, ann, tmp, vgg, {
            "vgg_float32": VGG_F32_CUT,
            "vgg_bfloat16": ["detector.dtype=bfloat16"]})
    log(f"ctx_mix device time on the first serving batch: f32 kernel "
        f"{tm['ms']:.4f} ms, plain {tm['plain_ms']:.4f} ms, bound "
        f"{tm['bound_ms']:.4f} ms ({tm['bound_by']}); bf16 kernel "
        f"{tm['ms_bf16']:.4f} ms, plain {tm['plain_ms_bf16']:.4f} ms, bound "
        f"{tm['bound_ms_bf16']:.4f} ms ({tm['bound_by_bf16']}); every "
        f"frame valid: f32 kernel {tm['ms_dense']:.4f} ms, plain "
        f"{tm['plain_ms_dense']:.4f} ms, bound {tm['bound_ms_dense']:.4f} ms; "
        f"bf16 kernel {tm['ms_dense_bf16']:.4f} ms, bound "
        f"{tm['bound_ms_dense_bf16']:.4f} ms at {tm['shapes']} — {card}")
    log(f"K1f's SDPA yardstick (sdpa_mix) on the first serving batch: f32 "
        f"{tm['library_ms']:.4f} ms, max |err| vs plain "
        f"{tm['library_err']:.3e} (within CTX_TOL: "
        f"{tm['library_within_tol']}); bf16 {tm['library_ms_bf16']:.4f} ms, "
        f"max |err| {tm['library_err_bf16']:.3e} (within CTX_TOL: "
        f"{tm['library_within_tol_bf16']}) — {card}")
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
                                     for k, v in tt["errs" + tag].items()
                                     if k != "dv_max"))
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
            f"{tf['cross_mil_library_ms' + tag]:.4f}; an empty kernel of its "
            f"grid {tf['cross_mil_floor_ms' + tag]:.4f}); K4f diag_epilogue "
            f"{tf['diag_ms' + tag]:.4f} ms (bound "
            f"{tf['diag_bound_ms' + tag]:.4f}, {tf['diag_bound_by' + tag]}; "
            f"plain {tf['diag_plain_ms' + tag]:.4f}; empty kernels of its "
            f"grids {tf['diag_floor_ms' + tag]:.4f}; dense "
            f"{tf['diag_ms_dense' + tag]:.4f}, bound "
            f"{tf['diag_bound_ms_dense' + tag]:.4f}); K4b diag_epilogue_bwd "
            f"{tf['diag_bwd_ms' + tag]:.4f} ms (bound "
            f"{tf['diag_bwd_bound_ms' + tag]:.4f}, "
            f"{tf['diag_bwd_bound_by' + tag]}; plain "
            f"{tf['diag_bwd_plain_ms' + tag]:.4f}; an empty kernel of its "
            f"grid {tf['diag_bwd_floor_ms' + tag]:.4f}; dense "
            f"{tf['diag_bwd_ms_dense' + tag]:.4f}, bound "
            f"{tf['diag_bwd_bound_ms_dense' + tag]:.4f}); max |err| vs plain "
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

    for tag, dt in (("", "f32"), ("_bf16", "bf16 detector")):
        log(f"config-5 kernels on the first batch's detector inputs "
            f"{t5m['shapes' + tag]}, {dt}: K2 nms {t5m['nms_ms' + tag]:.4f} "
            f"ms (bound {t5m['nms_bound_ms' + tag]:.4f}, "
            f"{t5m['nms_bound_by' + tag]}; plain "
            f"{t5m['nms_plain_ms' + tag]:.4f}; rows that took the "
            f"continuation {t5m['nms_continuation_rows' + tag]}); K5 roi_align "
            f"{t5m['roi_align_ms' + tag]:.4f} ms (bound "
            f"{t5m['roi_align_bound_ms' + tag]:.4f}, "
            f"{t5m['roi_align_bound_by' + tag]}; plain "
            f"{t5m['roi_align_plain_ms' + tag]:.4f}); max |kernel - plain| "
            f"on these inputs: K2 {t5m['nms_err' + tag]} (survivors equal), "
            f"K5 {t5m['roi_align_err' + tag]:.3e} — {card}")
    for run in C5_RUNS:
        t = "_" + run
        log(f"config-5 training step ({run}, B=16 T=20 640x640, "
            f"{t5m['valid_frames']} valid frames of 320): host to host "
            f"{t5m['step_host_ms' + t]:.2f} ms = "
            f"{t5m['frames_per_s_host' + t]:.1f} frame slots/s; the frames' "
            f"copy to the card alone {t5m['step_h2d_ms' + t]:.2f} ms; the "
            f"step on a resident batch {t5m['step_host_ms_resident' + t]:.2f}"
            f" ms; device busy {t5m['step_device_busy_ms' + t]:.2f} ms in "
            f"{t5m['step_device_ops' + t]:.0f} device operations (idle "
            f"{100 * t5m['device_idle_share_host' + t]:.1f}% of host to "
            f"host); peak device memory in fit {c5[run]['peak_gib']:.2f} GiB "
            f"— {card}")
        log(f"device time per config-5 step ({run}) by kernel: "
            + "; ".join(f"{us:.1f} us {name}"
                        for name, us in t5m["step_kernels" + t]))

    for tag, dt in (("", "f32"), ("_bf16", "bf16 detector")):
        log(f"VGG16 config-5 kernels on the first batch's detector inputs "
            f"{t10m['shapes' + tag]}, {dt}: K2 nms {t10m['nms_ms' + tag]:.4f}"
            f" ms (bound {t10m['nms_bound_ms' + tag]:.4f}, "
            f"{t10m['nms_bound_by' + tag]}; plain "
            f"{t10m['nms_plain_ms' + tag]:.4f}; rows that took the "
            f"continuation {t10m['nms_continuation_rows' + tag]}); K5 "
            f"roi_align (C = 512) {t10m['roi_align_ms' + tag]:.4f} ms (bound "
            f"{t10m['roi_align_bound_ms' + tag]:.4f}, "
            f"{t10m['roi_align_bound_by' + tag]}; plain "
            f"{t10m['roi_align_plain_ms' + tag]:.4f}); max |kernel - plain| "
            f"K2 {t10m['nms_err' + tag]} (survivors equal), K5 "
            f"{t10m['roi_align_err' + tag]:.3e}; peak device memory of the "
            f"detector's forward {t10m['detector_peak_gib' + tag]:.2f} GiB "
            f"— {card}")
    for run, fit_run in (("vgg_float32", "float32"),
                         ("vgg_bfloat16", "bf16_pallas_roi")):
        t = "_" + run
        log(f"VGG16 config-5 training step ({run}, B="
            f"{t10m['step_batch_size' + t]} T=20 640x640): host to host "
            f"{t10m['step_host_ms' + t]:.2f} ms = "
            f"{t10m['frames_per_s_host' + t]:.1f} frame slots/s; the frames' "
            f"copy alone {t10m['step_h2d_ms' + t]:.2f} ms; on a resident "
            f"batch {t10m['step_host_ms_resident' + t]:.2f} ms; device busy "
            f"{t10m['step_device_busy_ms' + t]:.2f} ms in "
            f"{t10m['step_device_ops' + t]:.0f} device operations (idle "
            f"{100 * t10m['device_idle_share_host' + t]:.1f}% of host to "
            f"host); peak device memory in fit ({fit_run}) "
            f"{c5v[fit_run]['peak_gib']:.2f} GiB — {card}")
        log(f"device time per VGG16 config-5 step ({run}) by kernel: "
            + "; ".join(f"{us:.1f} us {name}"
                        for name, us in t10m["step_kernels" + t]))

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
            tm["bound_by"], library_ms=tm["library_ms"],
            library="sdpa_mix: scaled_dot_product_attention over the (b, t, "
            "o) batch, the nv-weighted sum and the division (the neighbours' "
            "gather included)",
            library_ms_bf16=tm["library_ms_bf16"],
            library_max_abs_err=tm["library_err"],
            library_max_abs_err_bf16=tm["library_err_bf16"],
            library_within_tol=tm["library_within_tol"],
            library_within_tol_bf16=tm["library_within_tol_bf16"],
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
                "bf16 output)"} if key == "cross_mil" else
               # *_dense: every region live, every frame valid with context
               {n + d: tf[key + "_" + n + d]
                for n in ("ms_dense", "bound_ms_dense", "bound_by_dense")
                for d in ("", "_bf16")}),
            floor_ms=tf[key + "_floor_ms"],
            floor_ms_bf16=tf[key + "_floor_ms_bf16"],
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
                            for d, x in derrs.items()}))),
        *(kernel_entry(
            name, f"nafae_torch/csrc/{name}.cu", rep,
            c5[run]["launches"][name],
            c5[run]["launches"][name] / C5_STEPS[run], err["float32"],
            t5m[name + "_ms"], t5m[name + "_plain_ms"],
            t5m[name + "_bound_ms"], t5m[name + "_bound_by"],
            max_abs_err_bf16=err["bfloat16"], ms_bf16=t5m[name + "_ms_bf16"],
            plain_ms_bf16=t5m[name + "_plain_ms_bf16"],
            bound_ms_bf16=t5m[name + "_bound_ms_bf16"],
            bound_by_bf16=t5m[name + "_bound_by_bf16"],
            **({"continuation_rows": t5m["nms_continuation_rows"],
                "continuation_rows_bf16": t5m["nms_continuation_rows_bf16"]}
               if name == "nms" else {}),
            shapes=t5m["shapes"], path=f"config-5 training ({run})",
            # *_vgg: phase 10's VGG16 detector (C = 512), f32 and bf16
            launches_vgg=sum(r["launches"][name] for r in c5v.values()),
            **{k + "_vgg" + d: t10m[name + "_" + m + d]
               for k, m in (("max_abs_err", "err"), ("ms", "ms"),
                            ("plain_ms", "plain_ms"),
                            ("bound_ms", "bound_ms"),
                            ("bound_by", "bound_by"))
               for d in ("", "_bf16")},
            shapes_vgg=t10m["shapes"], shapes_vgg_bf16=t10m["shapes_bf16"])
          for name, rep, run, err in (
              ("nms", "nafae_tpu/ops/pallas/nms.py:36",   # _kernel
               "float32",
               {"float32": max(nms_info["max_abs_err"], t5m["nms_err"],
                               t10m["nms_err"]),
                "bfloat16": max(t5m["nms_err_bf16"], t10m["nms_err_bf16"])}),
              ("roi_align", "nafae_tpu/ops/pallas/roi_align.py:43",  # _kernel
               "pallas_roi",
               {"float32": max(rerrs["float32"], t5m["roi_align_err"],
                               t10m["roi_align_err"]),
                "bfloat16": max(rerrs["bfloat16"],
                                t5m["roi_align_err_bf16"],
                                t10m["roi_align_err_bf16"])})))],
        "serving": {
            "batch_device_ms": tm["batch_device_ms"],
            "batch_host_ms": tm["batch_host_ms"],
            "frames_per_batch": tm["batch_frames"],
            "frames_per_s_device": tm["frames_per_s_device"],
            "frames_per_s_host": tm["frames_per_s_host"],
            "device_busy_ms": tm["device_busy_ms"],
            "device_idle_share_host": 1.0 - tm["device_busy_ms"]
            / tm["batch_host_ms"]},
        "eval": evals,
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
        "config5": {
            **{k: v for k, v in t5m.items()
               if k.startswith(("step_", "frames_per_s", "device_idle"))
               and "kernels" not in k},
            "valid_frames_first_batch": t5m["valid_frames"],
            **{f"loss_first_last_{run}": [c5[run]["logs"][0]["loss"],
                                          c5[run]["logs"][-1]["loss"]]
               for run in C5_RUNS},
            **{f"peak_device_gib_{run}": c5[run]["peak_gib"]
               for run in C5_RUNS},
            **{f"fit_wall_s_{run}": c5[run]["wall_s"] for run in C5_RUNS},
            "nms_check": nms_info, "cpu_rerun": c5_cpu, "extract": c5_x,
            "phase_s": t10 - t5},
        "config5_vgg": {
            **{k: v for k, v in t10m.items()
               if k.startswith(("step_", "frames_per_s", "device_idle",
                                "detector_peak"))
               and "kernels" not in k},
            "valid_frames_first_batch": t10m["valid_frames"],
            **{f"loss_first_last_{run}": [r["logs"][0]["loss"],
                                          r["logs"][-1]["loss"]]
               for run, r in c5v.items()},
            **{f"peak_device_gib_{run}": r["peak_gib"]
               for run, r in c5v.items()},
            **{f"fit_wall_s_{run}": r["wall_s"] for run, r in c5v.items()},
            "load": vgg_load, "cpu_rerun": c5v_cpu, "extract_eval": c5v_x,
            "phase_s": time.perf_counter() - t10},
        "script_s": time.perf_counter() - t_start,
    }), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
