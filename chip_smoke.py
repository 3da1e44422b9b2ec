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
   valid neighbour, an invalid centre frame between valid ones, real halo
   frames as a frame-parallel shard receives them (w > T among them); two
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
   config-5 step, f32 and bf16, with idle share and peak memory;
11. int8 serving, the exported artifact and visualize (main path 7; run
   after phase 7, on the serving phase's requests and val split): config4
   servers with `model.quantize=int8` and `int8pre`, f32 and bf16, on the
   oracle params, each launching K1f (through the custom op
   nafae::ctx_mix_fwd) once a batch and nothing else, box accuracy over
   the bar, one batch re-run on the CPU (quantized weights and features,
   scales and int32 products bit for bit, regions equal where clear of
   ties, scores within SERVE_CPU_TOL), int8pre over HTTP with pre-quantized
   requests; config1 eval with int8 and int8pre over the val split
   written as int8 feature files, hits card = CPU; four exported artifacts
   (f32; stored int8 through `python -m nafae_torch.serve --export DIR
   --quantize int8`; int8 compute; int8pre) loaded in a fresh process
   that must answer bit for bit as the live server here and launch K1f
   once, the f32 and int8pre ones timed there against a live server
   (device and host-to-host ms, interleaved); `visualize_config` with PNGs
   on the card, records equal to the CPU's; device ms of the projection in
   f32, bf16, int8 and int8pre with their bounds, and the f32, int8 and
   int8pre serving batch host to host, its copy to the card, device and
   busy time, idle share.
12. data parallelism and the train CLI's observability (main path 8; run
   after phase 7, on phase 5's data): a world-of-one NCCL mesh
   (`parallel.make_mesh` on cuda:0); `fit` under it, 5 f32 steps of
   config4 at full width on each route, bit for bit the same 5 steps
   without a mesh (metrics, params, centers) with the same launches, and
   its collectives step by step; the config4 step host to host without a
   mesh, on the mesh and with debug_nans (interleaved), and the bytes one
   mesh step all-reduces and all-gathers; K3 against its plain version at
   each rank's shapes of a 2- and 4-card run (I = 8 and 4 videos against
   M = 128 words, f32 and bf16, timed with its bound); `torchrun
   --nproc_per_node 1 -m nafae_torch.train --mesh`, whose metrics.jsonl
   equals the in-process DP run's, and `-m nafae_torch.evaluate --mesh`,
   whose hits equal phase 7's; a `--profile` run with
   `train.tensorboard_dir` (the trace names K1fr's and K1br's kernels,
   as often as the step's graph replays and warm-up steps run them, the
   event file equals metrics.jsonl); a fit with debug_nans; and, after
   phase 9, one inline config-5 step on the mesh with
   `detector.roi_impl=pallas` (K2 and K5 once). Two ranks cannot share
   one card (NCCL refuses a duplicate GPU in a communicator), so the card
   checks the DP code on a world of one; equality across ranks rests on
   the CPU tests over gloo.
13. frame parallelism and multi-host (main path 9; run after phase 12,
   on phase 5's data): `torchrun --nnodes 1 --nproc_per_node 1 -m
   nafae_torch.train --multihost` (NCCL, a world of one, started with
   phase 12's CLI runs), whose metrics.jsonl equals the in-process DP
   run's bit for bit; 4 spawned ranks, every one a process on cuda:0 over
   gloo (`make_mesh(..., backend="gloo")`, collectives staged through host
   memory), train 3 f32 steps of config4 at full width (B=16, T=20, R=20,
   D=2048, E=256) on 1x2, 2x2 and 1x4 meshes (1x4 at w=6 > T_local=5) on
   each route: equal across ranks, equal to the single-device step on the
   card (metrics, every step's reduced gradients, params, centers), each
   rank launching K1fr and K1br once a step, K4f and K4b once on pallas,
   K3 never, and sending the halo bytes its shapes give; the step host to
   host on each mesh; K1fr/K1b/K1br and K4f/K4b against their plain
   versions on two ranks' T_local inputs with real halos, f32 and bf16,
   timed with their bounds at the 2x2 rank's.
14. the device-resident dataset, steps_per_call, the C++ packer and grain
   (run after phase 13, on phase 5's data): (a) `fit` with
   `train.device_cache=true`, f32, both routes, 7 steps in calls of 3
   (rows at steps 3, 6, 7; per step auto K1fr 1, K1br 1, pallas also K3
   2, K4f 1, K4b 1), bit for bit train_step over the same index stream
   gathered on the host, the auto run's first 3 steps re-run on the CPU
   a row a step; (b) the streaming fit at steps_per_call 3 on a seeded
   two-bucket dataset at config-4 widths (segments of 6-20 frames,
   buckets (10, 20)), on the card (auto's launches a step) and on the
   CPU: the same segment ids applied in the same order, out of the
   loader's yield order, the rows through step 3 and the params after it
   within the CPU bounds, batches packed in C++; (c) the cached fit on
   phase 12's world-of-one NCCL mesh bit for bit the run without one, and
   on a 1x2 gloo world of two processes on cuda:0 (each caching half of
   the frames) within phase 13's tolerances of the single device; (d)
   `build_cache` of 2,560 seeded f16 segments (4.19 GB of features): its
   seconds and device memory, and a step on a batch gathered from it; (e)
   the f32 auto step host to host, streaming against cached, interleaved,
   with the card's busy time and idle share, and `fit`'s own rows a step
   streaming with the C++ packer, with the Python packer, and cached;
   (f) phase 5's batches packed
   by the C++ packer and by Python bit for bit equal in f32 and f16, the
   ms to pack each way; (g) 3 steps of `fit` with `data.pipeline=grain`
   (its first batch grain's order); (b) and (g) record the batches where
   `fit` hands them to the step function `build_train_fn` returns.
15. the training step as one device program (run after phase 14, on
   phase 5's data): `fit` now replays the config-4 step captured in CUDA
   graphs (`build_train_fn`). (a) f32 and bf16, both routes, streaming
   and cached, steps_per_call 1 and 3, 7 steps refreshing the k-means
   centers every 3 (both graphs replayed): rows, params, centers and
   optimizer state bit for bit `train_step` run eagerly on the card over
   the same batches; (b) launches per_step_launches x steps, two graphs
   and a replay a step, no eager step but a k-means++ seeding step 0
   (a seeded run, bit for bit too); (c) phase 14 (b)'s two buckets at
   steps_per_call 3: a graph pair a bucket, its order, bit for bit the
   eager chain; (d) the selection bank over a ring of 4 slots (it
   wraps), bank included; (e) phase 12's world-of-one NCCL mesh with its
   collectives captured, bit for bit the graphed run without a mesh; (f)
   stopped at step 4 and resumed to 7 (captured after the restore), bit
   for bit the uninterrupted run; (g) the step host to host graphed
   against eager, cached and on prepacked streaming batches, with the
   card's busy time and idle share, `fit` from the cache a row a step,
   the capture seconds and the graph pool's reserved bytes.
16. serving, eval, extraction and the config-5 step as device programs
   (run after phase 10, on the serving phase's requests and val split and
   phase 9's videos); phases 4, 7, 9, 10 and 11 now run them too, their
   launch counts held as before, counted once a replay, and phases 9 and
   10 print each run's graphs and pool bytes. (a) the serving graph of
   f32, bf16, int8 and int8pre servers bit for bit `make_ground_fn`
   called eagerly on every batch, K1f once a batch; (b) eval's graph
   (config1, oracle params, then a random w_v in a second `evaluate`)
   with the hits of `eval_batch` called eagerly, each call its own; (c)
   the extract graph bit for bit the detector's eager outputs on 8-frame
   chunks, K2 once a chunk; (d) config-5 `fit`, 3 steps each of the f32
   preset, roi_impl=pallas and the bf16 detector, captured (two graphs, a
   replay a step) and bit for bit the eager `train_step` chain with the
   same detector, K2 (and K5) once a step; (e) one replayed pallas-RoI
   step traced names K2, K5, K1fr and K1br as counted; and the serving
   batch (f32, int8pre), eval's wall seconds, an extract chunk and the
   config-5 step (f32, bf16) graphed against eager, with the copy, the
   idle share, the pool's bytes and the peak memory.
17. every shape the reference takes (run after phase 16, in a child
   process of its own, on the serving phase's requests, phase 5's data
   and an R = 36 split written there): (a) K1f, K1fr, K1b and K1br's
   general variant against their plain versions at R = 33, 36 and 65, E =
   3, 50, 516 and 1024, w = 17 and 20 (w >= T), real halos, an invalid
   centre frame, a frame with no valid region, f32 and bf16, and
   repeatable bit for bit; (b) config4 servers at R = 36 / E = 1024 (f32,
   bf16) and int8pre at E = 50: every batch from the graph bit for bit
   its eager body, K1f once a batch, a traced replay naming the general
   variant's kernels, box accuracy over 0.5, one batch against a CPU
   re-run; (c) config4 `fit` (auto) 3 f32 and 3 bf16 steps at R = 36 /
   E = 1024 / w = 3 and at E = 50 / w = 20: graphed bit for bit the eager
   chain, K1fr and K1br once a step, a traced replay naming the general
   variant's kernels, rows against a CPU re-run, f32 gradients within
   (1e-4, 1e-5 x largest) of the CPU's where the same rounded to bf16
   fall outside; (d) the four kernels' times there beside plain and
   bound, and K1f's SDPA yardstick; (e) config1 eval of the R = 36
   split, hits card = CPU; (f) int8_matmul at M = 5 and 16, N = 50 and K
   = 2043, bit for bit the int64 product.
18. model.matmul_precision=default (TF32 for the f32 products of the
   training step's losses and their gradient) against highest (run after
   phase 17, in a child process of its own, on phase 5's data, phase 17's
   R = 36 split and phase 9's videos): (a) at config 4 f32 on both routes,
   one eager step of each mode from one state on one batch: the loss terms
   within 2e-3, grad_norm within 1e-2; the step's discrete choices (the
   MIL max's region, r*, c*) recorded, the flips counted, and on the auto
   route a `default` step replaying highest's choices holds every gradient
   leaf within 1e-2 of its largest entry; some leaf outside phase 17's
   ANY_GRAD_TOL (TF32 reached the products); (b) the `default` step
   program graphed, bit for bit the eager chain, its launches counted; (c)
   a traced replay in each mode names that mode's projection GEMM kernel;
   (d) the projection's forward and weight-gradient GEMMs at config 4 and
   R = 36 / E = 1024 in each mode (device ms, bound, kernel names); (e)
   the cached step host to host, busy and idle in each mode, interleaved,
   at config 4 (both routes) and R = 36 / E = 1024 / w = 3; (f) a 2-step
   config-5 fit under `default`, captured, its rows held to phase 9's f32
   rows, and the config-5 step on a resident batch in each mode.
19. the JAX package's orbax checkpoint (run after phase 18, in this
   process, on data of its own): tests/data/orbax_config4/, its
   `CheckpointManager.save` of `TrainState.create(PRNGKey(0), config4)`
   at full width, with expected.json (the leaves' sha256s as JAX restores
   them, the JAX package's first fit row from it and its eval with its
   params, and the synthetic splits those ran on, which the port's
   generator writes here). (a) `CheckpointManager.restore_latest` and
   `load_eval_params` restore it on the card, every leaf's sha256 equal
   (the host seconds of each printed); (b) a graphed f32 GroundingServer
   serves the val split from those params (K1f launched, a batch held
   against a CPU re-run) and `evaluate_config` gives the JAX package's
   eval (num_annotations and hits equal, accuracies within 1e-12); (c)
   `fit` for one step in a copy of the checkpoint directory on each route,
   CUDA graphs on: it resumes from the orbax step, its first row within
   phase 13's (3e-4, 1e-5) of the JAX package's, state_1.pt written beside
   the untouched step directory, K1fr and K1br launched (pallas also K3,
   K4f and K4b; each kernel's `launches_orbax` in the kernels line).
20. model.dtype=float16 (run after phase 19, in a child process of its
   own, on phase 5's data and the serving phase's requests): (a) K1f,
   K1fr, K1b and K1br launched on f16 tensors against their plain
   versions at f16 (context_mix_bwd_plain for the backward: the kernels'
   rounding points) at CTX_CASES, phase 17's general and wide shapes (R =
   33 to 81, E = 3 to 1024, w = 17 and 20) and both sets of halo cases,
   with du as drawn and scaled into f16's subnormal range: each within
   F16_REL of its norm and F16_MAX of its largest entry, the same plain
   versions at bf16 (the control) outside F16_REL; (b) config4 `fit` at
   float16 on the auto route, streaming and from the device cache (K1fr +
   K1br) and with ALPHA_RESIDUAL off (K1f + K1b): graphed bit for bit the
   eager chain, launches a step, a traced replay naming the `__half`
   instantiations and no other, rows against a CPU re-run, and one step's
   gradients within F16_GRAD_TOL of the CPU's (the card's bf16 step
   outside); (c) a config4 server at float16 and its exported artifact
   bit for bit the f32 server (serving computes in f32 at float16, as the
   reference's does), K1f launched as often; (e) the four kernels' device
   ms at f16 beside bf16's (in turns), bound, plain and K1f's SDPA
   yardstick at f16, at config 4 and R = 36 / E = 1024 / w = 3, and the
   cached config4 step's host, busy and idle at f32, bf16 and f16. Each K1
   kernel's entry of the kernels line carries its f16 numbers (*_f16,
   f16_<shape>).
21. The fused route and the detector at float16 (run after phase 20, in a
   child process of its own, on phase 5's data, phase 9's videos and
   phase 10's VGG16 checkpoint): (a) K3, K4f and K4b launched on f16
   operands against their plain versions at f16 over phase 3's, phase
   17's, config 4's K = 40 and the DP ranks' shapes, K4b with dctx as
   drawn and at the config-4 step's scale (F16B_STEP_DCTX: ds an f16
   subnormal), each output within F16B_REL (ctx F16B_REL_CTX) of its norm
   and F16B_MAX of its largest entry, the bf16 plain versions outside;
   idx, r* and c* equal where clear of ties; (b) config4 `fit` with
   train.kernels=pallas at float16, streaming (steps_per_call 3) and
   cached: graphed bit for bit the eager chain, K3 twice and K4f, K4b,
   K1fr, K1br once a step, a traced replay naming the `__half`
   instantiations, rows against a CPU re-run, one step's gradients card
   against CPU within F16_GRAD_TOL (bf16 outside), and one step with
   train.use_pallas=true; (c) K5 on the f16 detector's first config-5 map
   and NMS boxes and on phase 9's edge cases against its plain version at
   f16 (bf16 control outside), and K2 on that detector's planes; (d)
   config-5 fits at detector.dtype=float16 at full width, 4 steps graphed
   each: ResNet-50 with a f32 model and roi_impl separable, ResNet-50 and
   VGG16 (B=16) with an f16 model and roi_impl=pallas: the loss falls,
   bit for bit the eager chain, K2 (and K5) launched a step, the
   backbone's largest |activation| against f16's 65504; the f16 step card
   against CPU at a reduced size, stage by stage (the bf16 detector
   outside); VGG16's fc6/fc7 at f16 with and without cuBLAS's
   reduced-precision f16 sums; one `python -m nafae_torch.extract` at
   detector.dtype=float16 against the inline detector; (e) K3, K4f, K4b
   and K5 device ms at f16 beside bf16's (in turns), bound, plain at f16
   and K3's matmul + max at f16; the config4 pallas step from the cache
   and the config-5 step with a bf16 and an f16 detector (host to host,
   resident, busy, idle), in turns. K3's, K4f's, K4b's and K5's entries
   of the kernels line carry their f16 numbers (max_abs_err_f16,
   launches_f16, f16_times).

The line before the last is the card as `nvidia-smi` names it; the one
before that is a JSON object with each kernel's numbers; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import gc
import hashlib
import json
import os
import shutil
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
# card against CPU, f32: params after CPU_STEPS steps, as the norm of their
# difference over the norm of the CPU run's update of each leaf (Adam can
# swing an entry whose gradient is within rounding of zero by a whole step,
# so no entry-wise bound holds)
CPU_UPDATE_TOL = 1e-3
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
# ... with real halo frames, as a frame-parallel shard has them (B, T, R, E,
# w): w > T (each halo from two shards), config4's 2x2 shard, R = 32
CTX_HALO_CASES = [(4, 5, 20, 256, 6), (8, 10, 20, 256, 3),
                  (3, 2, 32, 64, 4)]
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


def ctx_inputs(torch, gen, b, t, r, e, w, device, edges=False,
               halos=False):
    """l2-normalized regions with random frame and region masks, incl. a
    valid frame whose regions are all invalid (the uniform-alpha group).
    edges (T >= 2w + 4): the last video gets a valid centre frame whose
    every neighbour is invalid (cnt = 0, u = 0) and an invalid centre frame
    between two valid ones. halos: the 2w halo frames are real frames with
    their own random masks, as a frame-parallel shard receives them from
    its neighbours; else zero padding (invalid halo frames)."""
    F = torch.nn.functional
    if halos:
        t += 2 * w
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
    if halos:
        return v.to(device), fm.to(device), rm.to(device)
    return (F.pad(v, (0, 0, 0, 0, w, w)).to(device),
            F.pad(fm, (w, w)).to(device),
            F.pad(rm, (0, 0, w, w)).to(device))


def check_ctx_mix(torch, device, cases=CTX_CASES, halo_cases=CTX_HALO_CASES,
                  seed=SEED) -> dict[str, float]:
    """K1f against its plain version on the card, at `cases` and, with real
    halo frames, `halo_cases`; returns the max |u| error per dtype."""
    from nafae_torch.ops.kernels import ctx_mix as K

    gen = torch.Generator().manual_seed(seed)
    errs = {}
    for dt_name, dt in (("float32", None), ("bfloat16", torch.bfloat16)):
        rtol, atol = CTX_TOL[dt_name]
        worst = 0.0
        for b, t, r, e, w, with_rm, edges, halos in (
                [c + (False,) for c in cases]
                + [c + (True, False, True) for c in halo_cases]):
            v_ext, fm_ext, rm_ext = ctx_inputs(torch, gen, b, t, r, e, w,
                                               device, edges, halos)
            rm_ext = rm_ext if with_rm else None
            u, nv = K.ctx_mix(v_ext, fm_ext, w, 0.1, dtype=dt, rm_ext=rm_ext)
            torch.cuda.synchronize()
            up, nvp = K.context_mix_plain(v_ext, fm_ext, w, 0.1, dtype=dt,
                                          rm_ext=rm_ext)
            case = (f"{dt_name} B={b} T={t} R={r} E={e} w={w} rm={with_rm} "
                    f"edges={edges} halos={halos}")
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
            f"(rtol {rtol}, atol {atol}, {len(cases)} cases and "
            f"{len(halo_cases)} with real halo frames)")
    return errs


def compare_grad_kernels(torch, vc, fm_ext, rm_ext, w, du, dt_name,
                         case) -> dict[str, float]:
    """K1fr (u, alpha), K1b and K1br (dv_ext) on vc (in the compute dtype)
    against the plain version on the same card, each backward launched
    twice and equal bit for bit; fails beyond the limits, logs dv's errors
    beside the largest |dv| and returns the max |error| of each (and the
    largest |dv| as "dv_max")."""
    from nafae_torch.ops.kernels import ctx_mix as K

    dt = torch.bfloat16 if vc.dtype == torch.bfloat16 else None
    u, alpha = K.launch_fwd(vc, fm_ext, w, 0.1, rm_ext, residual=True)
    dv_rec = K.launch_bwd(vc, fm_ext, w, 0.1, rm_ext, du)
    dv_res = K.launch_bwd(vc, fm_ext, w, 0.1, rm_ext, du, alpha)
    again = (K.launch_bwd(vc, fm_ext, w, 0.1, rm_ext, du),
             K.launch_bwd(vc, fm_ext, w, 0.1, rm_ext, du, alpha))
    torch.cuda.synchronize()
    if not (torch.equal(again[0], dv_rec) and torch.equal(again[1], dv_res)):
        fail(f"K1b or K1br: two launches on one input gave dv that differ: "
             f"{case}")
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


def check_grad_cases(torch, device, gen, cases) -> dict[str, dict]:
    """compare_grad_kernels at each of `cases` ((B, T, R, E, w, region
    mask, edges, halos); du from gen) in f32 and bf16; returns the max
    errors by kernel and dtype."""
    errs = {}
    for dt_name, dt in (("float32", None), ("bfloat16", torch.bfloat16)):
        worst = dict.fromkeys(("ctx_mix_fwd_res", "alpha", "ctx_mix_bwd",
                               "ctx_mix_bwd_res"), 0.0)
        for b, t, r, e, w, with_rm, edges, halos in cases:
            v_ext, fm_ext, rm_ext = ctx_inputs(torch, gen, b, t, r, e, w,
                                               device, edges, halos)
            du = torch.randn(b, t, r, e, generator=gen).to(device)
            got = compare_grad_kernels(
                torch, v_ext.to(dt) if dt is not None else v_ext, fm_ext,
                rm_ext if with_rm else None, w, du, dt_name,
                f"{dt_name} B={b} T={t} R={r} E={e} w={w} rm={with_rm} "
                f"edges={edges} halos={halos}")
            worst = {k: max(worst[k], got[k]) for k in worst}
        errs[dt_name] = worst
        log(f"K1fr/K1b/K1br vs plain, {dt_name}: max |err| "
            + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
            + f" (u {CTX_TOL[dt_name]}, alpha {ALPHA_TOL[dt_name]}, dv "
            f"{GRAD_TOL[dt_name]} as rtol, atol, in bf16 below E = "
            f"{GRAD_NARROW_E} atol x largest |dv|; every backward launched "
            f"twice, equal bit for bit; {len(cases)} cases)")
    return errs


def check_repeatable(torch, device, gen, b, t, r, e, w) -> None:
    """f32 u, alpha and dv are the same on every run (no atomics, one order
    of sums): K1f and K1fr launched twice each, then K1br and K1b, on one
    input of this shape."""
    from nafae_torch.ops.kernels import ctx_mix as K

    v_ext, fm_ext, rm_ext = ctx_inputs(torch, gen, b, t, r, e, w, device)
    du = torch.randn(b, t, r, e, generator=gen).to(device)
    runs = [K.launch_fwd(v_ext, fm_ext, w, 0.1, rm_ext, residual=res)
            for res in (False, False, True, True)]
    torch.cuda.synchronize()
    if not (torch.equal(runs[0][0], runs[1][0])
            and torch.equal(runs[2][0], runs[3][0])
            and torch.equal(runs[2][1], runs[3][1])):
        fail("K1f/K1fr: two launches on the same f32 inputs gave u or alpha "
             "that differ")
    alpha = runs[2][1]
    for name, a in (("ctx_mix_bwd_res", alpha), ("ctx_mix_bwd", None)):
        first = K.launch_bwd(v_ext, fm_ext, w, 0.1, rm_ext, du, a)
        second = K.launch_bwd(v_ext, fm_ext, w, 0.1, rm_ext, du, a)
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            fail(f"{name}: two launches on the same f32 inputs gave dv that "
                 "differ")
    log("K1f and K1fr: two launches give bitwise-equal f32 u and alpha; K1br "
        f"and K1b: bitwise-equal f32 dv (B={b} T={t} R={r} E={e} w={w})")


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
    cases = [c + (False,) for c in CTX_CASES + [
        (4, 6, 20, 12, 3, True, False),     # E within one 64-column slice,
        (4, 6, 20, 36, 2, True, False),     # ... not a multiple of 8
        (4, 6, 20, 100, 2, True, False)]] + [
        c + (True, False, True) for c in CTX_HALO_CASES]
    errs = check_grad_cases(torch, device, gen, cases)

    check_repeatable(torch, device, gen, 16, 20, 20, 256, 3)

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


def check_cross_mil(torch, device, cases=CROSS_CASES,
                    seed: int = SEED + 2) -> dict[str, float]:
    """K3 against its plain version on the card, on `cases` (CROSS_CASES:
    config4's training shapes (I=16 videos, M=B·K=128 words, T=20, R=20,
    E=256), R from 1 to 100 (one frame over two chunks of regions), M = 1
    and 129, T = 1, E from 4 to 512, no region mask, a video with no valid
    frame, and exact ties between regions r and r + 32, r and the last row,
    and across a chunk); each masked case with a valid frame whose regions
    are all masked. Every launch is repeated and must give the same bits.
    Returns the max |a| error per dtype."""
    from nafae_torch.ops.kernels import cross_mil as K3

    gen = torch.Generator().manual_seed(seed)
    rtol, atol = CROSS_TOL
    errs = {}
    for dt_name, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        worst = 0.0
        for i, m, t, r, e, with_rm, ties, dead_video in cases:
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
            again = K3.launch(w, v, fm, rm)
            torch.cuda.synchronize()
            if not (torch.equal(a, again[0]) and torch.equal(idx, again[1])):
                fail(f"cross_mil: two launches on one input differ: {case}")
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
            f"{TIE_GAP}, exact ties to the first region; every launch "
            f"twice, equal bit for bit; {len(cases)} cases)")
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


def check_diag(torch, device, cases=DIAG_CASES,
               seed: int = SEED + 3) -> dict[str, dict[str, float]]:
    """K4f and K4b against their plain versions on the card, on `cases`
    (DIAG_CASES: config4's shapes (B=16, K=8, T=20, R=20, E=256, Kc=67), no region mask,
    K from 1 to 32 (at E = 256 and 512), E from 4 to 512, R from 1 to 40 (one past a chunk of 32
    regions), Kc from 1 to 130, T = 1, exact ties between regions and
    between centers (8 and 16, 2 and 5; 3 and 35, across 32) and a video
    with no valid frame; each masked case with a valid frame whose regions
    are all masked and frames without context). Every launch is repeated
    and must give the same bits. Returns the max errors by output and
    dtype."""
    gen = torch.Generator().manual_seed(seed)
    errs = {}
    for dt_name, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        worst: dict[str, float] = {}
        for b, k, t, r, e, kc, with_rm, ties_r, ties_c, dead, *off in cases:
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
            if off and off[0]:                # every second frame: no ctx
                hc[:, 1::2] = 0.0
            got = compare_diag(
                torch, *(x.to(dt).to(device) for x in (w, v, u)),
                *(x.to(device) for x in (centers, fm, hc)),
                rm.to(device) if with_rm else None,
                f"{dt_name} B={b} K={k} T={t} R={r} E={e} Kc={kc} "
                f"rm={with_rm} ties={ties_r}/{ties_c} dead_video={dead}"
                + (" every second frame without context" if off and off[0]
                   else ""),
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
            f"equal bit for bit; {len(cases)} cases)")
    return errs


# ------------------------------------------------------------- serving


def make_requests(root: str, regions: int = 20):
    """Synthetic config4-width segments of `regions` regions (with their
    ground truth), written as root's val split."""
    from nafae_torch.data.synthetic import generate_synthetic_dataset

    generate_synthetic_dataset(root, "val", num_segments=NUM_SEGMENTS,
                               feat_dim=2048, num_regions=regions,
                               max_frames=20, max_words=4, seed=SEED)
    return read_requests(root)


def read_requests(root: str, split: str = "val"):
    """A split's segments as serving requests, and their ground truth."""
    segs, gts = [], []
    with open(os.path.join(root, split, "index.jsonl")) as f:
        index = [json.loads(ln) for ln in f if ln.strip()]
    for meta in index:
        with np.load(os.path.join(root, split, meta["file"])) as z:
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
            {k: v.tolist() if isinstance(v, np.ndarray) else v
             for k, v in s.items()} for s in segs]}).encode()
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


def make_train_data(root: str, regions: int = 20, words: int = 8) -> None:
    """Planted-signal config4-width training segments (K up to `words`
    words) of `regions` regions."""
    from nafae_torch.data.synthetic import generate_synthetic_dataset

    generate_synthetic_dataset(root, "train", num_segments=TRAIN_SEGMENTS,
                               feat_dim=2048, num_regions=regions,
                               max_frames=20, max_words=words, seed=SEED)


def train_cfg(root: str, ckpt: str, dtype: str, steps: int,
              kernels: str = "auto", extra=()):
    from nafae_torch.config import load_config

    return load_config(preset_name="config4", overrides=TRAIN_OVERRIDES + [
        f"data.root={root}", f"train.ckpt_dir={ckpt}", f"model.dtype={dtype}",
        f"train.steps={steps}", f"train.kernels={kernels}", *extra])


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


def first_batch(root: str, regions: int = 20, words: int = 8):
    """The first training batch (numpy), as fit's loader gives it."""
    from nafae_torch.data.loader import BatchLoader
    from nafae_torch.data.youcook2 import SegmentDataset

    ds = SegmentDataset(root, "train", 20, regions, 2048, words)
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
    cfg = train_cfg(root, os.path.join(tmp, f"ck_cpu_{kernels}"), "float32",
                    CPU_STEPS, kernels)
    cpu_logs = run_fit(torch, cfg, device="cpu")
    worst = cpu_rows_agree(logs, cpu_logs, f"training ({kernels})")
    gworst = grads_agree(torch, cfg, first_batch(root), kernels)
    rtol, atol = CPU_METRIC_TOL
    grtol, gatol = CPU_GRAD_TOL
    log(f"CPU re-run of the first {CPU_STEPS} f32 training steps "
        f"(kernels={kernels}): metrics "
        f"agree, max relative diff {worst:.3e} (limit rtol {rtol}, atol "
        f"{atol}); one step's gradients agree, max |diff| / largest entry "
        f"{gworst:.3e} (limit rtol {grtol}, atol {gatol} x largest entry)")
    return {"metric_rel_diff": worst, "grad_rel_diff": gworst}


def grad_gap(torch, got: dict, want: dict, tol: tuple) -> tuple:
    """(largest |diff| / largest entry over the leaves, the leaves of `got`
    outside `tol` of `want`: rtol, and atol as a fraction of each leaf's
    largest entry)."""
    grtol, gatol = tol
    worst, bad = 0.0, []
    for k, w in want.items():
        scale = max(w.abs().max().item(), 1e-30)
        worst = max(worst, (got[k] - w).abs().max().item() / scale)
        if not torch.allclose(got[k], w, rtol=grtol, atol=gatol * scale):
            bad.append(k)
    return worst, bad


def grads_agree(torch, cfg, batch, kernels: str) -> float:
    """One step's gradients on `batch` from the initial state, card
    against CPU, within CPU_GRAD_TOL; returns the largest |diff| / largest
    entry."""
    from nafae_torch.train import TrainState

    grads = {dev: step_grads(torch, cfg, TrainState.create(cfg, device=dev),
                             batch, kernels)[1] for dev in ("cuda", "cpu")}
    gworst, bad = grad_gap(torch, grads["cuda"], grads["cpu"], CPU_GRAD_TOL)
    if bad:
        fail(f"gradients of {bad}: card and CPU differ by up to {gworst:.3e} "
             f"of the largest entry (limit {CPU_GRAD_TOL})")
    return gworst


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


def eval_cfg(root: str, ckpt: str, extra=()):
    from nafae_torch.config import load_config

    return load_config(preset_name="config1", overrides=[
        f"data.root={root}", f"train.ckpt_dir={ckpt}", *extra])


def eval_near_ties(torch, cfg, params) -> int:
    """Annotated (word, frame) pairs whose top two region scores on the CPU
    are within TIE_GAP: their argmax may go either way on another device."""
    from nafae_torch.data.loader import BatchLoader
    from nafae_torch.data.youcook2 import SegmentDataset
    from nafae_torch.evaluate import masked_scores
    from nafae_torch.models.grounding import inference_params

    ds = SegmentDataset(cfg.data.root, "val", cfg.data.max_frames,
                        cfg.data.num_regions, cfg.data.feat_dim,
                        cfg.data.max_words, with_gt=True,
                        keep_int8=cfg.model.quantize == "int8pre")
    params = inference_params(cfg, {k: torch.as_tensor(v).cpu()
                                    for k, v in params.items()})
    near = 0
    for batch in BatchLoader(ds, cfg.data.batch_size, shuffle=False,
                             drop_remainder=False):
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        top2 = masked_scores(params, tb).topk(2, dim=-1).values
        near += int(((top2[..., 0] - top2[..., 1] <= TIE_GAP)
                     & (tb["gt_mask"] > 0)).sum())
    return near


def eval_card_vs_cpu(torch, cfg, params, name: str) -> dict:
    """`evaluate_config` of `cfg` on the card, then on the CPU: equal
    num_annotations, hit counts equal but for pairs whose top two scores
    are within TIE_GAP, finite accuracies, no kernel launched."""
    from nafae_torch.evaluate import evaluate_config
    from nafae_torch.utils.checkpoint import load_eval_params

    zero_counts()                               # eval starts here
    t0 = time.perf_counter()
    card = evaluate_config(cfg, params=params, require_checkpoint=True,
                           device="cuda")
    wall = time.perf_counter() - t0
    counts = read_counts()                      # ... and ends here
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
    log(f"eval ({name} params, config1 preset, {card['num_annotations']} "
        f"annotations): box accuracy micro {card['box_acc_micro']:.6f}, "
        f"macro {card['box_acc_macro']:.6f} on the card in {wall:.2f} s; "
        f"hits card {hits['card']} / CPU {hits['cpu']}")
    return {"card": {k: v for k, v in card.items() if k != "per_class_acc"},
            "hits": hits, "near_ties": near, "wall_s": wall}


def check_eval(torch, root: str, tmp: str, served_acc: float) -> dict:
    """The eval path (main path 4): `evaluate_config` under the config1
    preset, on the card, over the val split (written here if the data has
    none), first with the planted-signal oracle params (its micro accuracy
    must equal the f32 server's box accuracy on the same segments), then on
    the config-4 state that the f32 auto training run checkpointed, restored
    from its directory; both re-run on the CPU, where num_annotations and
    the hit counts must be equal (a pair whose top two scores are within
    TIE_GAP may go either way). Eval launches no kernel of the port."""
    if not os.path.exists(os.path.join(root, "val", "index.jsonl")):
        make_requests(root)
    ckpt = os.path.join(tmp, f"ck_{ROUTES[0]}_float32")
    cfg = eval_cfg(root, ckpt)
    out = {name: eval_card_vs_cpu(torch, cfg, params, name)
           for name, params in (("oracle", oracle_params()),
                                ("trained", None))}
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
        fitted = traced_fit(torch, cfg, record=False)
        counts = read_counts()                  # ... and ends here
        logs, wall = fitted["logs"], fitted["wall_s"]
        if len(logs) != steps or not all(
                np.isfinite(v) for m in logs for v in m.values()):
            fail(f"config-5 training ({label}) logged {logs}")
        want = {k: n * steps for k, n in c5_launches(cfg).items()}
        if counts != want:
            fail(f"config-5 training ({label}) launched {counts}, "
                 f"expected {want}")
        # a k-means++ run seeds eagerly at step 0, then captures both
        # graphs at step 1
        st = expect_graphed(fitted, f"config-5 training ({label})", 2,
                            steps, int(cfg.loss.kmeans_init == "plusplus"))
        del fitted
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        peak_reserved = torch.cuda.max_memory_reserved() / 2 ** 30
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
            f"{counts}; peak device memory {peak:.2f} GiB allocated, "
            f"{peak_reserved:.2f} GiB reserved; captured in "
            f"{st['graphs']} graphs ({st['replays']} replays, "
            f"{st['eager_steps']} eager steps, {st['warmup_steps']} warm-up "
            f"steps, capture {st['capture_s']:.2f} s), the pool "
            f"{st['pool_bytes']} bytes")
        if not last < first:
            fail(f"config-5 training ({label}) did not lower the loss: "
                 f"{first} -> {last}")
        out[run] = {"logs": logs, "launches": counts, "peak_gib": peak,
                    "peak_reserved_gib": peak_reserved, "wall_s": wall,
                    "program": st}
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
        # -1e9 is past f16's range (it would be -inf, and an all-masked row
        # NaN): f16 masks with its most negative finite value
        neg = max(-1e9, torch.finfo(v_ext.dtype).min)
        mask = torch.where(rm_ext[:, idx] > 0, 0.0, neg).to(v_ext.dtype)
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
    params = srv.params
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
            params, tb["feats"], tb["boxes"], tb["word_ids"],
            tb["frame_mask"], tb["word_mask"], tb["region_mask"]))
        (res["kernels_by_device_time"], res["device_busy_ms"],
         _) = profile_forward(
            torch, lambda: srv._fn(params, tb["feats"], tb["boxes"],
                                   tb["word_ids"], tb["frame_mask"],
                                   tb["word_mask"], tb["region_mask"]))
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


def bound(torch, nbytes: float, flops: float, dtype,
          peak: float | None = None) -> tuple[float, str]:
    """(least ms, what bounds it): `nbytes` over the memory rate against
    `flops` over the peak rate for the operands' type (f32 CUDA cores, or
    bf16 and f16 tensor cores, the same rate), or over `peak` where
    given."""
    peak = peak or (H100_BF16_FLOPS
                    if dtype in (torch.bfloat16, torch.float16)
                    else H100_F32_FLOPS)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs if x is not None)


def fused_inputs(torch, root: str, tmp: str, extra=()):
    """The fused route's inputs on the first training batch (config4, B=16,
    K=8, T=20, R=20, E=256, Kc=67, its own masks; `extra`: overrides of
    the config, data.num_regions and data.max_words as the split at `root`
    was written), from the initial params: (w_emb, v_emb, u, centers, fm,
    rm, hc) on the card, f32."""
    from nafae_torch.ops import grounding as TG
    from nafae_torch.train import TrainState, batch_to_device

    dev = torch.device("cuda")
    cfg = train_cfg(root, os.path.join(tmp, "ck_fused"), "float32", 1000,
                    "pallas", extra=extra)
    tb = batch_to_device(first_batch(root, cfg.data.num_regions,
                                     cfg.data.max_words), dev)
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
    against its plain version here (fused_kernel_times)."""
    return fused_kernel_times(torch, fused_inputs(torch, root, tmp))


def fused_kernel_times(torch, ins, dense: bool = True) -> dict:
    """fused_timings' numbers on the inputs `ins` (fused_inputs'); the
    dense variant only with `dense`."""
    from nafae_torch.ops.kernels import cross_mil as K3
    from nafae_torch.ops.kernels import diag as K4

    dev = torch.device("cuda")
    w_emb, v_emb, u, centers, fm, rm, hc = ins
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
            torch, lambda: K3.launch_floor(b, m, t, r, e, dt, dev))
        res["cross_mil_bound_ms" + tag], res["cross_mil_bound_by" + tag] = \
            bound(torch, nbytes(wf, fm, rm) + live * row + 2 * b * m * t * 4,
                  2 * m * e * live, dt)
        res["diag_floor_ms" + tag] = device_ms(
            torch, lambda: K4.launch_floor_fwd(b, k, t, r, e, kc, dt, dev))
        res["diag_bwd_floor_ms" + tag] = device_ms(
            torch, lambda: K4.launch_floor_bwd(b, k, t, r, e, dt, dev))
        gen = torch.Generator().manual_seed(SEED + 5)
        dctx = torch.rand((b, k, t), generator=gen).to(dev)
        dclu = torch.rand((b, k, t), generator=gen).to(dev)
        variants = [("", (fm, hc, rm))]
        if dense:
            variants.append(("_dense", (ones_t, ones_t, ones_r)))
        for var, (fmv, hcv, rmv) in variants:
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


# ------------------------------------ int8 serving, export and visualize


QUANTIZE = ("int8", "int8pre")       # model.quantize of the int8 phases
# card against CPU for a batch of the int8 servers (and of phase 17's bf16
# server): scores and frame weights within this (f32 as the f32 server's
# HTTP check; bf16 at the reference's bf16 tolerance), regions equal where
# the CPU's top two scores are further apart than it
SERVE_CPU_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# exported artifacts: kind -> (model.quantize, export's storage quantize)
ARTIFACTS = {"f32": ("", None), "storage_int8": ("", "int8"),
             "int8": ("int8", None), "int8pre": ("int8pre", None)}
ARG_KEYS = ("feats", "boxes", "word_ids", "frame_mask", "word_mask",
            "region_mask")
AB_ROUNDS = 10                   # interleaved host-to-host rounds (A/B)
VIZ_SEGMENTS = 8


def serve_cfg(dt: str, quantize: str):
    from nafae_torch.config import load_config

    return load_config(preset_name="config4", overrides=[
        f"model.dtype={dt}", f"model.quantize={quantize}"])


def prequantized(segs: list[dict]) -> list[dict]:
    """The segments in the `extract --quantize int8` wire format."""
    from nafae_torch.extract import quantize_feats_np

    out = []
    for seg in segs:
        q, sf = quantize_feats_np(seg["feats"])
        out.append({**seg, "feats": q, "feats_scale": sf})
    return out


def serving_batch(srv, segs) -> dict:
    """The first full batch of `segs` as the server pads it (numpy)."""
    samples = [srv._pad_segment(s) for s in segs[:srv.batch_size]]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def int8_operands(torch, srv, batch):
    """(q [N,D] int8, sf [N,1] f32, acc [N,E] int32) of srv's int8
    projection on one batch, on srv's device: int8pre's feats as they
    arrive, int8's quantized per row as project_regions_int8 does."""
    from nafae_torch.ops import grounding as TG

    f = torch.from_numpy(batch["feats"]).to(srv.device)
    f2 = f.reshape(-1, f.shape[-1])
    if "feats_scale" in batch:
        q = f2
        sf = torch.from_numpy(batch["feats_scale"]).to(srv.device)
        sf = sf.reshape(-1, 1)
    else:
        q, sf = TG.quantize_feats_int8(f2)
    return q, sf, TG.int8_matmul(q, srv.params["w_v.q8"])


def check_int8_operands(torch, srv, cpu, batch) -> None:
    """An int8 server's quantized weights, a batch's quantized feats, their
    scales and the int32 products, card (srv) against CPU (cpu), bit for
    bit."""
    what = f"{srv.cfg.model.quantize} {srv.cfg.model.dtype}"
    for k in ("w_v.q8", "w_v.scale8"):
        if not torch.equal(srv.params[k].cpu(), cpu.params[k]):
            fail(f"{what}: {k} differs between the card and the CPU")
    with torch.inference_mode():
        for name, a, b in zip(("quantized feats", "feature scales",
                               "int32 products"),
                              int8_operands(torch, srv, batch),
                              int8_operands(torch, cpu, batch)):
            if not torch.equal(a.cpu(), b):
                fail(f"{what}: the {name} differ between the card and the "
                     "CPU")


def check_batch_cpu_rerun(torch, cfg, params, srv, segs) -> dict:
    """One batch of a server re-run on the CPU through the plain versions:
    for an int8 server first check_int8_operands; regions and boxes equal
    where the CPU's top two scores are clear of SERVE_CPU_TOL; scores,
    frame weights and video scores within SERVE_CPU_TOL."""
    from nafae_torch.serve import GroundingServer

    dt, quantize = cfg.model.dtype, cfg.model.quantize or "no quantize"
    cpu = GroundingServer(cfg, params, device="cpu")
    batch = serving_batch(cpu, segs)
    if cfg.model.quantize:
        check_int8_operands(torch, srv, cpu, batch)
    with torch.inference_mode():
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        s = cpu.model(tb["feats"], tb["word_ids"], tb["frame_mask"],
                      tb["word_mask"], region_mask=tb["region_mask"],
                      feats_scale=tb.get("feats_scale"))["s"].float()
    card, host = srv.run_batch(batch), cpu.run_batch(batch)
    tol = SERVE_CPU_TOL[dt]
    top2 = s.topk(2, dim=-1).values.numpy()
    clear = top2[..., 0] - top2[..., 1] > tol                    # [B,K,T]
    valid = (batch["word_mask"][:, :, None]
             * batch["frame_mask"][:, None, :]) > 0
    moved = valid & (card["region"] != host["region"])
    if (moved & clear).any():
        fail(f"{quantize} {dt}: regions differ between the card "
             "and the CPU where clear of ties")
    same = valid & ~moved
    if not np.array_equal(card["box"][same], host["box"][same]):
        fail(f"{quantize} {dt}: boxes of equal regions differ")
    fm = batch["frame_mask"] > 0
    diff = max(float(np.abs(card["score"] - host["score"])[same].max()),
               float(np.abs(card["beta"] - host["beta"])[fm].max()),
               float(np.abs(card["video_score"]
                            - host["video_score"]).max()))
    if diff > tol:
        fail(f"{quantize} {dt}: card and CPU scores differ by "
             f"{diff} > {tol}")
    return {"cpu_max_diff": diff, "cpu_regions_moved_at_ties":
            int(moved.sum()), "cpu_pairs": int(valid.sum())}


def serve_int8(torch, params, segs, gts) -> dict:
    """Main path 7: config4 servers with model.quantize=int8 and int8pre,
    f32 and bf16, on the oracle params, over the serving phase's requests:
    K1f once a batch and no other kernel, box accuracy over ACC_BAR, one
    batch re-run on the CPU (check_batch_cpu_rerun); the f32 int8pre server
    also answers pre-quantized requests over HTTP as it answers f32 ones in
    process."""
    from nafae_torch.serve import GroundingServer

    out = {}
    for quantize in QUANTIZE:
        for dt in ("float32", "bfloat16"):
            cfg = serve_cfg(dt, quantize)
            srv = GroundingServer(cfg, params, device="cuda")
            batches = -(-len(segs) // srv.batch_size)
            zero_counts()                       # int8 serving starts here
            t0 = time.perf_counter()
            results = srv.ground_segments(segs)
            wall = time.perf_counter() - t0
            counts = read_counts()              # ... and ends here
            want = dict.fromkeys(counts, 0)
            want["ctx_mix_fwd"] = batches
            if counts != want:
                fail(f"{quantize} {dt} serving launched {counts}; K1f once "
                     f"a batch ({batches}) and nothing else expected")
            for res in results:
                vals = [fr["score"] for w in res["words"] for fr in w["frames"]]
                vals += res["frame_weights"] + [res["video_score"]]
                if not np.all(np.isfinite(vals)):
                    fail(f"{quantize} {dt} server returned non-finite values")
            acc = box_accuracy(torch, segs, results, gts)
            if acc < ACC_BAR:
                fail(f"{quantize} {dt} box accuracy {acc} < {ACC_BAR}")
            entry = {"box_acc": acc, "launches_ctx_mix_fwd":
                     counts["ctx_mix_fwd"], "batches": batches,
                     "wall_s": wall,
                     **check_batch_cpu_rerun(torch, cfg, params, srv, segs)}
            if quantize == "int8pre" and dt == "float32":
                pre = prequantized(segs)
                picks = [[0, 1], [2], [3, 4]]      # 3 concurrent requests
                answers = serve_over_http(
                    srv, [[pre[i] for i in p] for p in picks])
                worst = max(max_response_diff(ans, [results[i] for i in p])
                            for p, ans in zip(picks, answers))
                if worst > SERVE_CPU_TOL[dt]:
                    fail(f"int8pre HTTP answers to pre-quantized requests "
                         f"differ from the in-process ones by {worst}")
                entry["http_prequantized_max_diff"] = worst
            out[f"{quantize}_{dt}"] = entry
            log(f"served {len(segs)} segments with model.quantize={quantize}"
                f" ({dt}): box accuracy {acc:.4f} (bar {ACC_BAR}); K1f "
                f"{counts['ctx_mix_fwd']} launches in {batches} batches; CPU "
                f"re-run: weights, quantized feats, scales and int32 products "
                f"equal, regions equal where clear of ties "
                f"({entry['cpu_regions_moved_at_ties']} of "
                f"{entry['cpu_pairs']} moved at ties), max |diff| "
                f"{entry['cpu_max_diff']:.3e} (limit {SERVE_CPU_TOL[dt]})"
                + (f"; HTTP with pre-quantized requests: max |diff| "
                   f"{entry['http_prequantized_max_diff']:.3e}"
                   if "http_prequantized_max_diff" in entry else ""))
    return out


def write_int8_split(src_root: str, dst_root: str) -> None:
    """The val split of src_root rewritten as `extract --quantize int8`
    files (int8 feats + feats_scale, extract.quantize_feats_np)."""
    from nafae_torch.extract import quantize_feats_np

    src, dst = os.path.join(src_root, "val"), os.path.join(dst_root, "val")
    os.makedirs(dst, exist_ok=True)
    for name in os.listdir(src):
        if name.endswith(".npz"):
            with np.load(os.path.join(src, name)) as z:
                arrays = {k: z[k] for k in z.files}
            arrays["feats"], arrays["feats_scale"] = quantize_feats_np(
                arrays["feats"].astype(np.float32))
            np.savez(os.path.join(dst, name), **arrays)
        elif name == "index.jsonl":
            with open(os.path.join(src, name)) as f, \
                    open(os.path.join(dst, name), "w") as g:
                g.write(f.read())


def check_eval_int8(torch, root: str, tmp: str) -> dict:
    """config1 eval with model.quantize=int8 and int8pre over the val split
    written as int8 feature files, with the oracle params, on the card and
    on the CPU (eval_card_vs_cpu)."""
    root8 = os.path.join(tmp, "int8_feats")
    write_int8_split(root, root8)
    return {quantize: eval_card_vs_cpu(
        torch, eval_cfg(root8, tmp, [f"model.quantize={quantize}"]),
        oracle_params(), f"oracle, model.quantize={quantize}")
        for quantize in QUANTIZE}


def check_export(torch, params, segs, tmp: str) -> dict:
    """The exported serving artifact: f32, stored int8 (through the serve
    CLI's --export --quantize int8), int8 compute and int8pre, exported on
    the card; each loaded by `load_exported` in a fresh subprocess
    (artifact_child) that must answer the first batch bit for bit as the
    live server here does, launching K1f once; the f32 and int8pre ones
    also timed there against a live server of their own (artifact_ab)."""
    from nafae_torch.models.grounding import inference_params
    from nafae_torch.serve import (GroundingServer, dequantize_params,
                                   export_grounding, quantize_params)

    here = os.path.dirname(os.path.abspath(__file__))
    npz = os.path.join(tmp, "oracle_params.npz")
    np.savez(npz, **params)
    spec = {"params": npz, "kinds": {}}
    export_s = {}
    for kind, (quantize, storage) in ARTIFACTS.items():
        cfg = serve_cfg("float32", quantize)
        d = os.path.join(tmp, "artifact_" + kind)
        t0 = time.perf_counter()
        if storage:             # as a user exports: the serve CLI
            run = subprocess.run(
                [sys.executable, "-m", "nafae_torch.serve", "--preset",
                 "config4", "--override", f"model.quantize={quantize}",
                 "--checkpoint", npz, "--export", d, "--quantize", storage],
                cwd=here, capture_output=True, text=True, timeout=600)
            if run.returncode != 0:
                fail(f"serve --export failed: {run.stderr[-2000:]}")
            if json.loads(run.stdout.strip().splitlines()[-1]) != {
                    "exported": d, "quantize": storage}:
                fail(f"serve --export printed {run.stdout[-500:]}")
        else:
            export_grounding(cfg, params, d)
        export_s[kind] = time.perf_counter() - t0
        live_params = params if storage is None else dequantize_params(
            quantize_params(inference_params(cfg, params)))
        srv = GroundingServer(cfg, live_params, device="cuda")
        batch = serving_batch(srv, segs)
        np.savez(d + "_batch.npz", **batch)
        np.savez(d + "_live.npz", **srv.run_batch(batch))
        spec["kinds"][kind] = {"dir": d, "quantize": quantize,
                               "batch": d + "_batch.npz",
                               "live": d + "_live.npz",
                               "ab": storage is None and kind != "int8"}
    spec_path = os.path.join(tmp, "artifacts.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--artifact-child", spec_path], cwd=here,
                         capture_output=True, text=True, timeout=900)
    child_s = time.perf_counter() - t0
    if run.returncode != 0:
        fail(f"the artifact subprocess failed: {run.stderr[-3000:]}")
    res = json.loads(run.stdout.strip().splitlines()[-1])["artifact_child"]
    for kind, r in res.items():
        if not r["equal"]:
            fail(f"the {kind} artifact's answers differ from the live "
                 f"server's: {r}")
        if r["launches_ctx_mix_fwd"] != 1 or r["device"] != "cuda":
            fail(f"the {kind} artifact ran K1f {r['launches_ctx_mix_fwd']} "
                 f"times on {r['device']}; once on cuda expected")
        log(f"artifact {kind}: exported in {export_s[kind]:.2f} s, loaded "
            f"in a fresh process in {r['load_s']:.2f} s; answers equal to "
            f"the live server's bit for bit; K1f launched once; program "
            f"{r['program_bytes']} bytes, params.npz {r['params_bytes']} "
            "bytes")
        if "ab" in r:
            a = r["ab"]
            log(f"artifact vs live server ({kind}, one batch of 16, "
                f"{AB_ROUNDS} interleaved rounds in one process): device "
                f"{a['artifact_device_ms']:.4f} vs {a['live_device_ms']:.4f} "
                f"ms; host to host {a['artifact_host_ms']:.4f} vs "
                f"{a['live_host_ms']:.4f} ms — {card_line()}")
    return {"export_s": export_s, "child_s": child_s, "kinds": res}


def artifact_ab(torch, call, kind: dict, params_npz: str, batch) -> dict:
    """An artifact against a live server of the same config and params on
    the same batch, in this process: device ms (CUDA graphs) and host to
    host ms (numpy in, numpy out), in AB_ROUNDS interleaved rounds (live,
    artifact, artifact, live)."""
    from nafae_torch.serve import GroundingServer

    with np.load(params_npz) as z:
        params = {k: z[k] for k in z.files}
    srv = GroundingServer(serve_cfg("float32", kind["quantize"]), params,
                          device="cuda")
    dev = torch.device("cuda")
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    args = [tb[k] for k in ARG_KEYS]
    tail = [tb["feats_scale"]] if "feats_scale" in tb else []
    np_args = [batch[k] for k in ARG_KEYS] + (
        [batch["feats_scale"]] if "feats_scale" in batch else [])
    with torch.inference_mode():
        live_dev = device_ms(torch, lambda: srv._fn(srv.params, *args, *tail))
        art_dev = device_ms(torch, lambda: call(*args, *tail))

    def art_host():
        return {k: v.cpu().numpy() for k, v in call(*np_args).items()}

    times = {"live": [], "artifact": []}
    for i in range(AB_ROUNDS + 2):
        for name, fn in (("live", lambda: srv.run_batch(batch)),
                         ("artifact", art_host), ("artifact", art_host),
                         ("live", lambda: srv.run_batch(batch))):
            t0 = time.perf_counter()
            fn()
            if i >= 2:                          # two warm-up rounds
                times[name].append((time.perf_counter() - t0) * 1e3)
    return {"live_device_ms": live_dev, "artifact_device_ms": art_dev,
            "live_host_ms": statistics.median(times["live"]),
            "artifact_host_ms": statistics.median(times["artifact"])}


def artifact_child(spec_path: str) -> None:
    """`python3 chip_smoke.py --artifact-child spec.json`: the deployment
    host's side of check_export, in a process of its own. Prints one JSON
    line: per artifact, whether its answers equal the live server's, K1f's
    launches in its run, and (artifact_ab) its times."""
    import torch

    from nafae_torch.ops.kernels import ctx_mix as K
    from nafae_torch.serve import PARAMS_NPZ, PROGRAM, load_exported

    if not torch.cuda.is_available():
        fail("no CUDA device")
    with open(spec_path) as f:
        spec = json.load(f)
    out = {}
    for name, kind in spec["kinds"].items():
        t0 = time.perf_counter()
        call, manifest = load_exported(kind["dir"])
        load_s = time.perf_counter() - t0
        with np.load(kind["batch"]) as z:
            batch = {k: z[k] for k in z.files}
        with np.load(kind["live"]) as z:
            live = {k: z[k] for k in z.files}
        args = [batch[k] for k in ARG_KEYS] + (
            [batch["feats_scale"]] if "feats_scale" in batch else [])
        K.launches["ctx_mix_fwd"] = 0           # the artifact's run starts
        got = {k: v.cpu().numpy() for k, v in call(*args).items()}
        launches = K.launches["ctx_mix_fwd"]    # ... and ends here
        out[name] = {
            "equal": set(got) == set(live) and all(
                np.array_equal(got[k], live[k]) for k in live),
            "launches_ctx_mix_fwd": launches, "device": manifest["device"],
            "load_s": load_s,
            "program_bytes": os.path.getsize(os.path.join(kind["dir"],
                                                          PROGRAM)),
            "params_bytes": os.path.getsize(os.path.join(kind["dir"],
                                                         PARAMS_NPZ))}
        if kind["ab"]:
            out[name]["ab"] = artifact_ab(torch, call, kind, spec["params"],
                                          batch)
    print(json.dumps({"artifact_child": out}), flush=True)


def check_visualize(torch, root: str, tmp: str) -> dict:
    """`visualize_config` (config1 preset, the oracle params) over the first
    VIZ_SEGMENTS val segments on the card, rendering PNGs, and on the CPU:
    the records equal, but for a region where the CPU's top two scores are
    within TIE_GAP and a score one step of its 4-decimal rounding apart;
    no kernel launched."""
    from nafae_torch.data.youcook2 import SegmentDataset
    from nafae_torch.models.grounding import params_from_jax
    from nafae_torch.ops import grounding as TG
    from nafae_torch.visualize import visualize_config

    cfg = eval_cfg(root, tmp)
    params = oracle_params()
    card_dir, cpu_dir = (os.path.join(tmp, "viz_" + d)
                         for d in ("card", "cpu"))
    zero_counts()
    t0 = time.perf_counter()
    card_path = visualize_config(cfg, card_dir, params,
                                 num_segments=VIZ_SEGMENTS, device="cuda")
    wall = time.perf_counter() - t0
    if any(read_counts().values()):
        fail(f"visualize launched {read_counts()}; it runs no kernel")
    cpu_path = visualize_config(cfg, cpu_dir, params,
                                num_segments=VIZ_SEGMENTS, render=False,
                                device="cpu")
    with open(card_path) as f:
        card = [json.loads(ln) for ln in f]
    with open(cpu_path) as f:
        cpu = [json.loads(ln) for ln in f]
    # the CPU's top-two gaps, in segment_records' order
    ds = SegmentDataset(cfg.data.root, "val", cfg.data.max_frames,
                        cfg.data.num_regions, cfg.data.feat_dim,
                        cfg.data.max_words, with_gt=True)
    p = params_from_jax(params, "cpu")
    gaps = []
    for i in range(min(VIZ_SEGMENTS, len(ds))):
        sm = ds[i]
        with torch.inference_mode():
            s = TG.mask_regions(TG.similarity_tensor(
                TG.embed_words(torch.from_numpy(sm["word_ids"][None]),
                               p["word_emb"]),
                TG.project_params(p, torch.from_numpy(sm["feats"][None]))),
                torch.from_numpy(sm["region_mask"][None]))[0]
        top2 = s.topk(2, dim=-1).values
        for k in np.nonzero(sm["word_mask"])[0]:
            for t in np.nonzero(sm["frame_mask"])[0]:
                if sm["region_mask"][t].any():
                    gaps.append(float(top2[k, t, 0] - top2[k, t, 1]))
    if len(card) != len(cpu) or len(cpu) != len(gaps):
        fail(f"visualize: {len(card)} records on the card, {len(cpu)} on "
             f"the CPU, {len(gaps)} expected")
    moved = stepped = 0
    for a, b, gap in zip(card, cpu, gaps):
        if a["region"] != b["region"]:
            if gap > TIE_GAP:
                fail(f"visualize: card {a} and CPU {b} differ, clear of ties")
            moved += 1
            continue
        if abs(a["score"] - b["score"]) > 1.5e-4:
            fail(f"visualize: scores differ past their rounding: {a}, {b}")
        stepped += a["score"] != b["score"]
        if {**a, "score": 0} != {**b, "score": 0}:
            fail(f"visualize: card {a} and CPU {b} differ")
    pngs = sum(len(files) for _, _, files in os.walk(card_dir)
               if files and all(f.endswith(".png") for f in files))
    frames = len({(r["segment"], r["frame"]) for r in card})
    if pngs != frames:
        fail(f"visualize wrote {pngs} PNGs for {frames} frames")
    log(f"visualize ({len(card)} records of {VIZ_SEGMENTS} segments, "
        f"{pngs} PNGs) on the card in {wall:.2f} s: records equal to the "
        f"CPU's ({moved} regions moved at ties, {stepped} scores one "
        "rounding step apart)")
    return {"records": len(card), "pngs": pngs, "moved_at_ties": moved,
            "scores_one_step_apart": stepped, "wall_s": wall}


H100_INT8_OPS = 1979e12          # int8 on tensor cores, dense, same sheet


def int8_bound_ms(nbytes_: int, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes_ / H100_BYTES_PER_S, ops / H100_INT8_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def int8_timings(torch, params, segs) -> dict:
    """On the first serving batch (config4, B=16): device ms (CUDA graphs)
    of the projection in f32, bf16, int8 (features quantized per batch)
    and int8pre, each with its bound, and of the bare products; then the
    f32, int8 and int8pre servers' whole batch: device ms, device busy
    (torch.profiler), host to host (numpy in and out) and the batch's
    copy to the card alone, in interleaved rounds, and the host's ingest
    (padding, and int8pre's quantization) of the batch's segments."""
    from nafae_torch.ops import grounding as TG
    from nafae_torch.serve import GroundingServer

    dev = torch.device("cuda")
    srvs = {q or "float32": GroundingServer(serve_cfg("float32", q), params,
                                            device="cuda")
            for q in ("", "int8", "int8pre")}
    batches = {n: serving_batch(s, segs) for n, s in srvs.items()}
    tbs = {n: {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
           for n, b in batches.items()}
    p, pq = srvs["float32"].params, srvs["int8pre"].params
    f, qf = tbs["float32"]["feats"], tbs["int8pre"]["feats"]
    sf = tbs["int8pre"]["feats_scale"]
    wq, ws, bv = pq["w_v.q8"], pq["w_v.scale8"], pq["b_v"]
    f2, q2 = f.reshape(-1, f.shape[-1]), qf.reshape(-1, qf.shape[-1])
    n, d = q2.shape
    e = wq.shape[1]
    out_b = n * e * 4
    res = {"shapes": {"N": n, "D": d, "E": e}}
    with torch.inference_mode():
        for name, fn in (
                ("proj_f32", lambda: TG.project_regions(f, p["w_v"],
                                                        p["b_v"])),
                ("proj_bf16", lambda: TG.project_regions(
                    f, p["w_v"], p["b_v"], dtype=torch.bfloat16)),
                ("proj_int8", lambda: TG.project_regions_int8(f, wq, ws, bv)),
                ("proj_int8pre", lambda: TG.project_regions_int8_pre(
                    qf, sf, wq, ws, bv)),
                ("matmul_f32", lambda: f2 @ p["w_v"]),
                ("int_mm", lambda: TG.int8_matmul(q2, wq))):
            res[name + "_ms"] = device_ms(torch, fn)
        ops = 2.0 * n * d * e
        res["proj_f32_bound_ms"], res["proj_f32_bound_by"] = bound(
            torch, nbytes(f, p["w_v"], p["b_v"]) + out_b, ops, torch.float32)
        res["proj_bf16_bound_ms"], res["proj_bf16_bound_by"] = bound(
            torch, nbytes(f, p["w_v"], p["b_v"]) + out_b, ops, torch.bfloat16)
        res["proj_int8_bound_ms"], res["proj_int8_bound_by"] = int8_bound_ms(
            nbytes(f, wq, ws, bv) + out_b, ops)
        res["proj_int8pre_bound_ms"], res["proj_int8pre_bound_by"] = \
            int8_bound_ms(nbytes(qf, sf, wq, ws, bv) + out_b, ops)
        for name, srv in srvs.items():
            tb = tbs[name]
            args = [tb[k] for k in ARG_KEYS] + (
                [tb["feats_scale"]] if "feats_scale" in tb else [])
            res[f"batch_device_ms_{name}"] = device_ms(
                torch, lambda: srv._fn(srv.params, *args))
            kern, busy, ops_n = profile_forward(
                torch, lambda: srv._fn(srv.params, *args))
            res[f"batch_device_busy_ms_{name}"] = busy
            res[f"batch_device_ops_{name}"] = ops_n
            res[f"kernels_by_device_time_{name}"] = kern
    host = {n: [] for n in srvs}
    h2d = {n: [] for n in srvs}
    order = list(srvs) + list(srvs)[::-1]
    for i in range(AB_ROUNDS + 2):
        for name in order:
            t0 = time.perf_counter()
            srvs[name].run_batch(batches[name])
            t1 = time.perf_counter()
            _ = {k: torch.from_numpy(v).to(dev, non_blocking=True)
                 for k, v in batches[name].items()}
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if i >= 2:
                host[name].append((t1 - t0) * 1e3)
                h2d[name].append((t2 - t1) * 1e3)
    for name, srv in srvs.items():
        res[f"batch_host_ms_{name}"] = statistics.median(host[name])
        res[f"batch_h2d_ms_{name}"] = statistics.median(h2d[name])
        res[f"batch_bytes_{name}"] = int(sum(v.nbytes for v in
                                             batches[name].values()))
        res[f"device_idle_share_host_{name}"] = 1.0 - res[
            f"batch_device_busy_ms_{name}"] / res[f"batch_host_ms_{name}"]
        t0 = time.perf_counter()
        for seg in segs[:srv.batch_size]:
            srv._pad_segment(seg)
        res[f"ingest_ms_{name}"] = (time.perf_counter() - t0) * 1e3
    return res


# ------------------------- data parallelism and observability (phase 12)

DP_STEPS = 5                     # f32 steps of each world-of-one DP run
OBS_STEPS = 3                    # steps of the --profile and --debug-nans runs
DP_ROUNDS = 6                    # interleaved timing rounds (A, B, B, A)
# K3 at the shapes each rank of a 2- and 4-card run sees: I = B/W videos
# against all B sentences (config4's first batch, B = 16)
DP_WORLDS = (2, 4)
K1_NAMES = ("ctx_mix_fwd_pairs", "ctx_mix_fwd_mix", "ctx_mix_bwd_pairs",
            "ctx_mix_bwd_gather")     # K1fr's and K1br's kernels in a trace


def start_cli(args: list[str], out: str, ranks: int = 0,
              master_port: int = 0):
    """Starts `python -m <module> args` from the checkout's root, under
    `torch.distributed.run --standalone --nproc_per_node <ranks>` when
    ranks > 0 (with master_port: `--nnodes 1 --master_addr 127.0.0.1
    --master_port <port>`, a multi-host launch of one node), its stdout
    and stderr into files `out`.{stdout,stderr}; returns (Popen, the
    command, the start time)."""
    cmd = [sys.executable, "-m"]
    if ranks:
        cmd += ["torch.distributed.run", "--nproc_per_node", str(ranks)]
        cmd += (["--nnodes", "1", "--master_addr", "127.0.0.1",
                 "--master_port", str(master_port)] if master_port
                else ["--standalone"])
        cmd += ["-m"]
    cmd += args
    with open(out + ".stdout", "w") as so, open(out + ".stderr", "w") as se:
        proc = subprocess.Popen(
            cmd, cwd=os.path.dirname(os.path.abspath(__file__)), stdout=so,
            stderr=se, text=True)
    return proc, cmd, time.perf_counter()


def finish_cli(started, out: str, timeout: int = 600) -> tuple[str, float]:
    """Waits for a start_cli process (killed past `timeout` s); fails
    unless it exits 0; returns (its stdout, its wall s)."""
    proc, cmd, t0 = started
    try:
        rc = proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"{' '.join(cmd[2:])} did not end within {timeout} s")
    wall = time.perf_counter() - t0
    with open(out + ".stdout") as f:
        stdout = f.read()
    if rc != 0:
        with open(out + ".stderr") as f:
            fail(f"{' '.join(cmd[2:])} failed ({rc}): {f.read()[-3000:]}")
    return stdout, wall


RATES = ("frames_per_sec", "frames_per_sec_avg", "ts")   # wall-clock keys


def metrics_equal(a: dict, b: dict) -> bool:
    """Every key of row a but the rates equal in b, bit for bit."""
    return all(a[k] == b[k] for k in a if k not in RATES)


def check_dp(torch, root: str, tmp: str, mesh) -> dict:
    """Phase 12 (a): fit under a world-of-one NCCL mesh, DP_STEPS f32 steps
    of config4 on each route, against the same steps without a mesh:
    metrics, params and centers bit for bit, the same kernel launches
    (read with the counts zeroed just before each run), and the
    collectives the mesh run issued, step by step."""
    from nafae_torch.parallel import sharding as S
    from nafae_torch.train import fit

    out = {}
    for route in ROUTES:
        runs = {}
        for tag, m in (("plain", None), ("mesh", mesh)):
            cfg = train_cfg(root, os.path.join(tmp, f"ck_dp_{route}_{tag}"),
                            "float32", DP_STEPS, route)
            logs, marks = [], []

            def log_fn(rec):
                logs.append(rec)
                marks.append(len(S.COLLECTIVES.records))

            S.COLLECTIVES.reset()
            zero_counts()                       # main path starts here
            state, _ = fit(cfg, log_fn=log_fn, mesh=m)
            counts = read_counts()              # ... and ends here
            recs = list(S.COLLECTIVES.records)
            steps = [recs[a:b] for a, b in zip([0] + marks, marks)]
            runs[tag] = (logs, state, counts, steps)
        (lp, sp, cp, _), (lm, sm, cm, steps) = runs["plain"], runs["mesh"]
        want = {k: n * DP_STEPS for k, n in per_step_launches(route).items()}
        if cm != want or cp != want:
            fail(f"DP fit ({route}) launched {cm}, without the mesh {cp}; "
                 f"expected {want}")
        if len(lm) != DP_STEPS or not all(
                metrics_equal(a, b) for a, b in zip(lp, lm)):
            fail(f"DP fit ({route}) metrics differ from the run without a "
                 f"mesh: {lm} vs {lp}")
        bad = [k for k in sp.params if not torch.equal(sp.params[k],
                                                       sm.params[k])]
        if bad or not torch.equal(sp.centers, sm.centers):
            fail(f"DP fit ({route}): params {bad} or centers differ from the "
                 "run without a mesh")
        per_step = [{"ops": len(s), "bytes": sum(r[3] for r in s),
                     "all_reduce_bytes": sum(r[3] for r in s
                                             if r[0] == "all_reduce"),
                     "all_gather_bytes": sum(r[3] for r in s
                                             if r[0] == "all_gather")}
                    for s in steps]
        log(f"DP fit on a world-of-one NCCL mesh ({route}, {DP_STEPS} f32 "
            f"steps, config4 B=16): metrics, params and centers bit for bit "
            f"those without a mesh; launches {cm}; collectives per step "
            + "; ".join(f"{p['ops']} ops {p['bytes']} B (all_reduce "
                        f"{p['all_reduce_bytes']}, all_gather "
                        f"{p['all_gather_bytes']})" for p in per_step))
        out[route] = {"launches": cm, "collectives_per_step": per_step,
                      "logs": lm}
    return out


def check_clis(torch, root: str, tmp: str, dp: dict, evals: dict) -> dict:
    """Phase 12 (a, b, c) and 13 (a), four CLI runs started together on the
    card: `torchrun --nproc_per_node 1 -m nafae_torch.train --mesh` and
    `torchrun --nnodes 1 --nproc_per_node 1 -m nafae_torch.train
    --multihost` (NCCL, a world of one), whose metrics.jsonl must each
    equal the in-process DP run's steps bit for bit, which equal those
    without a mesh;
    `torchrun ... -m nafae_torch.evaluate --mesh` on phase 7's val split
    and f32 checkpoint, whose hits must equal phase 7's; and an
    OBS_STEPS-step `-m nafae_torch.train --profile DIR` run with
    train.tensorboard_dir, whose trace must name K1fr's and K1br's kernels
    once for each graph replay and warm-up step, and whose event file, read back by read_events (CRCs checked), must
    equal its metrics.jsonl. Meanwhile, in this process, an OBS_STEPS-step
    fit with debug_nans (anomaly mode, finite checks) must train."""
    from nafae_torch.train import fit
    from nafae_torch.utils.metrics_log import MetricsLogger, read_events

    import socket

    ck_dp, ck_mh, ck_obs, prof, tb = (os.path.join(tmp, d) for d in (
        "ck_dp_cli", "ck_mh_cli", "ck_obs", "prof", "tb"))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    train_args = ["--preset", "config4", "--override", *TRAIN_OVERRIDES,
                  f"data.root={root}", "model.dtype=float32"]
    runs = {
        "train_mesh": start_cli(
            ["nafae_torch.train", "--mesh", *train_args,
             f"train.ckpt_dir={ck_dp}", f"train.steps={DP_STEPS}"],
            os.path.join(tmp, "cli_train_mesh"), ranks=1),
        "train_multihost": start_cli(
            ["nafae_torch.train", "--multihost", *train_args,
             f"train.ckpt_dir={ck_mh}", f"train.steps={DP_STEPS}"],
            os.path.join(tmp, "cli_train_multihost"), ranks=1,
            master_port=port),
        "eval_mesh": start_cli(
            ["nafae_torch.evaluate", "--mesh", "--preset", "config1",
             "--checkpoint", os.path.join(tmp, f"ck_{ROUTES[0]}_float32"),
             "--override", f"data.root={root}"],
            os.path.join(tmp, "cli_eval_mesh"), ranks=1),
        "profile": start_cli(
            ["nafae_torch.train", "--profile", prof, *train_args,
             f"train.ckpt_dir={ck_obs}", f"train.tensorboard_dir={tb}",
             f"train.steps={OBS_STEPS}"], os.path.join(tmp, "cli_profile"))}
    cfg = train_cfg(root, os.path.join(tmp, "ck_nans"), "float32", OBS_STEPS)
    logs = []
    fit(cfg, log_fn=logs.append, debug_nans=True)
    if len(logs) != OBS_STEPS or not np.isfinite(logs[-1]["loss"]):
        fail(f"fit with debug_nans logged {logs}")
    log(f"fit with debug_nans ({OBS_STEPS} steps): trained, loss "
        f"{logs[0]['loss']:.5f} -> {logs[-1]['loss']:.5f}")
    out = {name: finish_cli(started, os.path.join(tmp, "cli_" + name))
           for name, started in runs.items()}
    walls = {name: round(w, 1) for name, (_, w) in out.items()}

    recs = MetricsLogger(ck_dp).read()
    want = dp["auto"]["logs"]
    if len(recs) != DP_STEPS or not all(metrics_equal(w, r)
                                        for w, r in zip(want, recs)):
        fail(f"torchrun train --mesh wrote {recs}; the in-process DP run "
             f"logged {want}")
    log(f"torchrun --nproc_per_node 1 -m nafae_torch.train --mesh: rc 0, its "
        f"{DP_STEPS} metrics.jsonl records equal the in-process DP run's bit "
        "for bit")
    recs = MetricsLogger(ck_mh).read()
    if len(recs) != DP_STEPS or not all(metrics_equal(w, r)
                                        for w, r in zip(want, recs)):
        fail(f"torchrun train --multihost wrote {recs}; the in-process DP "
             f"run logged {want}")
    log(f"torchrun --nnodes 1 --nproc_per_node 1 -m nafae_torch.train "
        f"--multihost (NCCL, a world of one): rc 0, its {DP_STEPS} "
        "metrics.jsonl records equal the in-process DP run's (and so the "
        "run's without a mesh) bit for bit")

    got = json.loads(out["eval_mesh"][0].strip().splitlines()[-1])
    hits = round(got["box_acc_micro"] * got["num_annotations"])
    if hits != evals["trained"]["hits"]["card"] or got[
            "num_annotations"] != evals["trained"]["card"]["num_annotations"]:
        fail(f"eval --mesh under torchrun: {got}, {hits} hits; phase 7 had "
             f"{evals['trained']['card']}")
    log(f"torchrun -m nafae_torch.evaluate --mesh (config1, the f32 config-4 "
        f"checkpoint): {hits} hits of {got['num_annotations']}, equal to "
        "phase 7's")

    if f"profile trace written to {prof}" not in out["profile"][0]:
        fail(f"train --profile printed {out['profile'][0][-2000:]}")
    (trace,) = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    with open(os.path.join(prof, trace)) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    kernels = set(names)
    found = {k: sorted(n for n in kernels if k in n)[:2] for k in K1_NAMES}
    if not all(found.values()):
        fail(f"the --profile trace lacks "
             f"{[k for k, v in found.items() if not v]} among its "
             f"{len(kernels)} kernels")
    # the run is captured in two graphs (a refresh at step 0, then none),
    # each after WARMUP_STEPS eager steps: each of K1fr's and K1br's
    # kernels runs once in each warm-up step and once in each replay, so
    # the trace names the replayed ones only if it counts them all
    from nafae_torch.train import WARMUP_STEPS
    named = {k: sum(k in n for n in names) for k in K1_NAMES}
    if any(n != OBS_STEPS + 2 * WARMUP_STEPS for n in named.values()):
        fail(f"the --profile trace names K1fr's and K1br's kernels {named} "
             f"times; {OBS_STEPS} replays and {2 * WARMUP_STEPS} warm-up "
             "steps run each once")
    (tbf,) = os.listdir(tb)
    evs = read_events(os.path.join(tb, tbf))
    recs = MetricsLogger(ck_obs).read()
    if evs[0].get("file_version") != "brain.Event:2" or len(evs) != \
            len(recs) + 1 or not all(
            e["step"] == r["step"] and e["scalars"] == {
                k: float(np.float32(v)) for k, v in r.items()
                if k not in ("ts", "step")}
            for e, r in zip(evs[1:], recs)):
        fail(f"the event file {evs} does not match metrics.jsonl {recs}")
    log(f"train --profile + train.tensorboard_dir ({OBS_STEPS} steps): trace "
        f"{trace} ({os.path.getsize(os.path.join(prof, trace))} bytes, "
        f"{len(kernels)} kernel names) holds {found}, each "
        f"{OBS_STEPS + 2 * WARMUP_STEPS} times ({OBS_STEPS} graph replays, "
        f"{2 * WARMUP_STEPS} warm-up steps); the event file "
        f"({len(evs)} events, CRCs checked) equals metrics.jsonl; CLI wall "
        f"s, run together: {walls}")
    return {"cli_wall_s": walls, "eval_hits": hits, "trace_kernels": found,
            "events": len(evs),
            "debug_nans_losses": [m["loss"] for m in logs]}


def check_cross_mil_dp(torch, root: str, tmp: str) -> dict:
    """Phase 12 (d): K3 against its plain version at each DP rank's shapes,
    I = 16/W videos against the M = 16·8 words of all sentences (config4's
    first batch), f32 and bf16: a within CROSS_TOL, idx equal where clear
    of ties; device times (CUDA graphs) of K3, its plain version and
    torch.matmul + torch.max, and its bound."""
    from nafae_torch.ops.kernels import cross_mil as K3

    w_emb, v_emb, _, _, fm, rm, _ = fused_inputs(torch, root, tmp)
    b, t, r, e = v_emb.shape
    m = b * w_emb.shape[1]
    rtol, atol = CROSS_TOL
    res = {}
    for world in DP_WORLDS:
        i = b // world
        for tag, dt in (("", torch.float32), ("_bf16", torch.bfloat16)):
            key = f"_w{world}{tag}"
            wf = w_emb.reshape(m, e).to(dt).contiguous()
            v, f_, r_ = v_emb[:i].to(dt).contiguous(), fm[:i], rm[:i]
            a, idx = K3.launch(wf, v, f_, r_)
            torch.cuda.synchronize()
            ap, idxp = K3.cross_mil_plain(wf, v, f_, r_)
            err = (a - ap).abs().max().item()
            s = torch.where(r_[:, None] > 0, torch.einsum(
                "me,itre->imtr", wf.float(), v.float()), K3.NEG)
            clear = clear_of_ties(torch, s)
            if not torch.allclose(a, ap, rtol=rtol, atol=atol) or \
                    not torch.equal(idx[clear], idxp[clear]):
                fail(f"cross_mil at the DP shape I={i} M={m}{tag} differs "
                     f"from its plain version (max |a err| {err})")
            live = int((r_ > 0).sum())
            v2 = v.reshape(i, t * r, e)
            res.update({
                "err" + key: err,
                "ms" + key: device_ms(torch, lambda: K3.launch(wf, v, f_,
                                                               r_)),
                "plain_ms" + key: device_ms(
                    torch, lambda: K3.cross_mil_plain(wf, v, f_, r_)),
                "library_ms" + key: device_ms(
                    torch, lambda: torch.max(torch.matmul(v2, wf.T).reshape(
                        i, t, r, m), dim=2))})
            res["bound_ms" + key], res["bound_by" + key] = bound(
                torch, nbytes(wf, f_, r_) + live * e * v.element_size()
                + 2 * i * m * t * 4, 2 * m * e * live, dt)
            res["shape" + key] = {"I": i, "M": m, "T": t, "R": r, "E": e}
    log("cross_mil at the DP ranks' shapes (config4 first batch, M = 128 "
        "words of B = 16 sentences): " + "; ".join(
            f"W={w} I={b // w} {d}: kernel {res[f'ms_w{w}{g}']:.4f} ms, "
            f"plain {res[f'plain_ms_w{w}{g}']:.4f}, matmul + max "
            f"{res[f'library_ms_w{w}{g}']:.4f}, bound "
            f"{res[f'bound_ms_w{w}{g}']:.4f} ({res[f'bound_by_w{w}{g}']}), "
            f"max |err| {res[f'err_w{w}{g}']:.3e}"
            for w in DP_WORLDS for g, d in (("", "f32"), ("_bf16", "bf16")))
        + f" — {card_line()}")
    return res


def dp_timings(torch, root: str, tmp: str, mesh) -> dict:
    """Phase 12 (e): one config4 f32 auto training step host to host (numpy
    batch in, loss on the host), without a mesh, on the world-of-one mesh
    and with debug_nans (anomaly mode on), in DP_ROUNDS interleaved rounds;
    and the collectives of one mesh step."""
    from nafae_torch.parallel import sharding as S
    from nafae_torch.train import (TrainState, batch_to_device,
                                   make_optimizer, train_step)

    dev = torch.device("cuda")
    batch = first_batch(root)
    cfg = train_cfg(root, os.path.join(tmp, "ck_dp_time"), "float32", 1000)
    tx = make_optimizer(cfg)
    st = TrainState.create(cfg, device=dev)
    kinds = {"plain": {}, "mesh": {"mesh": mesh},
             "debug_nans": {"debug_nans": True}}

    def step(kind):
        nonlocal st
        t0 = time.perf_counter()
        with torch.autograd.set_detect_anomaly(kind == "debug_nans"):
            st, m = train_step(st, batch_to_device(batch, dev), cfg, tx,
                               **kinds[kind])
            float(m["loss"])
        return (time.perf_counter() - t0) * 1e3

    for kind in kinds:
        for _ in range(2):
            step(kind)
    times = {k: [] for k in kinds}
    for _ in range(DP_ROUNDS):
        for kind in ("mesh", "debug_nans"):
            for k in ("plain", kind, kind, "plain"):
                times[k].append(step(k))
    S.COLLECTIVES.reset()
    step("mesh")
    recs = list(S.COLLECTIVES.records)
    res = {f"step_host_ms_{k}": statistics.median(v)
           for k, v in times.items()}
    res["collectives_per_step"] = [list(r) for r in recs]
    res["all_reduce_bytes_per_step"] = sum(r[3] for r in recs
                                           if r[0] == "all_reduce")
    res["all_gather_bytes_per_step"] = sum(r[3] for r in recs
                                           if r[0] == "all_gather")
    log(f"config4 f32 auto step host to host (median of "
        f"{len(times['plain'])} / {len(times['mesh'])} interleaved): "
        f"without a mesh {res['step_host_ms_plain']:.4f} ms, world-of-one "
        f"NCCL mesh {res['step_host_ms_mesh']:.4f} ms, debug_nans "
        f"{res['step_host_ms_debug_nans']:.4f} ms; one mesh step issues "
        f"{len(recs)} collectives, all_reduce "
        f"{res['all_reduce_bytes_per_step']} B (the gradient buffer "
        f"{max(r[3] for r in recs if r[0] == 'all_reduce')} B), all_gather "
        f"{res['all_gather_bytes_per_step']} B — {card_line()}")
    return res


def check_dp_c5(torch, ann: str, tmp: str, mesh, c5: dict) -> dict:
    """Phase 12 (a), config 5: one inline step through fit on the
    world-of-one mesh with detector.roi_impl=pallas at full width: K2 and
    K5 once, and its metrics those of phase 9's first pallas_roi step."""
    from nafae_torch.train import fit

    cfg = c5_cfg(ann, os.path.join(tmp, "ck5_dp"), "pallas_roi", 1)
    logs = []
    zero_counts()                               # main path starts here
    fit(cfg, log_fn=logs.append, mesh=mesh)
    counts = read_counts()                      # ... and ends here
    if counts != c5_launches(cfg):
        fail(f"DP config-5 step launched {counts}, expected "
             f"{c5_launches(cfg)}")
    ref = c5["pallas_roi"]["logs"][0]
    diff = max(abs(logs[0][k] - ref[k]) / max(abs(ref[k]), 1e-30)
               for k in ref if k not in ("frames_per_sec", "step"))
    if diff > CPU_METRIC_TOL[0]:
        fail(f"DP config-5 step {logs[0]} differs from phase 9's first "
             f"pallas_roi step {ref}")
    log(f"DP config-5 step (world-of-one mesh, roi_impl=pallas, B=16 "
        f"640x640): launches {counts}; metrics vs phase 9's first step: max "
        f"relative diff {diff:.3e}")
    return {"launches": counts, "metric_rel_diff": diff}


# ------------------------- frame parallelism and multi-host (phase 13)

# (data, frame, loss.ctx_window) of each frame-parallel mesh, every rank
# on the one card over gloo: 1x2 (T_local = 10), 2x2, and 1x4 at w = 6
# (T_local = 5 < w: each halo comes from two shards on each side)
SP_MESHES = ((1, 2, 3), (2, 2, 3), (1, 4, 6))
SP_WORLD = 4
SP_STEPS = 3                     # f32 steps of each mesh and route
SP_TIMEOUT = 600                 # s for the whole spawned world
# SP against the single-device step on the card: tests/test_sp.py's metric
# bound; the reduced gradient of every step within tests/test_torch_sp.py's
# rtol 1e-4 / atol 1e-6; every parameter and center entry after SP_STEPS
# Adam steps within SP_PARAM_TOL
SP_METRIC_TOL = (3e-4, 1e-5)
SP_GRAD_TOL = (1e-4, 1e-6)
# the single-device route both SP routes are held against: under SP the
# score rows come from the dense product whatever train.kernels says (K3 is
# not launched), as in the reference, whose tests/test_sp.py also holds its
# pallas mesh step against the jnp one. The single device's pallas route
# takes its rows from K3, whose first-index argmax and the dense product's
# max can pick different regions where two scores are within rounding of
# each other (phase 5's second batch on an NVIDIA H100 80GB HBM3 at 700 W:
# gradients 0.5% of a leaf's largest entry apart); K4f/K4b against the
# dense epilogue differ by ~5e-10 there
SP_REFERENCE = "auto"
SP_PARAM_TOL = 1e-5
# the ranks whose inputs the kernels are held on at T_local, as (mesh,
# data rank, frame rank): the 2x2 mesh's rank (0, 1) (the last shard: its
# right halo is zeros) and the 1x4 mesh's rank (0, 1) (both halos real,
# each from two shards)
SP_KERNEL_RANKS = (((2, 2, 3), 0, 1), ((1, 4, 6), 0, 1))


def sp_cfg(root: str, ckpt: str, route: str, data: int, frame: int, w: int,
           dtype: str = "float32"):
    from nafae_torch.config import load_config

    return load_config(preset_name="config4", overrides=TRAIN_OVERRIDES + [
        f"data.root={root}", f"train.ckpt_dir={ckpt}", f"model.dtype={dtype}",
        "train.steps=1000", f"train.kernels={route}",
        f"mesh.data_axis={data}", f"mesh.frame_axis={frame}",
        f"loss.ctx_window={w}"])


def sp_batches(root: str) -> list[dict]:
    """The first SP_STEPS training batches (numpy), as fit's loader gives
    them."""
    from nafae_torch.data.loader import BatchLoader
    from nafae_torch.data.youcook2 import SegmentDataset

    ds = SegmentDataset(root, "train", 20, 20, 2048, 8)
    return [b for _, b in BatchLoader(ds, 16, shuffle=True,
                                      seed=0).steps(SP_STEPS)]


def sp_launches(route: str) -> dict[str, int]:
    """Launches of each kernel in one frame-parallel step of `route` on one
    rank: K1fr and K1br once; on pallas K4f and K4b once; K3 never (the
    score rows come from the dense product under SP, as in the
    reference)."""
    want = per_step_launches(route)
    want["cross_mil"] = 0
    return want


def sp_halo_bytes(b_loc: int, t_loc: int, frame: int, f: int, w: int,
                  r: int = 20, e: int = 256) -> int:
    """The bytes rank f of `frame` shards sends in one f32 step: for each
    neighbour at hop d that exists, its piece of k_d frames of v̂ in the
    forward pass and of v̂'s cotangent in the backward pass (B·k·R·E·4
    each) and of the frame and region masks (B·k·4, B·k·R·4)."""
    from nafae_torch.parallel.sp import _pieces

    per_frame = b_loc * (2 * r * e * 4 + 4 + r * 4)
    return sum(((f + d < frame) + (f - d >= 0)) * k * per_frame
               for d, k in _pieces(t_loc, w))


def recording(tx) -> list[dict]:
    """Makes the optimizer `tx` keep each update's gradients (numpy);
    returns the list they go into."""
    grads, real = [], tx.update

    def update(g, state, params):
        grads.append({k: v.detach().cpu().numpy() for k, v in g.items()})
        return real(g, state, params)

    tx.update = update
    return grads


def sp_single(torch, root: str, tmp: str, batches) -> dict:
    """SP_STEPS f32 steps without a mesh on the card, from the same initial
    state as every rank: {(route, w): metrics per step, params, centers,
    host ms per step, gradients per step}."""
    from nafae_torch.train import (TrainState, batch_to_device,
                                   make_optimizer, train_step)

    dev = torch.device("cuda")
    out = {}
    for route in ROUTES:
        for w in sorted({m[2] for m in SP_MESHES}):
            cfg = sp_cfg(root, os.path.join(tmp, "ck_sp"), route, 1, 1, w)
            st, tx = TrainState.create(cfg, device=dev), make_optimizer(cfg)
            grads = recording(tx)
            metrics, ms = [], []
            for b in batches:
                t0 = time.perf_counter()
                st, m = train_step(st, batch_to_device(b, dev), cfg, tx)
                metrics.append({k: float(v) for k, v in m.items()})
                ms.append((time.perf_counter() - t0) * 1e3)
            out[(route, w)] = {
                "metrics": metrics, "ms": ms, "grads": grads,
                "params": {k: v.cpu().numpy() for k, v in st.params.items()},
                "centers": st.centers.cpu().numpy()}
    return out


def sp_rank(rank: int, port: int, root: str, tmp: str) -> None:
    """One rank of the spawned world (phase 13): joins it as torchrun's
    ranks do (RANK, WORLD_SIZE, MASTER_ADDR/MASTER_PORT; LOCAL_RANK 0, the
    one card), then for each SP_MESHES mesh that holds it, SP_STEPS f32
    steps of each route on its part of each batch through train_step,
    with every launch count zeroed just before each step and read just
    after, and the step's collectives (rank (0, 0) also the reduced
    gradients); pickles what it saw."""
    import pickle
    import warnings

    import torch

    from nafae_torch.parallel import sharding as S
    from nafae_torch.parallel.mesh import make_mesh, shutdown
    from nafae_torch.parallel.multihost import global_batch_spec, local_batch
    from nafae_torch.train import (TrainState, batch_to_device,
                                   make_optimizer, train_step)

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(SP_WORLD),
                      LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    batches = sp_batches(root)
    dev = torch.device("cuda", 0)
    out = {}
    for data, frame, w in SP_MESHES:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # a mesh smaller than the world
            mesh = make_mesh(data, frame, device="cuda", backend="gloo")
        if torch.distributed.get_backend() != "gloo" or \
                torch.cuda.current_device() != 0:
            raise RuntimeError("the SP world must run gloo on cuda:0")
        if rank < data * frame:
            for route in ROUTES:
                cfg = sp_cfg(root, os.path.join(tmp, "ck_sp"), route, data,
                             frame, w)
                spec = global_batch_spec(cfg, mesh)
                st, tx = (TrainState.create(cfg, device=dev),
                          make_optimizer(cfg))
                grads = recording(tx) if rank == 0 else None
                steps = []
                for b in batches:
                    S.COLLECTIVES.reset()
                    zero_counts()                   # main path starts here
                    t0 = time.perf_counter()
                    st, m = train_step(
                        st, batch_to_device(local_batch(b, spec, mesh), dev),
                        cfg, tx, mesh=mesh)
                    metrics = {k: float(v) for k, v in m.items()}
                    ms = (time.perf_counter() - t0) * 1e3
                    counts = read_counts()          # ... and ends here
                    recs = list(S.COLLECTIVES.records)
                    steps.append({
                        "metrics": metrics, "ms": ms, "launches": counts,
                        **{op + "_bytes": sum(x[3] for x in recs
                                              if x[0] == op)
                           for op in ("send", "recv", "all_reduce",
                                      "all_gather", "all_reduce_max")},
                        "collectives": len(recs)})
                out[(data, frame, w, route)] = {
                    "coord": mesh.get_coordinate(), "steps": steps,
                    "grads": grads,
                    "params": {k: v.cpu().numpy()
                               for k, v in st.params.items()},
                    "centers": st.centers.cpu().numpy()}
        torch.distributed.barrier()
    shutdown()
    with open(os.path.join(tmp, f"sp_out_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def sp_spawn(root: str, tmp: str, fn=None, world: int = SP_WORLD,
             out: str = "sp_out") -> list[dict]:
    """Spawns `world` processes of fn (sp_rank by default; fn(rank, port,
    root, tmp) pickles its results into tmp/<out>_<rank>.pkl) and waits for
    them (killed past SP_TIMEOUT s); fails if any fails; returns each
    rank's results."""
    import pickle
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(fn or sp_rank, args=(port, root, tmp),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.perf_counter() + SP_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                fail(f"the spawned world did not end within {SP_TIMEOUT} s")
    except mp.ProcessRaisedException as e:
        fail(f"a spawned rank failed: {e}")
    except mp.ProcessExitedException as e:
        fail(f"a spawned rank exited: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    outs = []
    for r in range(world):
        with open(os.path.join(tmp, f"{out}_{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def check_sp(torch, root: str, tmp: str) -> dict:
    """Phase 13 (b): frame parallelism on the one card. SP_WORLD ranks, each
    a process on cuda:0 over gloo (collectives staged through host
    memory), run SP_STEPS f32 steps of config4 at full width (B=16, T=20,
    R=20, D=2048, E=256) on each SP_MESHES mesh and route; each must equal
    the single-device step on the card (SP_REFERENCE's; metrics within
    SP_METRIC_TOL, each step's reduced gradients within SP_GRAD_TOL, params
    and centers within SP_PARAM_TOL), every rank of a
    mesh the others bit for bit; each rank must launch, each step, K1fr
    and K1br
    once, on pallas K4f and K4b once, K3 never, and send exactly the halo
    bytes its shapes give (sp_halo_bytes)."""
    batches = sp_batches(root)
    single = sp_single(torch, root, tmp, batches)
    # what the routes' other sums move on one device: pallas (K3's rows)
    # against auto (the dense product's), each leaf's largest |difference|
    routes = {w: {k: max(float(np.abs(p[k] - a[k]).max()) for p, a in zip(
        single[("pallas", w)]["grads"], single[("auto", w)]["grads"]))
        for k in single[("auto", w)]["grads"][0]}
        for w in sorted({m[2] for m in SP_MESHES})}
    log(f"single device, pallas against auto, each step's gradients' "
        f"largest |difference| by leaf: {routes}")
    t0 = time.perf_counter()
    outs = sp_spawn(root, tmp)
    wall = time.perf_counter() - t0
    res = {"world_wall_s": wall, "meshes": {},
           "single_pallas_vs_auto_grad_diff": routes}
    problems = []
    for data, frame, w in SP_MESHES:
        b_loc, t_loc = 16 // data, 20 // frame
        for route in ROUTES:
            key = (data, frame, w, route)
            ranks = [o[key] for o in outs[:data * frame]]
            # the rows of both routes come from the dense product under SP,
            # as in the reference: the single device's auto step is the
            # same math (see SP_REFERENCE)
            ref = single[(SP_REFERENCE, w)]
            name = f"{data}x{frame} w={w} {route}"
            first = ranks[0]
            same = True
            for o in ranks[1:]:
                if [s["metrics"] for s in o["steps"]] != \
                        [s["metrics"] for s in first["steps"]] or any(
                        not np.array_equal(o["params"][k], first["params"][k])
                        for k in first["params"]) or not np.array_equal(
                        o["centers"], first["centers"]):
                    same = False
                    problems.append(f"SP {name}: rank {o['coord']} differs "
                                    f"from rank {first['coord']}")
            rtol, atol = SP_METRIC_TOL
            diff = max(abs(g[k] - s[k]) / (atol + rtol * abs(s[k]))
                       for gs, s in zip(first["steps"], ref["metrics"])
                       for g in [gs["metrics"]] for k in s)
            grtol, gatol = SP_GRAD_TOL
            gdiff = max(float((np.abs(g[k] - r[k])
                               / (gatol + grtol * np.abs(r[k]))).max())
                for g, r in zip(first["grads"], ref["grads"]) for k in r)
            # each leaf's largest |difference| over the steps, beside its
            # largest entry
            gleaf = {k: (max(float(np.abs(g[k] - r[k]).max())
                             for g, r in zip(first["grads"], ref["grads"])),
                         max(float(np.abs(r[k]).max())
                             for r in ref["grads"]))
                     for k in ref["grads"][0]}
            pdiff = max(float(np.abs(first["params"][k]
                                     - ref["params"][k]).max())
                        for k in ref["params"])
            cdiff = float(np.abs(first["centers"] - ref["centers"]).max())
            if diff > 1.0 or gdiff > 1.0 or pdiff > SP_PARAM_TOL or \
                    cdiff > SP_PARAM_TOL:
                problems.append(
                    f"SP {name} differs from the single-device step: metrics "
                    f"at {diff:.3f} and gradients at {gdiff:.3f} of their "
                    f"bounds (by leaf, max |diff| and max |g|: {gleaf}), "
                    f"params by {pdiff}, centers by {cdiff}")
            want = sp_launches(route)
            for o in ranks:
                f = o["coord"][1]
                halo = sp_halo_bytes(b_loc, t_loc, frame, f, w)
                for s in o["steps"]:
                    if s["launches"] != want:
                        problems.append(
                            f"SP {name}: rank {o['coord']} launched "
                            f"{s['launches']} in a step, expected {want}")
                    if s["send_bytes"] != halo or s["recv_bytes"] != halo:
                        problems.append(
                            f"SP {name}: rank {o['coord']} sent "
                            f"{s['send_bytes']} and received "
                            f"{s['recv_bytes']} halo bytes, expected {halo}")
            step_ms = max(statistics.median([s["ms"] for s in o["steps"][1:]])
                          for o in ranks)
            res["meshes"][name] = {
                "T_local": t_loc, "B_local": b_loc,
                "launches_per_step": want,
                "halo_send_bytes_per_step": {
                    str(o["coord"]): o["steps"][0]["send_bytes"]
                    for o in ranks},
                "all_reduce_bytes_per_step": first["steps"][0][
                    "all_reduce_bytes"],
                "all_gather_bytes_per_step": first["steps"][0][
                    "all_gather_bytes"],
                "metric_diff_of_bound": diff, "grad_diff_of_bound": gdiff,
                "grad_max_abs_diff_by_leaf": gleaf,
                "param_max_abs_diff": pdiff,
                "center_max_abs_diff": cdiff,
                "step_host_ms_gloo_one_card": step_ms,
                "step_host_ms_single": statistics.median(
                    single[(route, w)]["ms"][1:]),
                "loss": [s["metrics"]["loss"] for s in first["steps"]]}
            m = res["meshes"][name]
            log(f"SP {name} (config4 B=16 T=20 R=20 D=2048 E=256, "
                f"T_local={t_loc}, {SP_STEPS} f32 steps, {data * frame} "
                f"ranks on cuda:0): "
                f"{'equal' if same else 'NOT equal'} across ranks bit for "
                f"bit; vs the single-device {SP_REFERENCE} step metrics at "
                f"{diff:.3f} of rtol {rtol}/atol {atol}, gradients at "
                f"{gdiff:.3f} of theirs, "
                f"params max |diff| {pdiff:.3e}, centers {cdiff:.3e}; each "
                f"rank a step: launches "
                f"{ {k: n for k, n in want.items() if n} } and K3 "
                f"(cross_mil) 0, halo bytes sent "
                f"{m['halo_send_bytes_per_step']}, all_reduce "
                f"{m['all_reduce_bytes_per_step']} B, all_gather "
                f"{m['all_gather_bytes_per_step']} B; step host to host "
                f"{step_ms:.2f} ms on gloo staged through host memory with "
                f"{data * frame} processes sharing one card (not an NCCL "
                f"number), single device ({route}) "
                f"{m['step_host_ms_single']:.2f} ms — {card_line()}")
    if problems:
        fail("; ".join(problems))
    return res


def sp_kernel_inputs(torch, root: str, tmp: str, data: int, frame: int,
                     w: int, d: int, f: int):
    """Rank (d, f)'s kernel inputs on the first training batch from the
    initial params: its rows and frames, and the halo-extended v̂ and
    masks with its neighbours' real frames (the window of the zero-padded
    global tensor, which halo_exchange gives): (w_emb, v, v_ext, fm_ext,
    rm_ext, fm, rm, centers) on the card, f32."""
    F = torch.nn.functional
    from nafae_torch.ops import grounding as TG
    from nafae_torch.train import TrainState, batch_to_device

    dev = torch.device("cuda")
    tb = batch_to_device(first_batch(root), dev)
    cfg = sp_cfg(root, os.path.join(tmp, "ck_sp"), "pallas", data, frame, w)
    state = TrainState.create(cfg, device=dev)
    p = state.params
    b_loc, t_loc = 16 // data, 20 // frame
    rows = slice(d * b_loc, (d + 1) * b_loc)
    frames = slice(f * t_loc, (f + 1) * t_loc)
    ext = slice(f * t_loc, f * t_loc + t_loc + 2 * w)
    fm, rm = tb["frame_mask"][rows], tb["region_mask"][rows]
    with torch.no_grad():
        w_emb = TG.embed_words(tb["word_ids"][rows], p["word_emb"])
        v = TG.project_regions(tb["feats"][rows], p["w_v"], p["b_v"])
    v_ext = F.pad(v, (0, 0, 0, 0, w, w))[:, ext].contiguous()
    fm_ext = F.pad(fm, (w, w))[:, ext].contiguous()
    rm_ext = F.pad(rm, (0, 0, w, w))[:, ext].contiguous()
    return (w_emb, v[:, frames].contiguous(), v_ext, fm_ext, rm_ext,
            fm[:, frames].contiguous(), rm[:, frames].contiguous(),
            state.centers)


def check_sp_kernels(torch, root: str, tmp: str) -> dict:
    """Phase 13 (c): K1fr, K1b, K1br (compare_grad_kernels) and K4f, K4b
    (compare_diag) against their plain versions on SP_KERNEL_RANKS' inputs
    at T_local with real halos, f32 and bf16, at phases 3 and 8's
    tolerances; on the first, device times (CUDA graphs) of K1fr, K1br,
    K4f and K4b and of their plain versions, with their bounds."""
    from nafae_torch.ops.kernels import ctx_mix as K
    from nafae_torch.ops.kernels import diag as K4

    res = {}
    for n, ((data, frame, w), d, f) in enumerate(SP_KERNEL_RANKS):
        w_emb, v, v_ext, fm_ext, rm_ext, fm, rm, centers = sp_kernel_inputs(
            torch, root, tmp, data, frame, w, d, f)
        b, t, r, e = v.shape
        gen = torch.Generator().manual_seed(SEED + 13)
        du = torch.randn(b, t, r, e, generator=gen).to(v.device)
        with torch.no_grad():
            u, nbr = K.ctx_mix(v_ext, fm_ext, w, 0.1, rm_ext=rm_ext)
        hc = (nbr.sum(-1) > 0).float()
        tag = f"{data}x{frame}_w{w}"
        res["shapes_" + tag] = {"B": b, "T_local": t, "R": r, "E": e,
                                "w": w, "rank": [d, f]}
        for dt_name, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            case = f"{dt_name}, SP rank ({d}, {f}) of {data}x{frame} " \
                f"(B={b} T_local={t} w={w}, real halos)"
            res[f"k1_errs_{tag}_{dt_name}"] = compare_grad_kernels(
                torch, v_ext.to(dt), fm_ext, rm_ext, w, du, dt_name, case)
            res[f"k4_errs_{tag}_{dt_name}"] = compare_diag(
                torch, w_emb.to(dt), v.to(dt), u.to(dt), centers, fm, hc,
                rm, case)
        if n:
            continue
        vc = v_ext
        _, alpha = K.launch_fwd(vc, fm_ext, w, 0.1, rm_ext, residual=True)
        res["k1fr_ms"] = device_ms(torch, lambda: K.launch_fwd(
            vc, fm_ext, w, 0.1, rm_ext, residual=True))
        res["k1br_ms"] = device_ms(torch, lambda: K.launch_bwd(
            vc, fm_ext, w, 0.1, rm_ext, du, alpha))
        vp = vc.detach().clone().requires_grad_()
        res["k1fr_plain_ms"] = profile_forward(
            torch, lambda: K.context_mix_plain(vp, fm_ext, w, 0.1,
                                               rm_ext=rm_ext))[1]
        up, _ = K.context_mix_plain(vp, fm_ext, w, 0.1, rm_ext=rm_ext)
        res["k1br_plain_ms"] = profile_forward(
            torch, lambda: torch.autograd.grad(up, vp, du,
                                               retain_graph=True))[1]
        res["k1fr_bound_ms"], res["k1fr_bound_by"] = fwd_bound_ms(
            torch, vc, fm_ext, rm_ext, w, True)
        res["k1br_bound_ms"], res["k1br_bound_by"] = bwd_bound_ms(
            torch, vc, fm_ext, rm_ext, w, True)
        fwd = K4.launch_fwd(w_emb, v, u, centers, fm, hc, rm)
        dctx = torch.rand(fwd[0].shape, generator=gen).to(v.device)
        dclu = torch.rand(fwd[1].shape, generator=gen).to(v.device)
        args = (w_emb, v, centers, fwd[3], fwd[4], fwd[5], fwd[2], dctx,
                dclu)
        dw, dv = K4.launch_bwd(*args)
        torch.cuda.synchronize()
        res["k4f_ms"] = device_ms(torch, lambda: K4.launch_fwd(
            w_emb, v, u, centers, fm, hc, rm))
        res["k4b_ms"] = device_ms(torch, lambda: K4.launch_bwd(*args))
        res["k4f_plain_ms"] = device_ms(torch, lambda: K4.diag_fwd_plain(
            w_emb, v, u, centers, fm, hc, rm))
        res["k4b_plain_ms"] = device_ms(torch,
                                        lambda: K4.diag_bwd_plain(*args))
        (res["k4f_bound_ms"], res["k4f_bound_by"]), \
            (res["k4b_bound_ms"], res["k4b_bound_by"]) = diag_bounds(
                torch, w_emb, v, centers, fm, hc, rm, fwd, dctx, dclu, dw, dv)
    errs = {k: max(x.get("ctx_mix_fwd_res", 0.0), x.get("ctx_mix_bwd_res",
                                                        0.0),
                   x.get("clu", 0.0), x.get("dw", 0.0), x.get("dv", 0.0))
            for k, x in res.items() if "_errs_" in k}
    log("K1fr/K1b/K1br and K4f/K4b vs plain at the SP ranks' T_local with "
        "real halos: max |err| " + ", ".join(f"{k} {v:.3e}"
                                             for k, v in errs.items())
        + f"; at {res['shapes_2x2_w3']} f32: K1fr {res['k1fr_ms']:.4f} ms "
        f"(plain {res['k1fr_plain_ms']:.4f}, bound "
        f"{res['k1fr_bound_ms']:.4f} {res['k1fr_bound_by']}), K1br "
        f"{res['k1br_ms']:.4f} ms (plain {res['k1br_plain_ms']:.4f}, bound "
        f"{res['k1br_bound_ms']:.4f} {res['k1br_bound_by']}), K4f "
        f"{res['k4f_ms']:.4f} ms (plain {res['k4f_plain_ms']:.4f}, bound "
        f"{res['k4f_bound_ms']:.4f} {res['k4f_bound_by']}), K4b "
        f"{res['k4b_ms']:.4f} ms (plain {res['k4b_plain_ms']:.4f}, bound "
        f"{res['k4b_bound_ms']:.4f} {res['k4b_bound_by']}) — {card_line()}")
    return res


# ------- the device-resident dataset, steps_per_call, the native packer and
# grain (phase 14)

CACHE_SPC = 3                    # train.steps_per_call of the cached runs
CACHE_STEPS = 7                  # calls of 3, 3 and 1 steps
CACHE_LOGGED = [3, 6, 7]         # the steps those calls log at log_every=1
# (b): a seeded two-bucket dataset at config-4 widths, trained in groups
BUCKET_SEGMENTS = 64
BUCKET_FRAMES = (6, 20)
BUCKETS = (10, 20)
# (d): an in-memory cache of seeded f16 segments at config-4 widths:
# 2560 x 20 x 20 x 2048 x 2 B = 4.19 GB of features
SCALE_SEGMENTS = 2560
TIMED_ROUNDS = 12                # interleaved rounds of each timing
# (e), end to end: fit's own rows, a step each, from the ways below
FIT_TIMED_STEPS = 16
FIT_WAYS = {"native": [], "python": ["data.use_native_io=false"],
            "cached": ["train.device_cache=true"]}


def cache_cfg(root: str, ckpt: str, route: str, extra=()):
    """Phase 5's f32 config4 run of `route` with the dataset on the device,
    CACHE_STEPS steps in calls of CACHE_SPC."""
    from nafae_torch.config import load_config

    return load_config(preset_name="config4", overrides=TRAIN_OVERRIDES + [
        f"data.root={root}", f"train.ckpt_dir={ckpt}", "model.dtype=float32",
        f"train.steps={CACHE_STEPS}", f"train.kernels={route}",
        "train.device_cache=true", f"train.steps_per_call={CACHE_SPC}",
        *extra])


def host_index_stream(n: int, bsz: int, seed: int, steps: int):
    """The reference's cached index stream, worked out on the host: a
    RandomState(seed) permutation of the n segments an epoch, batches of
    bsz across epoch boundaries; one index array a step."""
    rng = np.random.RandomState(seed)
    order: list = []
    for _ in range(steps):
        while len(order) < bsz:
            ep = np.arange(n)
            rng.shuffle(ep)
            order.extend(ep.tolist())
        yield np.asarray(order[:bsz])
        order = order[bsz:]


def cache_host(root: str) -> dict:
    """Phase 5's training segments stacked on the host (every key but
    boxes), as the cache holds them."""
    from nafae_torch.data.youcook2 import SegmentDataset

    ds = SegmentDataset(root, "train", 20, 20, 2048, 8)
    samples = [ds[i] for i in range(len(ds))]
    return {k: np.stack([s[k] for s in samples])
            for k in samples[0] if k != "boxes"}


def check_cache(torch, root: str, tmp: str) -> dict:
    """Phase 14 (a): fit with train.device_cache, f32, on each route
    (CACHE_STEPS steps in calls of CACHE_SPC): launches per step, the
    logged steps, and the run bit for bit train_step on the card over the
    same index stream gathered on the host (metrics of every logged step,
    params, centers); the auto route's first CPU_STEPS steps re-run on the
    CPU, a row a step, against that replay's rows as phase 5 holds its own
    (`cpu_rows_agree`), and one step's gradients within CPU_GRAD_TOL."""
    from nafae_torch.train import (TrainState, batch_to_device, fit,
                                   make_optimizer, train_step)

    dev = torch.device("cuda")
    host = cache_host(root)
    n = len(host["frame_mask"])
    out = {}
    for route in ROUTES:
        cfg = cache_cfg(root, os.path.join(tmp, f"ck_cache_{route}"), route)
        logs = []
        zero_counts()                           # main path starts here
        t0 = time.perf_counter()
        state, _ = fit(cfg, log_fn=logs.append)
        wall = time.perf_counter() - t0
        counts = read_counts()                  # ... and ends here
        want = {k: v * CACHE_STEPS
                for k, v in per_step_launches(route).items()}
        if counts != want:
            fail(f"cached fit ({route}) launched {counts}, expected {want}")
        if [m["step"] for m in logs] != CACHE_LOGGED:
            fail(f"cached fit ({route}) logged steps "
                 f"{[m['step'] for m in logs]}, expected {CACHE_LOGGED}")
        st, tx = TrainState.create(cfg, device=dev), make_optimizer(cfg)
        replay = {}
        for step, idx in enumerate(host_index_stream(
                n, cfg.data.batch_size, cfg.train.seed, CACHE_STEPS), 1):
            st, m = train_step(st, batch_to_device(
                {k: v[idx] for k, v in host.items()}, dev), cfg, tx)
            replay[step] = {k: float(v) for k, v in m.items()}
        for m in logs:
            if not metrics_equal(replay[m["step"]], m):
                fail(f"cached fit ({route}) step {m['step']}: {m} differs "
                     f"from train_step on host-gathered batches: "
                     f"{replay[m['step']]}")
        bad = [k for k in st.params if not torch.equal(st.params[k],
                                                       state.params[k])]
        if bad or not torch.equal(st.centers, state.centers):
            fail(f"cached fit ({route}): params {bad} or centers differ from "
                 "train_step on host-gathered batches")
        log(f"cached fit ({route}, f32 config4 B=16 T=20, {CACHE_STEPS} "
            f"steps in calls of {CACHE_SPC}) in {wall:.2f} s incl. the "
            f"upload: logged steps {CACHE_LOGGED}, bit for bit train_step "
            f"on the same index stream gathered on the host; launches "
            f"{counts}")
        out[route] = {"logs": logs, "launches": counts, "state": state,
                      "wall_s": wall,
                      "replay": [{**m, "step": s} for s, m in replay.items()]}
    # the CPU re-run in calls of one step, each logged: the index stream
    # does not depend on steps_per_call, so its rows are the replay's
    cfg = cache_cfg(root, os.path.join(tmp, "ck_cache_cpu"), "auto",
                    [f"train.steps={CPU_STEPS}", "train.steps_per_call=1"])
    cpu_logs = []
    fit(cfg, device="cpu", log_fn=cpu_logs.append)
    if [m["step"] for m in cpu_logs] != list(range(1, CPU_STEPS + 1)):
        fail(f"the cached CPU re-run logged steps "
             f"{[m['step'] for m in cpu_logs]}")
    out["cpu"] = cpu_rows_agree(out["auto"]["replay"], cpu_logs, "cached")
    # ... and one step's gradients on the first cached batch, card vs CPU
    idx = next(host_index_stream(n, cfg.data.batch_size, cfg.train.seed, 1))
    gworst = grads_agree(torch, cfg, {k: v[idx] for k, v in host.items()},
                         "auto")
    log(f"cached fit re-run on the CPU (auto, a row a step): rows 1-"
        f"{CPU_STEPS} agree with the card's, max relative diff "
        f"{out['cpu']:.3e} (limit "
        f"{CPU_METRIC_TOL}); the first cached batch's gradients, max |diff| "
        f"/ largest entry {gworst:.3e} (limit {CPU_GRAD_TOL})")
    out["cpu_grad_rel_diff"] = gworst
    return out


def cpu_rows_agree(card: list[dict], cpu: list[dict], what: str) -> float:
    """The CPU run's metrics rows through step CPU_STEPS, each against the
    card run's row at its step, within CPU_METRIC_TOL; returns the largest
    relative difference. Only the first steps are held: later Adam steps
    can turn a last-digit difference of a tiny gradient into a full step."""
    at = {m["step"]: m for m in card}
    rtol, atol = CPU_METRIC_TOL
    worst = 0.0
    for c in cpu:
        if c["step"] > CPU_STEPS:
            continue
        g = at.get(c["step"])
        if g is None:
            fail(f"{what}: the card run has no row at step {c['step']}")
        for k in c:
            if k in RATES:
                continue
            if not np.isclose(g[k], c[k], rtol=rtol, atol=atol):
                fail(f"{what} step {c['step']} {k}: card {g[k]} vs CPU "
                     f"{c[k]}")
            worst = max(worst, abs(g[k] - c[k]) / max(abs(c[k]), 1e-30))
    return worst


def recorded_fit(torch, cfg, device: str) -> dict:
    """fit on `device` with every batch recorded where fit hands it to the
    step function `build_train_fn` returned: the rows, the segment ids of
    each applied batch, and the params before the first step and before
    and after step CPU_STEPS (on the host)."""
    seen, params = [], {}

    def on_host(state):
        return {k: v.detach().cpu().clone() for k, v in state.params.items()}

    def wrap(fn):
        def step(state, batch):
            if not seen:
                params["init"] = on_host(state)
            seen.append(np.asarray(batch["segment_id"]).copy())
            if len(seen) == CPU_STEPS:
                params["before"] = on_host(state)
            state, m = fn(state, batch)
            if len(seen) == CPU_STEPS:
                params["after"] = on_host(state)
            return state, m
        return step

    logs = traced_fit(torch, cfg, device=device, wrap=wrap)["logs"]
    return {"logs": logs, "seen": seen, **params}


def check_grouping(torch, tmp: str) -> dict:
    """Phase 14 (b): the streaming fit at steps_per_call CACHE_SPC on a
    seeded two-bucket dataset at config-4 widths (segments of 6-20 frames,
    data.frame_buckets (10, 20)), packed by the C++ packer, on the card and
    on the CPU: on the card the auto route's launches a step; the batches
    applied out of the loader's yield order, with the CPU run's segment ids
    in the CPU run's order (tests/test_torch_train.py holds that order
    against the reference's); the rows at the CPU run's steps, through step
    CPU_STEPS within `cpu_rows_agree`'s bounds, and the params after step
    CPU_STEPS within CPU_UPDATE_TOL."""
    from nafae_torch.config import load_config
    from nafae_torch.data.loader import epoch_batches
    from nafae_torch.data.synthetic import generate_synthetic_dataset
    from nafae_torch.data.youcook2 import SegmentDataset
    from nafae_torch.utils import native_io

    root = os.path.join(tmp, "buckets")
    generate_synthetic_dataset(root, "train", num_segments=BUCKET_SEGMENTS,
                               feat_dim=2048, num_regions=20,
                               min_frames=BUCKET_FRAMES[0],
                               max_frames=BUCKET_FRAMES[1], max_words=8,
                               seed=SEED + 14)

    def cfg(ckpt):
        return load_config(preset_name="config4", overrides=TRAIN_OVERRIDES + [
            f"data.root={root}", f"train.ckpt_dir={ckpt}",
            "model.dtype=float32", "train.kernels=auto",
            f"train.steps={CACHE_STEPS}", f"train.steps_per_call={CACHE_SPC}",
            f"data.frame_buckets=[{BUCKETS[0]},{BUCKETS[1]}]"])

    c = cfg(os.path.join(tmp, "ck_groups"))
    native_io.packs["packer_pack"] = 0
    zero_counts()                               # main path starts here
    card = recorded_fit(torch, c, "cuda")
    counts = read_counts()                      # ... and ends here
    packs = native_io.packs["packer_pack"]
    want = {k: n * CACHE_STEPS for k, n in per_step_launches("auto").items()}
    if counts != want:
        fail(f"the grouped streaming fit launched {counts}, expected {want}")
    if packs == 0:
        fail("the streaming fit packed no batch with the C++ packer")
    cpu = recorded_fit(torch, cfg(os.path.join(tmp, "ck_groups_cpu")), "cpu")
    ds = SegmentDataset(root, "train", 20, 20, 2048, 8, frame_buckets=BUCKETS)
    yields = [b for e in range(8) for b in epoch_batches(
        ds, 16, True, c.train.seed, True, e)][:CACHE_STEPS]
    seen = card["seen"]
    if len(seen) != len(cpu["seen"]) or not all(
            np.array_equal(a, b) for a, b in zip(seen, cpu["seen"])):
        fail(f"the grouped fit applied segments {[a.tolist() for a in seen]} "
             f"on the card, {[b.tolist() for b in cpu['seen']]} on the CPU")
    if len(seen) != CACHE_STEPS or all(
            np.array_equal(a, b) for a, b in zip(seen, yields)):
        fail(f"the grouped fit applied {len(seen)} batches in the loader's "
             f"yield order: the data does not exercise the grouping")
    steps = [m["step"] for m in card["logs"]]
    if steps != CACHE_LOGGED or steps != [m["step"] for m in cpu["logs"]]:
        fail(f"the grouped fit logged steps {steps} on the card, "
             f"{[m['step'] for m in cpu['logs']]} on the CPU")
    worst = cpu_rows_agree(card["logs"], cpu["logs"], "grouped")
    diffs = {k: max(abs(g[k] - c[k]) for g, c in zip(card["logs"],
                                                      cpu["logs"])
                    if c["step"] <= CPU_STEPS)
             for k in cpu["logs"][0] if k not in RATES}
    # every row's f32 values card against CPU, in units in the last place
    ulps = {c["step"]: {k: abs(int(np.float32(g[k]).view(np.int32))
                               - int(np.float32(c[k]).view(np.int32)))
                        for k in c if k not in RATES and k != "step"}
            for g, c in zip(card["logs"], cpu["logs"])}
    upd = {}
    for k, p in cpu["after"].items():
        moved = float((p - cpu["init"][k]).norm())
        off = float((card["after"][k] - p).norm())
        upd[k] = {"update_norm": moved, "diff_norm": off,
                  "diff_max": float((card["after"][k] - p).abs().max())}
        if off > CPU_UPDATE_TOL * moved:
            fail(f"grouped fit: {k} after step {CPU_STEPS} is {off} off the "
                 f"CPU's, its update's norm {moved} (limit x{CPU_UPDATE_TOL})")
        # the params the step-CPU_STEPS row is computed from: the share of
        # their entries that are the same bits on the card and the CPU
        upd[k]["same_bits_before"] = float(
            (card["before"][k] == cpu["before"][k]).double().mean())
    ratios = {k: u["diff_norm"] / max(u["update_norm"], 1e-30)
              for k, u in upd.items()}
    uworst = max(ratios.values())
    buckets = [int(ds.bucket_of(int(b[0]))) for b in seen]
    log(f"streaming fit at steps_per_call={CACHE_SPC} over buckets "
        f"{BUCKETS} ({BUCKET_SEGMENTS} segments of {BUCKET_FRAMES[0]}-"
        f"{BUCKET_FRAMES[1]} frames, config-4 widths, f32 auto): applied "
        f"batches of buckets {buckets}, out of the yield order, the CPU "
        f"run's segment ids in its order; rows at steps {steps}, through "
        f"step {CPU_STEPS} within {CPU_METRIC_TOL} of the CPU's (max "
        f"relative diff {worst:.3e}; max |diff| by key {diffs}; ulps apart "
        f"by step and key {ulps}); params "
        f"after step {CPU_STEPS}: |card - CPU| / |update| at most "
        f"{uworst:.3e} (limit {CPU_UPDATE_TOL}), by leaf "
        + ", ".join(f"{k} {r:.3e}" for k, r in ratios.items())
        + f"; before step {CPU_STEPS} the same bits on card and CPU in "
        + ", ".join(f"{k} {u['same_bits_before']:.1%}"
                    for k, u in upd.items())
        + f" of the entries; launches {counts}; {packs} batches packed in "
        "C++")
    return {"buckets": buckets, "packs": packs, "launches": counts,
            "seen": [a.tolist() for a in seen], "cpu_rel_diff": worst, "cpu_abs_diff_by_key": diffs,
            "ulps": ulps,
            "param_update_rel_diff": uworst, "params": upd, "steps": steps,
            "rows": {"card": card["logs"], "cpu": cpu["logs"]}}


def cache_rank(rank: int, port: int, root: str, tmp: str) -> None:
    """One rank of phase 14's 1x2 world on cuda:0 over gloo: the cached
    fit of the auto route with mesh.frame_axis 2 (each rank caching half of
    the frames), its launches read around it; pickles what it saw."""
    import pickle
    import warnings

    import torch

    from nafae_torch.parallel.mesh import make_mesh, shutdown
    from nafae_torch.train import fit

    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mesh = make_mesh(1, 2, device="cuda", backend="gloo")
    cfg = cache_cfg(root, os.path.join(tmp, "ck_cache_sp"), "auto",
                    ["mesh.data_axis=1", "mesh.frame_axis=2"])
    logs = []
    zero_counts()                               # main path starts here
    state, _ = fit(cfg, log_fn=logs.append, mesh=mesh)
    counts = read_counts()                      # ... and ends here
    out = {"logs": logs, "launches": counts,
           "params": {k: v.cpu().numpy() for k, v in state.params.items()},
           "centers": state.centers.cpu().numpy()}
    shutdown()
    with open(os.path.join(tmp, f"cache_out_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def check_cache_meshes(torch, root: str, tmp: str, mesh, cached) -> dict:
    """Phase 14 (c): the cached fit on phase 12's world-of-one NCCL mesh,
    on each route, bit for bit the run without a mesh (phase 14 (a)); then
    a 1x2 frame-parallel world of two processes on cuda:0 over gloo, each
    rank caching half of the frames, within phase 13's SP_METRIC_TOL and
    SP_PARAM_TOL of the single device's cached run."""
    from nafae_torch.train import fit

    for route in ROUTES:
        logs = []
        cfg = cache_cfg(root, os.path.join(tmp, f"ck_cache_dp_{route}"),
                        route)
        zero_counts()                           # main path starts here
        state, _ = fit(cfg, log_fn=logs.append, mesh=mesh)
        counts = read_counts()                  # ... and ends here
        single = cached[route]
        if counts != single["launches"]:
            fail(f"cached fit on the NCCL mesh ({route}) launched {counts}, "
                 f"without a mesh {single['launches']}")
        if len(logs) != len(single["logs"]) or not all(
                metrics_equal(a, b) and set(a) == set(b)
                for a, b in zip(logs, single["logs"])):
            fail(f"cached fit on the NCCL mesh ({route}): {logs} vs "
                 f"{single['logs']}")
        bad = [k for k in state.params
               if not torch.equal(state.params[k], single["state"].params[k])]
        if bad or not torch.equal(state.centers, single["state"].centers):
            fail(f"cached fit on the NCCL mesh ({route}): params {bad} or "
                 "centers differ from the run without a mesh")
    log("cached fit on a world-of-one NCCL mesh: both routes bit for bit "
        "the runs without a mesh (rows, params, centers, launches)")
    outs = sp_spawn(root, tmp, cache_rank, 2, "cache_out")
    single = cached["auto"]
    want = {k: n * CACHE_STEPS for k, n in sp_launches("auto").items()}
    rtol, atol = SP_METRIC_TOL
    worst = 0.0
    for rank, o in enumerate(outs):
        if o["launches"] != want:
            fail(f"1x2 cached rank {rank} launched {o['launches']}, "
                 f"expected {want}")
    if outs[1]["logs"] or [m["step"] for m in outs[0]["logs"]] != \
            CACHE_LOGGED:
        fail(f"1x2 cached fit: rank 0 logged {outs[0]['logs']}, rank 1 "
             f"{outs[1]['logs']}")
    for g, s in zip(outs[0]["logs"], single["logs"]):
        for k in s:
            if k in RATES:
                continue
            if not np.isclose(g[k], s[k], rtol=rtol, atol=atol):
                fail(f"1x2 cached step {s['step']} {k}: {g[k]} vs single "
                     f"device {s[k]}")
            worst = max(worst, abs(g[k] - s[k]) / max(abs(s[k]), 1e-30))
    perr = max(float(np.abs(o["params"][k]
                            - single["state"].params[k].cpu().numpy()).max())
               for o in outs for k in o["params"])
    cerr = max(float(np.abs(o["centers"]
                            - single["state"].centers.cpu().numpy()).max())
               for o in outs)
    if perr > SP_PARAM_TOL or cerr > SP_PARAM_TOL:
        fail(f"1x2 cached fit: params {perr} / centers {cerr} off the single "
             f"device's (limit {SP_PARAM_TOL})")
    log(f"cached fit on a 1x2 gloo world on cuda:0 (each rank caching T/2 "
        f"frames): rows within rtol {rtol} (max relative diff {worst:.3e}), "
        f"params within {perr:.3e} and centers within {cerr:.3e} of the "
        f"single device's; launches per rank {outs[0]['launches']}")
    return {"sp_metric_rel_diff": worst, "sp_param_err": perr,
            "sp_center_err": cerr}


class MemorySegments:
    """n seeded config-4-width segments in host memory, as SegmentDataset
    gives them (f16 feats, 20 frames, 20 regions, up to 8 words). The
    features are f16 numbers in [0.125, 1), non-negative as RoI features
    after a ReLU are: 256 segments of bit patterns drawn uniformly, and
    segment i the draw i % 256 with its lowest mantissa bits xor i // 256
    (drawing all of them would take most of a minute)."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        base = rng.integers(0x3000, 0x3C00, (min(n, 256), 20, 20, 2048),
                            dtype=np.uint16)
        bits = np.empty((n, 20, 20, 2048), np.uint16)
        for a in range(0, n, len(base)):
            b = min(a + len(base), n)
            np.bitwise_xor(base[:b - a], np.uint16(a // len(base)),
                           out=bits[a:b])
        self.feats = bits.view(np.float16)
        self.word_ids = rng.integers(0, 67, (n, 8)).astype(np.int32)
        self.words = rng.integers(1, 9, n)
        self.frames = rng.integers(4, 21, n)

    def __len__(self) -> int:
        return len(self.feats)

    def __getitem__(self, i: int) -> dict:
        fm = (np.arange(20) < self.frames[i]).astype(np.float32)
        return {"feats": self.feats[i], "boxes": np.zeros((20, 20, 4),
                                                          np.float32),
                "word_ids": self.word_ids[i],
                "frame_mask": fm,
                "word_mask": (np.arange(8) < self.words[i]).astype(
                    np.float32),
                "region_mask": np.repeat(fm[:, None], 20, 1),
                "segment_id": np.int32(i)}


def check_cache_scale(torch, root: str, tmp: str) -> dict:
    """Phase 14 (d): `build_cache` of SCALE_SEGMENTS seeded f16 segments at
    config-4 widths (4.19 GB of features) from host memory: the seconds and
    the device memory it takes, its feats bit for bit the host's, and one
    f32 training step on a batch gathered from it."""
    from nafae_torch.train import (TrainState, build_cache, make_optimizer,
                                   train_step)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ds = MemorySegments(SCALE_SEGMENTS, SEED + 15)
    made = time.perf_counter() - t0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cache = build_cache(ds, dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - before
    feat_bytes = cache["feats"].numel() * cache["feats"].element_size()
    pick = [0, SCALE_SEGMENTS // 2, SCALE_SEGMENTS - 1]
    got = cache["feats"][pick].cpu().numpy()
    if cache["feats"].dtype != torch.float16 or not np.array_equal(
            got.view(np.uint16), ds.feats[pick].view(np.uint16)):
        fail("the f16 cache's feats are not the host's")
    cfg = cache_cfg(root, os.path.join(tmp, "ck_scale"), "auto",
                    ["data.transfer_dtype=float16"])
    idx = torch.arange(16, device=dev) * (SCALE_SEGMENTS // 16)
    st = TrainState.create(cfg, device=dev)
    st, m = train_step(st, {k: v.index_select(0, idx)
                            for k, v in cache.items()}, cfg,
                       make_optimizer(cfg))
    loss = float(m["loss"])
    if not np.isfinite(loss):
        fail(f"a step on the f16 cache gave loss {loss}")
    del cache, st, m
    torch.cuda.empty_cache()
    log(f"device cache of {SCALE_SEGMENTS} f16 segments at config-4 widths: "
        f"feats {feat_bytes / 1e9:.3f} GB, {held / 2**30:.3f} GiB of device "
        f"memory in all, uploaded by build_cache in {secs:.2f} s "
        f"({feat_bytes / secs / 1e9:.2f} GB/s of feats, host stacking "
        f"included; the segments took {made:.2f} s to make); a step on a "
        f"gathered batch: loss {loss:.5f}")
    return {"segments": SCALE_SEGMENTS, "feat_bytes": feat_bytes,
            "device_bytes": held, "upload_s": secs, "make_s": made}


def cache_timings(torch, root: str, tmp: str) -> dict:
    """Phase 14 (e): the f32 auto step at config 4 host to host (metrics
    on the host), streaming (the numpy batch copied in, as fit does) and
    cached (the batch gathered from the device cache), TIMED_ROUNDS
    interleaved rounds each from step 3 (one k-means refresh among them,
    at step 10, as in training); torch.profiler's device busy time of a
    step of each (the streaming one's includes the batch's copy), and the
    idle share of host to host."""
    from nafae_torch.data.loader import BatchLoader
    from nafae_torch.data.youcook2 import SegmentDataset
    from nafae_torch.train import (TrainState, batch_to_device, build_cache,
                                   make_optimizer, train_step)

    dev = torch.device("cuda")
    ds = SegmentDataset(root, "train", 20, 20, 2048, 8)
    batches = [b for _, b in BatchLoader(ds, 16, seed=0).steps(4)]
    cache = build_cache(ds, dev)
    idxs = [torch.from_numpy(b["segment_id"].astype(np.int64)).to(dev)
            for b in batches]
    cfg = cache_cfg(root, os.path.join(tmp, "ck_time_cache"), "auto",
                    ["train.steps=1000"])
    tx = make_optimizer(cfg)
    # one state a way, each advanced by its own steps: the k-means refresh
    # (every loss.kmeans_interval steps) falls on the same steps of both
    states = {name: TrainState.create(cfg, device=dev)
              for name in ("streaming", "cached")}

    def streaming(i):
        return train_step(states["streaming"],
                          batch_to_device(batches[i % 4], dev), cfg, tx)

    def cached(i):
        return train_step(states["cached"],
                          {k: v.index_select(0, idxs[i % 4])
                           for k, v in cache.items()}, cfg, tx)

    ways = (("streaming", streaming), ("cached", cached))
    for i in range(3):
        for name, fn in ways:
            states[name], _ = fn(i)
    torch.cuda.synchronize()
    host = {"streaming": [], "cached": []}
    for i in range(TIMED_ROUNDS):
        for name, fn in ways:
            t0 = time.perf_counter()
            states[name], m = fn(i)
            float(m["loss"])                    # metrics ready on the host
            host[name].append((time.perf_counter() - t0) * 1e3)
    res = {"batch_bytes": int(sum(v.nbytes for v in batches[0].values()))}
    for name, fn in ways:       # at step 15: no k-means refresh
        top, busy, ops = profile_forward(torch, lambda: fn(0))
        ms = statistics.median(host[name])
        res[name] = {"host_ms": ms, "host_ms_all": host[name],
                     "device_busy_ms": busy, "device_ops": ops,
                     "idle_share": 1 - busy / ms, "kernels": top}
    del cache
    torch.cuda.empty_cache()
    return res


def fit_timings(torch, root: str, tmp: str) -> dict:
    """Phase 14 (e), end to end: `fit` itself on phase 5's data, f32 auto,
    FIT_TIMED_STEPS steps a call of one step and a row a step, in each of
    FIT_WAYS: streaming with the C++ packer (data.use_native_io, the
    default), streaming with the Python packer, and cached; two rounds, in
    the order native, python, cached, then back. A row's frames_per_sec is
    over the step before it (the wait for the loader, the step, its metrics
    read on the host), so its ms = B*T / frames_per_sec; medians of the
    rows from step 4 of both rounds."""
    from nafae_torch.config import load_config
    from nafae_torch.train import fit
    from nafae_torch.utils import native_io

    ways = list(FIT_WAYS) + list(FIT_WAYS)[::-1]
    ms: dict = {w: [] for w in FIT_WAYS}
    for i, way in enumerate(ways):
        cfg = load_config(preset_name="config4", overrides=TRAIN_OVERRIDES + [
            f"data.root={root}",
            f"train.ckpt_dir={os.path.join(tmp, f'ck_fit_{way}_{i}')}",
            "model.dtype=float32", "train.kernels=auto",
            f"train.steps={FIT_TIMED_STEPS}", *FIT_WAYS[way]])
        logs, before = [], native_io.packs["packer_pack"]
        fit(cfg, log_fn=logs.append)
        packs = native_io.packs["packer_pack"] - before
        if (packs > 0) != (way == "native"):
            fail(f"the timed fit ({way}) packed {packs} batches in C++")
        frames = cfg.data.batch_size * cfg.data.max_frames
        ms[way] += [frames * 1e3 / m["frames_per_sec"] for m in logs
                    if m["step"] > 3]
    return {w: {"ms": statistics.median(v), "ms_all": v}
            for w, v in ms.items()}


def check_packer(torch, root: str) -> dict:
    """Phase 14 (f): on the card's host, phase 5's batches (config-4 widths,
    B=16) packed by the C++ packer (data.use_native_io on) and by Python
    (off), bit for bit equal in f32 and f16; ms to pack a batch, each way,
    TIMED_ROUNDS interleaved rounds over the epoch's batches."""
    from nafae_torch.data.loader import BatchLoader
    from nafae_torch.data.youcook2 import SegmentDataset
    from nafae_torch.utils import native_io

    out = {}
    for dt in ("float32", "float16"):
        ds = SegmentDataset(root, "train", 20, 20, 2048, 8,
                            transfer_dtype=dt)
        nat = BatchLoader(ds, 16, seed=0, use_native=True)
        py = BatchLoader(ds, 16, seed=0, use_native=False)
        if nat._native is None:
            fail(f"the C++ packer did not engage ({dt})")
        before = native_io.packs["packer_pack"]
        lists = nat._epoch_batches(0)
        for idxs in lists:
            a, b = nat._make_batch(idxs), py._make_batch(idxs)
            for k in b:
                if a[k].dtype != b[k].dtype or a[k].tobytes() != \
                        b[k].tobytes():
                    fail(f"packed batch ({dt}) differs from Python's at {k}")
        times = {"native": [], "python": []}
        for i in range(TIMED_ROUNDS):
            idxs = lists[i % len(lists)]
            for name, fn in (("native", nat._make_batch),
                             ("python", py._make_batch)):
                t0 = time.perf_counter()
                fn(idxs)
                times[name].append((time.perf_counter() - t0) * 1e3)
        packs = native_io.packs["packer_pack"] - before
        if packs == 0:
            fail(f"the pack count did not move ({dt})")
        out[dt] = {"native_ms": statistics.median(times["native"]),
                   "python_ms": statistics.median(times["python"]),
                   "batch_bytes": int(sum(v.nbytes for v in a.values())),
                   "packs": packs}
    return out


def check_grain(torch, root: str, tmp: str) -> dict:
    """Phase 14 (g): 3 f32 steps of fit with data.pipeline=grain (grain's
    batch order, without grain) on phase 5's data: finite rows, the auto
    route's launches, and its first batch the one grain's order gives."""
    from nafae_torch.config import load_config
    from nafae_torch.data.grain_loader import index_shuffle

    cfg = load_config(preset_name="config4", overrides=TRAIN_OVERRIDES + [
        f"data.root={root}", f"train.ckpt_dir={os.path.join(tmp, 'ck_grain')}",
        "train.steps=3", "data.pipeline=grain"])
    zero_counts()                               # main path starts here
    run = traced_fit(torch, cfg)
    counts = read_counts()                      # ... and ends here
    logs, seen = run["logs"], [np.asarray(b["segment_id"])
                               for b in run["seen"]]
    if len(logs) != 3 or not all(np.isfinite(v) for m in logs
                                 for v in m.values()):
        fail(f"grain fit logged {logs}")
    want = {k: n * 3 for k, n in per_step_launches("auto").items()}
    if counts != want:
        fail(f"grain fit launched {counts}, expected {want}")
    order = index_shuffle(TRAIN_SEGMENTS, cfg.train.seed)
    if not np.array_equal(seen[0], order[:16]):
        fail(f"grain fit's first batch {seen[0]}, grain's order "
             f"{order[:16]}")
    log(f"fit with data.pipeline=grain: 3 steps, first batch segments "
        f"{seen[0].tolist()} (grain's order), loss {logs[0]['loss']:.5f} -> "
        f"{logs[-1]['loss']:.5f}; launches {counts}")
    return {"losses": [m["loss"] for m in logs], "launches": counts}


# ------------------------- the training step as CUDA graphs (phase 15)

GRAPH_STEPS = 7                  # steps of each phase-15 run
# k-means refreshes at steps 0, 3 and 6: both graphs of a shape replay
GRAPH_INTERVAL = ["loss.kmeans_interval=3"]
GRAPH_DTYPES = ("float32", "bfloat16")
GRAPH_SPC = (1, 3)
GRAPH_BANK = ["loss.kmeans_source=bank", "loss.bank_steps=4"]   # wraps
GRAPH_RESUME_AT = 4              # (f): stop here, then resume to 7


def graph_cfg(root: str, ckpt: str, dtype: str, route: str, spc: int,
              cached: bool, extra=()):
    """Phase 5's config4 run at full width, GRAPH_STEPS steps in calls of
    spc, refreshing every 3 steps, streaming or from the device cache."""
    from nafae_torch.config import load_config

    return load_config(preset_name="config4", overrides=TRAIN_OVERRIDES + [
        f"data.root={root}", f"train.ckpt_dir={ckpt}", f"model.dtype={dtype}",
        f"train.steps={GRAPH_STEPS}", f"train.kernels={route}",
        f"train.steps_per_call={spc}",
        f"train.device_cache={str(cached).lower()}", *GRAPH_INTERVAL,
        *extra])


def traced_fit(torch, cfg, device="cuda", mesh=None, wrap=None,
               record=True) -> dict:
    """`fit` as a user calls it, with the step programs it builds
    (`build_train_fn`) kept and, with `record`, every batch handed to them
    recorded (a host batch copied, an index batch cloned on the device);
    `wrap`, if given, wraps the recording step function. Returns {"logs",
    "state", "programs", "seen", "wall_s"}."""
    import nafae_torch.train as TT

    real, programs, seen = TT.build_train_fn, [], []

    def build(*a, **kw):
        prog = real(*a, **kw)
        programs.append(prog)

        def step(state, batch):
            if record:
                seen.append(batch.clone() if isinstance(batch, torch.Tensor)
                            else {k: np.array(v) for k, v in batch.items()})
            return prog(state, batch)
        return wrap(step) if wrap else step

    logs = []
    TT.build_train_fn = build
    t0 = time.perf_counter()
    try:
        state, _ = TT.fit(cfg, device=None if mesh is not None else device,
                          log_fn=logs.append, mesh=mesh)
    finally:
        TT.build_train_fn = real
    return {"logs": logs, "state": state, "programs": programs, "seen": seen,
            "wall_s": time.perf_counter() - t0}


def eager_chain(torch, cfg, seen, cache=None, extractor=None) -> dict:
    """train_step on the card, op by op, over the batches a traced fit
    applied (index batches gathered from `cache`; frames through
    `extractor`, config 5's detector), from the initial state fit starts
    from: {"rows": {step: metrics}, "state"}."""
    from nafae_torch.train import (TrainState, batch_to_device,
                                   make_optimizer, train_step)

    dev = torch.device("cuda")
    st, tx = TrainState.create(cfg, device=dev), make_optimizer(cfg)
    rows = {}
    for i, b in enumerate(seen, 1):
        batch = ({k: v.index_select(0, b) for k, v in cache.items()}
                 if cache is not None else batch_to_device(b, dev))
        st, m = train_step(st, batch, cfg, tx, extractor)
        rows[i] = {k: float(v) for k, v in m.items()}
    return {"rows": rows, "state": st}


def same_bits(torch, x, y) -> bool:
    if x is None or y is None:
        return x is y
    return x.shape == y.shape and x.dtype == y.dtype and torch.equal(
        x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8))


def state_diffs(torch, a, b) -> list[str]:
    """The parts of two TrainStates that are not the same bits: params,
    optimizer tensors and count, centers, bank, bank_valid, step."""
    bad = [f"params.{k}" for k in a.params
           if not same_bits(torch, a.params[k], b.params[k])]
    for name, d in a.opt_state.items():
        if isinstance(d, dict):
            bad += [f"{name}.{k}" for k in d
                    if not same_bits(torch, d[k], b.opt_state[name][k])]
        elif d != b.opt_state[name]:
            bad.append(name)
    bad += [n for n in ("centers", "bank", "bank_valid")
            if not same_bits(torch, getattr(a, n), getattr(b, n))]
    return bad + (["step"] if a.step != b.step else [])


def rows_differ(logs: list[dict], rows: dict) -> list[int]:
    """The logged steps whose row is not the eager chain's bit for bit."""
    return [m["step"] for m in logs
            if set(rows[m["step"]]) != set(m) - set(RATES) - {"step"}
            or not metrics_equal(rows[m["step"]], m)]


def expect_graphed(run: dict, what: str, graphs: int, steps: int,
                   eager: int = 0) -> dict:
    """The one program of a traced fit: captured, `graphs` graphs, a
    replay every step but `eager` eager ones; returns its stats."""
    if len(run["programs"]) != 1:
        fail(f"{what}: fit built {len(run['programs'])} step programs")
    from nafae_torch.train import WARMUP_STEPS

    prog = run["programs"][0]
    st = dict(prog.stats)
    if not prog.graphed or st["graphs"] != graphs or \
            st["replays"] != steps - eager or st["eager_steps"] != eager \
            or st["warmup_steps"] != graphs * WARMUP_STEPS:
        fail(f"{what}: the step program ran {st} (eager: "
             f"{prog.eager_reason}); expected {graphs} graphs, "
             f"{steps - eager} replays, {eager} eager steps and "
             f"{graphs * WARMUP_STEPS} warm-up steps")
    return st


# the device kernels that one launch of a wrapper on the graphed path runs,
# each once, as a profiler trace names them (substrings of the name)
TRACE_NAMES = {
    "ctx_mix_fwd": ("ctx_mix_fwd_pairs", "ctx_mix_fwd_mix"),
    "ctx_mix_fwd_res": ("ctx_mix_fwd_pairs", "ctx_mix_fwd_mix"),
    "ctx_mix_bwd_res": ("ctx_mix_bwd_pairs", "ctx_mix_bwd_gather"),
    "cross_mil": ("cross_mil_",),
    "diag_epilogue": ("diag_centers_kernel", "diag_fwd_kernel"),
    "diag_epilogue_bwd": ("diag_bwd_kernel",),
    "nms": ("nms_kernel",),
    "roi_align": ("roi_align_kernel",),
}


def traced_replay(torch, prog, call, per: dict, path: str,
                  kernels: dict = TRACE_NAMES, absent=()) -> dict:
    """call(), one more replay of a graphed program `prog` (a step without
    a refresh, or a serving batch), under torch.profiler, its trace
    written to `path` and read back as phase 12 reads the --profile trace:
    each kernel of `kernels` must be named there as often as `per` (the
    launches of a step or batch: per_step_launches or c5_launches) says,
    each of `absent` not at all, and the launch counts must have grown by
    just that. A name given as a tuple of substrings counts the kernels
    whose name holds all of them (an instantiation: ("ctx_mix_fwd_pairs",
    "__half")). Returns {name: times named}."""
    from torch.profiler import ProfilerActivity, profile

    was = dict(prog.stats)
    torch.cuda.synchronize()
    zero_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # late in a long run the trace has lost the first kernels of a
        # replay (phase 15, once): let the profiler see a launch of its
        # own (named like no kernel of the port) before the replay
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        call()
        torch.cuda.synchronize()
    counted = read_counts()
    if prog.stats["replays"] != was["replays"] + 1 or \
            prog.stats["graphs"] != was["graphs"]:
        fail(f"the traced step of {path} was no replay: {prog.stats}")
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    os.remove(path)
    want = dict.fromkeys(absent, 0)
    for key, subs in kernels.items():
        for sub in subs:
            want[sub] = want.get(sub, 0) + per[key]
    named = {sub: sum(all(p in n for p in ((sub,) if isinstance(sub, str)
                                           else sub)) for n in names)
             for sub in want}
    if named != want or counted != per:
        fail(f"the traced replay ({path}) names {named} (expected {want}) "
             f"among {len(names)} kernels; launches counted {counted}, "
             f"expected {per}")
    return named


def check_graphs(torch, root: str, tmp: str) -> dict:
    """Phase 15 (a, b): `fit` in f32 and bf16 on both routes, streaming and
    cached, at steps_per_call 1 and 3, GRAPH_STEPS steps with a k-means
    refresh every 3: each run captured in two graphs (refresh or not) and
    replayed every step, launches per_step_launches x steps, and its
    rows, params, centers and optimizer state bit for bit those of
    `train_step` run eagerly on the card over the same batches. The
    warm-up steps' launches, set apart from the counts, are
    per_step_launches x warm-up steps; after each spc-3 run one more
    step, traced (`traced_replay`), names each kernel of the route as
    often as the accounting adds for a replay."""
    from nafae_torch.train import WARMUP_STEPS

    out, base, traced = {}, {}, {}
    for dt in GRAPH_DTYPES:
        for route in ROUTES:
            for cached in (False, True):
                way = "cached" if cached else "streaming"
                eager = first = None
                for spc in GRAPH_SPC:
                    tag = f"{dt}_{route}_{way}_spc{spc}"
                    cfg = graph_cfg(root, os.path.join(tmp, "ck_g_" + tag),
                                    dt, route, spc, cached)
                    zero_counts()               # main path starts here
                    run = traced_fit(torch, cfg)
                    counts = read_counts()      # ... and ends here
                    want = {k: n * GRAPH_STEPS for k, n in
                            per_step_launches(route).items()}
                    if counts != want:
                        fail(f"graphed fit ({tag}) launched {counts}, "
                             f"expected {want}")
                    st = expect_graphed(run, f"graphed fit ({tag})", 2,
                                        GRAPH_STEPS)
                    warm = {k: n * 2 * WARMUP_STEPS for k, n in
                            per_step_launches(route).items() if n}
                    if st["warmup_launches"] != warm:
                        fail(f"graphed fit ({tag}): its warm-up steps "
                             f"launched {st['warmup_launches']}, expected "
                             f"{warm}")
                    prog, seen = run["programs"][0], run["seen"]
                    if eager is None:
                        eager = eager_chain(torch, cfg, seen, prog.cache)
                        first = seen
                    elif not all(np.array_equal(
                            a.cpu().numpy() if cached else a["segment_id"],
                            b.cpu().numpy() if cached else b["segment_id"])
                            for a, b in zip(seen, first)):
                        fail(f"graphed fit ({tag}) applied other batches "
                             "than at steps_per_call 1")
                    logged = ([3, 6, 7] if spc == 3
                              else list(range(1, GRAPH_STEPS + 1)))
                    if [m["step"] for m in run["logs"]] != logged:
                        fail(f"graphed fit ({tag}) logged steps "
                             f"{[m['step'] for m in run['logs']]}")
                    bad = rows_differ(run["logs"], eager["rows"])
                    bad += state_diffs(torch, run["state"], eager["state"])
                    if bad:
                        fail(f"graphed fit ({tag}) differs from the eager "
                             f"train_step chain in {bad}")
                    out[tag] = {**st, "launches": counts,
                                "wall_s": run["wall_s"]}
                    if spc == GRAPH_SPC[-1]:       # after the comparisons
                        traced[tag] = traced_replay(
                            torch, prog,
                            lambda: prog(run["state"], seen[-1]),
                            per_step_launches(route),
                            os.path.join(tmp, f"replay_{tag}.json"))
                    if dt == "float32" and way == "streaming" and spc == 1:
                        base[route] = {"logs": run["logs"],
                                       "state": run["state"]}
                    del run, prog
                del eager
                torch.cuda.empty_cache()
    worst = max(v["capture_s"] for v in out.values())
    log(f"phase 15 (a, b): {len(out)} graphed fits (f32 and bf16, auto and "
        f"pallas, streaming and cached, steps_per_call 1 and 3; "
        f"{GRAPH_STEPS} steps, refreshes at 0, 3, 6): rows, params, "
        "centers and optimizer state bit for bit the eager train_step "
        "chain on the same batches; launches per_step_launches x "
        f"{GRAPH_STEPS}; each 2 graphs, {GRAPH_STEPS} replays, no eager "
        f"step; apart from those, {2 * WARMUP_STEPS} warm-up steps a run "
        "launching per_step_launches x "
        f"{2 * WARMUP_STEPS} (" + ", ".join(
            f"{k} {v['warmup_launches']}" for k, v in out.items()
            if k.endswith("spc1") and "streaming" in k)
        + f"); capture s (both graphs, warm-up included) up to "
        f"{worst:.3f}; pool bytes " + ", ".join(
            f"{k} {v['pool_bytes']}" for k, v in out.items()
            if k.endswith("spc1")))
    log("phase 15 (b): one replayed step traced after each spc-3 run names "
        "each kernel as often as its launches were counted: " + "; ".join(
            f"{k} {v}" for k, v in traced.items()))
    return {"runs": out, "base": base, "traced_replays": traced}


def check_graph_buckets(torch, tmp: str, grouped: dict) -> dict:
    """Phase 15 (c): phase 14 (b)'s two-bucket streaming fit at
    steps_per_call 3, refreshing every 3 steps: a graph for each bucket
    and refresh or not that its steps reach (a pair a bucket), the
    batches in phase 14 (b)'s order, bit for bit the eager chain."""
    from nafae_torch.config import load_config

    root = os.path.join(tmp, "buckets")
    cfg = load_config(preset_name="config4", overrides=TRAIN_OVERRIDES + [
        f"data.root={root}", f"train.ckpt_dir={os.path.join(tmp, 'ck_gb')}",
        "model.dtype=float32", "train.kernels=auto",
        f"train.steps={GRAPH_STEPS}", f"train.steps_per_call={CACHE_SPC}",
        f"data.frame_buckets=[{BUCKETS[0]},{BUCKETS[1]}]", *GRAPH_INTERVAL])
    zero_counts()                               # main path starts here
    run = traced_fit(torch, cfg)
    counts = read_counts()                      # ... and ends here
    keys = sorted({(int(b["frame_mask"].shape[1]), i % 3 == 0)
                   for i, b in enumerate(run["seen"])})
    st = expect_graphed(run, "graphed two-bucket fit", len(keys),
                        GRAPH_STEPS)
    if {t for t, _ in keys} != set(BUCKETS) or len(keys) != 4:
        fail(f"the two-bucket fit's steps reach graphs {keys}, not a pair "
             "a bucket")
    ids = [b["segment_id"].tolist() for b in run["seen"]]
    if ids != grouped["seen"]:
        fail(f"the graphed two-bucket fit applied {ids}; phase 14 (b) "
             f"applied {grouped['seen']}")
    if [m["step"] for m in run["logs"]] != CACHE_LOGGED:
        fail(f"the graphed two-bucket fit logged {run['logs']}")
    want = {k: n * GRAPH_STEPS for k, n in per_step_launches("auto").items()}
    eager = eager_chain(torch, cfg, run["seen"])
    bad = rows_differ(run["logs"], eager["rows"])
    bad += state_diffs(torch, run["state"], eager["state"])
    if counts != want or bad:
        fail(f"graphed two-bucket fit: launches {counts} (expected {want}); "
             f"differs from the eager chain in {bad}")
    log(f"phase 15 (c): two-bucket streaming fit at steps_per_call "
        f"{CACHE_SPC}: graphs {keys} (frames, refresh), {st['graphs']} "
        f"captured, {st['replays']} replays; phase 14 (b)'s order; rows, "
        f"params and centers bit for bit the eager chain; launches {counts}")
    return {**st, "graph_keys": [list(k) for k in keys]}


def check_graph_seeded(torch, root: str, tmp: str) -> dict:
    """Phase 15 (b): with loss.kmeans_init=plusplus the seeding step 0
    draws its noise on the host and runs eagerly, and only it: the other
    steps replay the two graphs; bit for bit the eager chain (whose step 0
    seeds from the same generator)."""
    cfg = graph_cfg(root, os.path.join(tmp, "ck_gseed"), "float32", "auto",
                    1, False, ["loss.kmeans_init=plusplus"])
    zero_counts()                               # main path starts here
    run = traced_fit(torch, cfg)
    counts = read_counts()                      # ... and ends here
    st = expect_graphed(run, "graphed k-means++ fit", 2, GRAPH_STEPS, 1)
    eager = eager_chain(torch, cfg, run["seen"])
    bad = rows_differ(run["logs"], eager["rows"])
    bad += state_diffs(torch, run["state"], eager["state"])
    want = {k: n * GRAPH_STEPS for k, n in per_step_launches("auto").items()}
    if counts != want or bad:
        fail(f"graphed k-means++ fit: launches {counts} (expected {want}); "
             f"differs from the eager chain in {bad}")
    log(f"phase 15 (b): k-means++ seeding: step 0 eager, {st['replays']} "
        f"replays of {st['graphs']} graphs; bit for bit the eager chain")
    return st


def check_graph_bank(torch, root: str, tmp: str) -> dict:
    """Phase 15 (d): loss.kmeans_source=bank with bank_steps 4 over
    GRAPH_STEPS steps (the slot wraps at step 4, taken on the device),
    graphed, bit for bit the eager chain, bank and validity included."""
    cfg = graph_cfg(root, os.path.join(tmp, "ck_gbank"), "float32", "auto",
                    CACHE_SPC, False, GRAPH_BANK)
    zero_counts()                               # main path starts here
    run = traced_fit(torch, cfg)
    counts = read_counts()                      # ... and ends here
    st = expect_graphed(run, "graphed bank fit", 2, GRAPH_STEPS)
    eager = eager_chain(torch, cfg, run["seen"])
    bad = rows_differ(run["logs"], eager["rows"])
    bad += state_diffs(torch, run["state"], eager["state"])
    want = {k: n * GRAPH_STEPS for k, n in per_step_launches("auto").items()}
    if counts != want or bad:
        fail(f"graphed bank fit: launches {counts} (expected {want}); "
             f"differs from the eager chain in {bad}")
    slots = int(run["state"].bank_valid.flatten(1).amax(1).gt(0).sum())
    log(f"phase 15 (d): bank source, {GRAPH_STEPS} steps over a ring of 4 "
        f"({slots} slots written): graphed = eager bit for bit, bank and "
        "bank_valid included")
    return {**st, "slots_written": slots}


def check_graph_mesh(torch, root: str, tmp: str, mesh, base: dict) -> dict:
    """Phase 15 (e): the graphed streaming fit on phase 12's world-of-one
    NCCL mesh (the gradient all-reduce, the losses' and k-means'
    collectives captured), f32, both routes, bit for bit the graphed run
    without a mesh of (a); its collectives a step."""
    from nafae_torch.parallel import sharding as S

    out = {}
    for route in ROUTES:
        cfg = graph_cfg(root, os.path.join(tmp, f"ck_gmesh_{route}"),
                        "float32", route, 1, False)
        S.COLLECTIVES.reset()
        zero_counts()                           # main path starts here
        run = traced_fit(torch, cfg, mesh=mesh)
        counts = read_counts()                  # ... and ends here
        st = expect_graphed(run, f"graphed fit on the NCCL mesh ({route})",
                            2, GRAPH_STEPS)
        recs = list(S.COLLECTIVES.records)
        bad = state_diffs(torch, run["state"], base[route]["state"])
        if len(run["logs"]) != GRAPH_STEPS or not all(
                metrics_equal(a, b) for a, b in zip(run["logs"],
                                                    base[route]["logs"])):
            bad.append("rows")
        want = {k: n * GRAPH_STEPS for k, n in per_step_launches(route).items()}
        if counts != want or bad or not recs:
            fail(f"graphed fit on the NCCL mesh ({route}): launches {counts}, "
                 f"{len(recs)} collectives; differs from the graphed run "
                 f"without a mesh in {bad}")
        out[route] = {**st, "collectives": len(recs),
                      "collective_bytes": sum(r[3] for r in recs)}
    log("phase 15 (e): graphed fit on a world-of-one NCCL mesh, collectives "
        "captured: both routes bit for bit the graphed runs without a mesh "
        "(rows, params, centers, optimizer state); collectives in "
        f"{GRAPH_STEPS} steps: " + ", ".join(
            f"{r} {o['collectives']} ({o['collective_bytes']} B)"
            for r, o in out.items()))
    return out


def check_graph_resume(torch, root: str, tmp: str) -> dict:
    """Phase 15 (f): the f32 auto streaming fit stopped at step
    GRAPH_RESUME_AT and resumed from its checkpoint to GRAPH_STEPS (the
    resumed run captures on the restored state): its rows and final state
    bit for bit the uninterrupted graphed run. Warm-up spans the first
    GRAPH_RESUME_AT + 1 steps, so the run stopped early takes the
    learning rates of the whole run (the cosine decay follows
    train.steps)."""
    warm = [f"train.warmup_steps={GRAPH_RESUME_AT + 1}"]
    whole = traced_fit(torch, graph_cfg(
        root, os.path.join(tmp, "ck_gwhole"), "float32", "auto", 1, False,
        warm))
    ck = os.path.join(tmp, "ck_gresume")
    first = traced_fit(torch, graph_cfg(
        root, ck, "float32", "auto", 1, False,
        [*warm, f"train.steps={GRAPH_RESUME_AT}"]))
    second = traced_fit(torch, graph_cfg(root, ck, "float32", "auto", 1,
                                         False, warm))
    st = expect_graphed(second, "resumed graphed fit", 2,
                        GRAPH_STEPS - GRAPH_RESUME_AT)
    rows = first["logs"] + second["logs"]
    bad = state_diffs(torch, second["state"], whole["state"])
    if [m["step"] for m in rows] != list(range(1, GRAPH_STEPS + 1)) or not \
            all(metrics_equal(a, b) for a, b in zip(rows, whole["logs"])):
        bad.append("rows")
    if bad:
        fail(f"the resumed graphed fit differs from the uninterrupted one "
             f"in {bad}")
    log(f"phase 15 (f): graphed fit stopped at step {GRAPH_RESUME_AT} and "
        f"resumed to {GRAPH_STEPS} (captured on the restored state: "
        f"{st['graphs']} graphs, {st['replays']} replays): rows and state "
        "bit for bit the uninterrupted graphed run")
    return st


def graph_timings(torch, root: str, tmp: str) -> dict:
    """Phase 15 (g): the f32 auto config4 step host to host (metrics on the
    host), graphed (`build_train_fn`) against eager (`train_step`), cached
    (the index batch; the eager way gathers it) and on prepacked
    streaming batches (the numpy batch copied in), TIMED_ROUNDS rounds
    from step 3, each graphed, eager, eager, graphed; the device
    busy time of a step of each (torch.profiler) and the idle share; then
    `fit` from the cache, a row a step, graphed against eager
    (`eager_reason` made to name a reason), in two rounds."""
    import nafae_torch.train as TT
    from nafae_torch.config import load_config
    from nafae_torch.data.loader import BatchLoader
    from nafae_torch.data.youcook2 import SegmentDataset

    dev = torch.device("cuda")
    ds = SegmentDataset(root, "train", 20, 20, 2048, 8)
    batches = [b for _, b in BatchLoader(ds, 16, seed=0).steps(4)]
    cache = TT.build_cache(ds, dev)
    idxs = [torch.from_numpy(b["segment_id"].astype(np.int64)).to(dev)
            for b in batches]
    cfg = cache_cfg(root, os.path.join(tmp, "ck_gtime"), "auto",
                    ["train.steps=1000"])
    tx = TT.make_optimizer(cfg)
    progs = {"cached": TT.build_train_fn(cfg, tx, dev, cache=cache),
             "streaming": TT.build_train_fn(cfg, tx, dev)}
    states = {(w, g): TT.TrainState.create(cfg, device=dev)
              for w in progs for g in ("graphed", "eager")}

    def run(way, kind, i):
        st = states[way, kind]
        if kind == "graphed":
            arg = idxs[i % 4] if way == "cached" else batches[i % 4]
            states[way, kind], m = progs[way](st, arg)
        else:
            b = ({k: v.index_select(0, idxs[i % 4]) for k, v in cache.items()}
                 if way == "cached" else TT.batch_to_device(batches[i % 4],
                                                            dev))
            states[way, kind], m = TT.train_step(st, b, cfg, tx)
        return m

    kinds = ("graphed", "eager", "eager", "graphed")
    for i in range(3):
        for way in progs:
            for kind in ("graphed", "eager"):
                run(way, kind, i)
    torch.cuda.synchronize()
    host = {(w, k): [] for w in progs for k in ("graphed", "eager")}
    for i in range(TIMED_ROUNDS):
        for way in progs:
            for kind in kinds:
                t0 = time.perf_counter()
                float(run(way, kind, i)["loss"])    # metrics on the host
                host[way, kind].append((time.perf_counter() - t0) * 1e3)
    res = {}
    for way in progs:
        for kind in ("graphed", "eager"):
            top, busy, ops = profile_forward(
                torch, lambda: run(way, kind, 0))
            ms = statistics.median(host[way, kind])
            res[f"{way}_{kind}"] = {
                "host_ms": ms, "host_ms_all": host[way, kind],
                "device_busy_ms": busy, "device_ops": ops,
                "idle_share": 1 - busy / ms, "kernels": top}
        res[f"{way}_program"] = dict(progs[way].stats)
    del progs, states, cache
    torch.cuda.empty_cache()

    # fit from the cache, a row a step: graphed and eager, two rounds
    real, ms = TT.eager_reason, {"graphed": [], "eager": []}
    for i, kind in enumerate(("graphed", "eager", "eager", "graphed")):
        cfg = load_config(preset_name="config4", overrides=TRAIN_OVERRIDES + [
            f"data.root={root}",
            f"train.ckpt_dir={os.path.join(tmp, f'ck_gfit_{kind}_{i}')}",
            "model.dtype=float32", "train.kernels=auto",
            f"train.steps={FIT_TIMED_STEPS}", "train.device_cache=true"])
        if kind == "eager":
            TT.eager_reason = lambda *a, **kw: "timed eagerly"
        try:
            logs = traced_fit(torch, cfg)["logs"]
        finally:
            TT.eager_reason = real
        frames = cfg.data.batch_size * cfg.data.max_frames
        ms[kind] += [frames * 1e3 / m["frames_per_sec"] for m in logs
                     if m["step"] > 3]
    res["fit_cached"] = {k: {"ms": statistics.median(v), "ms_all": v}
                         for k, v in ms.items()}
    card = card_line()
    for way in ("cached", "streaming"):
        g, e = res[f"{way}_graphed"], res[f"{way}_eager"]
        log(f"phase 15 (g): config4 f32 auto step host to host, {way}: "
            f"graphed {g['host_ms']:.4f} ms (device busy "
            f"{g['device_busy_ms']:.4f} ms in {g['device_ops']:.0f} "
            f"operations, idle {100 * g['idle_share']:.1f}%), eager "
            f"{e['host_ms']:.4f} ms (busy {e['device_busy_ms']:.4f} ms in "
            f"{e['device_ops']:.0f}, idle {100 * e['idle_share']:.1f}%), "
            f"medians of {len(g['host_ms_all'])} / {len(e['host_ms_all'])} "
            f"interleaved; program {res[way + '_program']} — {card}")
        log(f"device time per graphed {way} step by kernel: " + "; ".join(
            f"{us:.1f} us {k}" for k, us in g["kernels"]))
    log(f"phase 15 (g): fit from the cache, a row a step (medians from step "
        f"4 of two rounds of {FIT_TIMED_STEPS}): graphed "
        f"{res['fit_cached']['graphed']['ms']:.4f} ms, eager "
        f"{res['fit_cached']['eager']['ms']:.4f} ms — {card}")
    return res


# ------------- serving, eval, extraction and the config-5 step as graphs
# (phase 16)

GRAPH_SERVERS = (("float32", ""), ("bfloat16", ""), ("float32", "int8"),
                 ("float32", "int8pre"))      # (model.dtype, model.quantize)
GRAPH_SERVE_TIMED = ("float32", "int8pre")
GRAPH_C5_STEPS = 3               # steps of each phase-16 config-5 fit
GRAPH_C5_RUNS = ("float32", "pallas_roi", "bfloat16")
GRAPH_C5_TRACED = "pallas_roi"   # its replay traced: K2, K5, K1fr, K1br
GRAPH_C5_ROUNDS = 3              # timed rounds of the config-5 step
GRAPH_EVAL_ROUNDS = 6            # interleaved rounds of the eval timing
EXTRACT_CHUNK = 8                # extract_segments' frame_batch


def padded_batches(srv, segs) -> list[dict]:
    """`segs` as the server runs them: padded segments in full batches of
    batch_size (the last one padded with zero rows), numpy."""
    samples = [srv._pad_segment(s) for s in segs]
    bs, out = srv.batch_size, []
    for lo in range(0, len(samples), bs):
        chunk = samples[lo:lo + bs]
        out.append({k: np.concatenate(
            [np.stack([s[k] for s in chunk]),
             np.zeros((bs - len(chunk),) + chunk[0][k].shape,
                      chunk[0][k].dtype)]) for k in chunk[0]})
    return out


def eager_batch(torch, srv, batch) -> dict:
    """A server's batch run op by op, as `run_batch` ran it before its
    graph: the batch copied to the card, `make_ground_fn`'s forward
    (`srv._fn`) called eagerly, the outputs read back (numpy)."""
    t = {k: torch.from_numpy(v).to(srv.device, non_blocking=True)
         for k, v in batch.items()}
    with torch.inference_mode():
        out = srv._fn(srv.params, *(t[k] for k in ARG_KEYS),
                      t.get("feats_scale"))
    return {k: v.cpu().numpy() for k, v in out.items()}


def check_serve_batches(torch, srv, segs, name: str) -> list[dict]:
    """Each batch of `segs` (padded_batches) through srv's serving graph
    (`run_batch`), bit for bit `make_ground_fn` called eagerly on the
    same batch (eager_batch), K1f once a batch and no other kernel;
    returns the batches."""
    batches = padded_batches(srv, segs)
    for i, b in enumerate(batches):
        zero_counts()                           # a batch starts here
        got = srv.run_batch(b)
        counts = read_counts()                  # ... and ends here
        want = eager_batch(torch, srv, b)
        if {k: n for k, n in counts.items() if n} != {"ctx_mix_fwd": 1}:
            fail(f"the {name} serving graph launched {counts} for batch "
                 f"{i}; K1f once expected")
        bad = [k for k in want if not np.array_equal(got[k], want[k])]
        if set(got) != set(want) or bad:
            fail(f"the {name} serving graph differs from make_ground_fn "
                 f"called eagerly in {bad} (batch {i})")
    return batches


def check_serve_graphs(torch, params, segs) -> dict:
    """Phase 16 (a): the serving graph of config4 servers in f32, bf16,
    int8 and int8pre (oracle params, the serving phase's requests): each
    batch's answer bit for bit `make_ground_fn` called eagerly on the same
    batch, K1f once a batch (a replay), one graph a server; then the f32
    and int8pre batch host to host, graphed (`run_batch`) against eager
    (`eager_batch`), AB_ROUNDS interleaved rounds, with the batch's copy
    to the card timed apart."""
    from nafae_torch.serve import GroundingServer

    dev = torch.device("cuda")
    out, srvs = {}, {}
    for dt, q in GRAPH_SERVERS:
        name = q or dt
        srv = srvs[name] = GroundingServer(serve_cfg(dt, q), params,
                                           device="cuda")
        batches = check_serve_batches(torch, srv, segs, name)
        st = dict(srv._program.stats)
        if st["graphs"] != 1 or st["replays"] != len(batches):
            fail(f"the {name} server's program ran {st}")
        out[name] = {"batches": len(batches), "program": st}
    for name in GRAPH_SERVE_TIMED:
        srv = srvs[name]
        b = padded_batches(srv, segs[:srv.batch_size])[0]
        ms = {"graphed": [], "eager": [], "h2d": []}
        for i in range(AB_ROUNDS + 2):
            for way in (("graphed", "eager", "eager", "graphed") if i % 2
                        else ("eager", "graphed", "graphed", "eager")):
                t0 = time.perf_counter()
                (srv.run_batch(b) if way == "graphed"
                 else eager_batch(torch, srv, b))
                if i >= 2:
                    ms[way].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            _ = {k: torch.from_numpy(v).to(dev, non_blocking=True)
                 for k, v in b.items()}
            torch.cuda.synchronize()
            if i >= 2:
                ms["h2d"].append((time.perf_counter() - t0) * 1e3)
        out[name].update({f"{k}_ms": statistics.median(v)
                          for k, v in ms.items()})
        out[name]["batch_bytes"] = int(sum(v.nbytes for v in b.values()))
    card = card_line()
    log("phase 16 (a): serving graphs (f32, bf16, int8, int8pre): every "
        "batch bit for bit make_ground_fn called eagerly, K1f once a "
        "batch, one graph a server (" + ", ".join(
            f"{n} {o['program']['replays']} replays, capture "
            f"{o['program']['capture_s']:.3f} s, pool "
            f"{o['program']['pool_bytes']} B" for n, o in out.items())
        + ")")
    for name in GRAPH_SERVE_TIMED:
        o = out[name]
        log(f"phase 16 (a): serving batch ({name} server, B=16, "
            f"{o['batch_bytes']} bytes) host to host: graphed "
            f"{o['graphed_ms']:.4f} ms, eager {o['eager_ms']:.4f} ms "
            f"(medians of {2 * AB_ROUNDS} interleaved); the batch's copy to "
            f"the card alone {o['h2d_ms']:.4f} ms — {card}")
    return out


def eager_evaluate(torch, params, ds, batch_size: int) -> int:
    """Eval's hits over `ds` with eval_batch called op by op on the card,
    the batches padded to batch_size as `evaluate` pads them."""
    from nafae_torch.data.loader import BatchLoader
    from nafae_torch.evaluate import _pad_rows, eval_batch
    from nafae_torch.train import batch_to_device

    dev = torch.device("cuda")
    params = {k: torch.as_tensor(v).to(dev) for k, v in params.items()}
    hits = 0
    for batch in BatchLoader(ds, batch_size, shuffle=False,
                             drop_remainder=False):
        b = batch_to_device({k: _pad_rows(v, batch_size)
                             for k, v in batch.items()}, dev)
        correct, gt_mask = eval_batch(params, b)
        hits += int(round(float((correct * gt_mask).sum().cpu())))
    return hits


def check_eval_graphs(torch, root: str) -> dict:
    """Phase 16 (b): config1's eval of the serving phase's val split: with
    the oracle params, then with w_v drawn at random (a second
    `evaluate`, the program kept from the first), the graph's hits equal
    those of eval_batch called eagerly on the card, and the two calls'
    hits differ (the second scores its own params); eval wall seconds
    graphed (`evaluate`) against eager (`eager_evaluate`), interleaved."""
    from nafae_torch.data.youcook2 import SegmentDataset
    from nafae_torch.evaluate import _PROGRAMS, evaluate

    cfg = eval_cfg(root, "unused")
    ds = SegmentDataset(root, "val", cfg.data.max_frames,
                        cfg.data.num_regions, cfg.data.feat_dim,
                        cfg.data.max_words, with_gt=True)
    bs = cfg.data.batch_size
    oracle = oracle_params()
    rng = np.random.default_rng(SEED)
    d = oracle["w_v"].shape[0]
    changed = {**oracle, "w_v": (rng.standard_normal(oracle["w_v"].shape)
                                 / np.sqrt(d)).astype(np.float32)}
    res = {}
    for name, p in (("oracle", oracle), ("changed", changed)):
        got = evaluate(p, ds, bs, cfg.model.vocab_size, device="cuda")
        hits = int(round(got["box_acc_micro"] * got["num_annotations"]))
        want = eager_evaluate(torch, p, ds, bs)
        if hits != want:
            fail(f"eval graph ({name} params): {hits} hits, the eager body "
                 f"{want}")
        res[name] = {"hits": hits, "num_annotations": got["num_annotations"]}
    if res["oracle"]["hits"] == res["changed"]["hits"]:
        fail(f"the second evaluate scored as the first: {res}")
    programs = [dict(p.stats) for p in _PROGRAMS.values()
                if p.device.type == "cuda"]
    wall = {"graphed": [], "eager": []}
    for i in range(GRAPH_EVAL_ROUNDS):
        for way in (("graphed", "eager") if i % 2 else ("eager", "graphed")):
            t0 = time.perf_counter()
            if way == "graphed":
                evaluate(oracle, ds, bs, cfg.model.vocab_size, device="cuda")
            else:
                eager_evaluate(torch, oracle, ds, bs)
            wall[way].append(time.perf_counter() - t0)
    res.update({f"{k}_s": statistics.median(v) for k, v in wall.items()})
    res["programs"] = programs
    log(f"phase 16 (b): eval graph (config1, {len(ds)} segments, "
        f"{res['oracle']['num_annotations']} annotations): hits "
        f"{res['oracle']['hits']} (oracle) and {res['changed']['hits']} "
        f"(a random w_v, a second evaluate) equal to eval_batch run "
        f"eagerly; programs {programs}; wall graphed {res['graphed_s']:.4f} "
        f"s, eager {res['eager_s']:.4f} s (medians of "
        f"{GRAPH_EVAL_ROUNDS} interleaved) — {card_line()}")
    return res


def check_extract_graph(torch, cfg, frames) -> dict:
    """Phase 16 (c): make_extract_fn's graph of cfg's detector over an
    EXTRACT_CHUNK-frame chunk of `frames` (numpy [N,S,S,3]) and another:
    its outputs bit for bit the detector's eager outputs on the same
    chunk, K2 once a replay (and K5 with roi_impl=pallas); an extract
    chunk host to host (numpy in, numpy out), graphed against eager, in
    interleaved rounds."""
    from nafae_torch.extract import make_extract_fn

    dev = torch.device("cuda")
    det = c5_detector(torch, cfg)
    fn, _ = make_extract_fn(cfg, model=det)

    def eager(chunk):
        out = det(torch.from_numpy(chunk).to(dev))
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    want_counts = {k: n for k, n in c5_launches(cfg).items()
                   if k in ("nms", "roi_align") and n}
    chunks = [np.ascontiguousarray(frames[i:i + EXTRACT_CHUNK])
              for i in (0, EXTRACT_CHUNK)]
    for i, chunk in enumerate(chunks):
        zero_counts()                           # a chunk starts here
        got = fn(chunk)
        counts = {k: n for k, n in read_counts().items() if n}
        want = eager(chunk)                     # ... and ended before this
        if counts != want_counts:
            fail(f"the extract graph launched {counts}; {want_counts} "
                 "expected")
        bad = [k for k in want if not np.array_equal(got[k], want[k])]
        if set(got) != set(want) or bad:
            fail(f"the extract graph differs from the detector's eager "
                 f"outputs in {bad} (chunk {i})")
    ms = {"graphed": [], "eager": []}
    for i in range(AB_ROUNDS):
        for way in (("graphed", "eager") if i % 2 else ("eager", "graphed")):
            t0 = time.perf_counter()
            fn(chunks[0]) if way == "graphed" else eager(chunks[0])
            ms[way].append((time.perf_counter() - t0) * 1e3)
    res = {f"{k}_ms": statistics.median(v) for k, v in ms.items()}
    res["program"] = dict(fn.program.stats)
    log(f"phase 16 (c): extract graph ({cfg.detector.backbone} "
        f"{cfg.detector.dtype}, {EXTRACT_CHUNK} frames of "
        f"{cfg.detector.image_size}x{cfg.detector.image_size}): outputs bit "
        f"for bit the detector's eager outputs on 2 chunks, launches "
        f"{want_counts} a chunk; a chunk host to host graphed "
        f"{res['graphed_ms']:.3f} ms, eager {res['eager_ms']:.3f} ms "
        f"(medians of {AB_ROUNDS} interleaved); program {res['program']} "
        f"— {card_line()}")
    return res


def c5_graph_timings(torch, cfg, det, batch, interleaved: bool) -> dict:
    """The config-5 step of `cfg` (a 1000-step schedule) host to host (the
    numpy batch in, the loss on the host) and on a resident batch (device
    tensors; the graphed step copies them into its static buffers),
    graphed (`build_train_fn`) against eager (`train_step`), both with the
    detector `det`, GRAPH_C5_ROUNDS rounds each: interleaved, or (f32,
    whose graph pool and eager step would not fit beside each other with
    room to spare) the graphed rounds first and the graphs freed before
    the eager ones; the device busy time of a step of each
    (torch.profiler) and its idle share."""
    from nafae_torch.train import (TrainState, batch_to_device,
                                   build_train_fn, make_optimizer,
                                   train_step)

    dev = torch.device("cuda")
    cfg = replace(cfg, train=replace(cfg.train, steps=1000))
    tb = batch_to_device(batch, dev)
    tx = make_optimizer(cfg)
    prog = build_train_fn(cfg, tx, dev, extractor=det)
    states = {w: TrainState.create(cfg, device=dev)
              for w in ("graphed", "eager")}
    ways = ("graphed", "eager")
    res = {w: {"host": [], "resident": []} for w in ways}

    def step(way, kind):
        if way == "graphed":
            b = batch if kind == "host" else tb
            states[way], m = prog(states[way], b)
        else:
            b = tb if kind == "resident" else batch_to_device(batch, dev)
            states[way], m = train_step(states[way], b, cfg, tx, det)
        return m

    def timed(way):
        for kind in ("host", "resident"):
            t0 = time.perf_counter()
            float(step(way, kind)["loss"])
            res[way][kind].append((time.perf_counter() - t0) * 1e3)

    def profiled(way):
        _, res[way]["busy_ms"], res[way]["ops"] = profile_forward(
            torch, lambda: step(way, "resident"), reps=2)

    if interleaved:
        for way in ways:
            step(way, "resident")
        for i in range(GRAPH_C5_ROUNDS):
            for way in (ways if i % 2 else ways[::-1]):
                timed(way)
        for way in ways:
            profiled(way)
    else:
        for way in ways:
            step(way, "resident")
            for _ in range(GRAPH_C5_ROUNDS):
                timed(way)
            profiled(way)
            if way == "graphed":
                prog._graphs.clear()
                torch.cuda.empty_cache()
    out = {"interleaved": interleaved, "program": dict(prog.stats)}
    for way, r in res.items():
        host = statistics.median(r["host"])
        out[way] = {"host_ms": host,
                    "resident_ms": statistics.median(r["resident"]),
                    "busy_ms": r["busy_ms"], "device_ops": r["ops"],
                    "idle_share": 1 - r["busy_ms"] / host}
    return out


def state_copy(torch, state):
    """A TrainState of clones of `state`'s tensors."""
    return replace(
        state, params={k: v.clone() for k, v in state.params.items()},
        opt_state={k: ({n: t.clone() for n, t in v.items()}
                       if isinstance(v, dict) else v)
                   for k, v in state.opt_state.items()},
        centers=state.centers.clone(),
        bank=None if state.bank is None else state.bank.clone(),
        bank_valid=(None if state.bank_valid is None
                    else state.bank_valid.clone()))


def check_c5_graphs(torch, ann: str, tmp: str) -> dict:
    """Phase 16 (d, e): config-5 `fit` (GRAPH_C5_STEPS steps) of each run
    of GRAPH_C5_RUNS (the ResNet-50 f32 preset, roi_impl=pallas, the bf16
    detector) at full width: captured (two graphs, a replay a step),
    launches c5_launches x steps, the warm-up steps' launches apart, and
    rows, params, centers and optimizer state bit for bit `train_step` run
    eagerly with the same detector over the same batches (run after the
    graphs are freed); peak device memory and the pool's bytes. (e) one
    more step of the GRAPH_C5_TRACED run, traced, names K2, K5, K1fr and
    K1br as often as c5_launches counts them. The f32 and bf16 steps
    graphed against eager (c5_graph_timings); then (c) on the first
    batch's frames."""
    from nafae_torch.train import WARMUP_STEPS

    out, first = {}, None
    for run in GRAPH_C5_RUNS:
        cfg = c5_cfg(ann, os.path.join(tmp, f"ck5_g_{run}"), run,
                     GRAPH_C5_STEPS)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()                           # main path starts here
        fitted = traced_fit(torch, cfg)
        counts = read_counts()                  # ... and ends here
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        peak_reserved = torch.cuda.max_memory_reserved() / 2 ** 30
        per = c5_launches(cfg)
        want = {k: n * GRAPH_C5_STEPS for k, n in per.items()}
        if counts != want:
            fail(f"graphed config-5 fit ({run}) launched {counts}, expected "
                 f"{want}")
        st = expect_graphed(fitted, f"graphed config-5 fit ({run})", 2,
                            GRAPH_C5_STEPS)
        warm = {k: n * 2 * WARMUP_STEPS for k, n in per.items() if n}
        if st["warmup_launches"] != warm:
            fail(f"graphed config-5 fit ({run}): its warm-up steps launched "
                 f"{st['warmup_launches']}, expected {warm}")
        prog, seen, state = (fitted["programs"][0], fitted["seen"],
                             fitted["state"])
        final = state_copy(torch, state)        # the replay below moves it
        entry = {**st, "launches": counts, "peak_gib": peak,
                 "peak_reserved_gib": peak_reserved,
                 "wall_s": fitted["wall_s"]}
        if run == GRAPH_C5_TRACED:
            entry["traced_replay"] = traced_replay(
                torch, prog, lambda: prog(state, seen[-1]), per,
                os.path.join(tmp, f"replay_c5_{run}.json"))
        if first is None:
            first = seen[0]["frames"].reshape(
                (-1,) + seen[0]["frames"].shape[2:])
        logs = fitted["logs"]
        del fitted, prog, state                 # the graphs and their pool
        torch.cuda.empty_cache()
        det = c5_detector(torch, cfg)
        eager = eager_chain(torch, cfg, seen, extractor=det)
        bad = rows_differ(logs, eager["rows"])
        bad += state_diffs(torch, final, eager["state"])
        if bad:
            fail(f"graphed config-5 fit ({run}) differs from the eager "
                 f"train_step chain in {bad}")
        del eager, final
        torch.cuda.empty_cache()
        if run in ("float32", "bfloat16"):
            entry["times"] = c5_graph_timings(
                torch, cfg, det, seen[0], interleaved=run == "bfloat16")
        del det, seen
        torch.cuda.empty_cache()
        out[run] = entry
        log(f"phase 16 (d): graphed config-5 fit ({run}, "
            f"{GRAPH_C5_STEPS} steps): rows, params, centers and optimizer "
            f"state bit for bit the eager train_step chain; launches "
            f"{counts}; {st['graphs']} graphs, {st['replays']} replays, "
            f"{st['warmup_steps']} warm-up steps launching "
            f"{st['warmup_launches']} (apart); capture {st['capture_s']:.2f} "
            f"s; the pool {st['pool_bytes']} B; peak device memory "
            f"{peak:.2f} GiB allocated, {peak_reserved:.2f} GiB reserved")
    log(f"phase 16 (e): a replayed {GRAPH_C5_TRACED} config-5 step traced "
        f"names {out[GRAPH_C5_TRACED]['traced_replay']}, as counted")
    card = card_line()
    for run in ("float32", "bfloat16"):
        t = out[run]["times"]
        g, e = t["graphed"], t["eager"]
        log(f"phase 16 (d): config-5 step ({run}, B=16 T=20 640x640; "
            + ("interleaved" if t["interleaved"] else
               "graphed rounds, then eager") + f"): host to host graphed "
            f"{g['host_ms']:.2f} ms, eager {e['host_ms']:.2f} ms; on a "
            f"resident batch graphed {g['resident_ms']:.2f} ms, eager "
            f"{e['resident_ms']:.2f} ms; device busy graphed "
            f"{g['busy_ms']:.2f} ms in {g['device_ops']:.0f} operations "
            f"(idle {100 * g['idle_share']:.1f}% of host to host), eager "
            f"{e['busy_ms']:.2f} ms in {e['device_ops']:.0f} (idle "
            f"{100 * e['idle_share']:.1f}%); the pool "
            f"{out[run]['pool_bytes']} B, peak in fit "
            f"{out[run]['peak_gib']:.2f} GiB allocated, "
            f"{out[run]['peak_reserved_gib']:.2f} GiB reserved — {card}")
    out["extract"] = check_extract_graph(
        torch, c5_cfg(ann, os.path.join(tmp, "ck5_gx"), "float32", 1), first)
    return out


# ------------------------------------------ phase 17: every shape


# the context mix's cases past the specialised kernels' envelope (R > 32, E
# above 512 or not a multiple of 4, w > 16), which the general variant of
# csrc/ctx_mix*.cu takes (its staged kernels up to R = 64, R padded to 16,
# and past it the wide kernels): (B, T, R, E, w, region mask, edges)
CTX_ANY_CASES = [(4, 6, 33, 64, 2, True, False),     # R = 33: two row tiles
                 (4, 6, 36, 1024, 3, True, False),   # R = 36, E = 1024
                 (2, 6, 36, 1024, 3, False, False),  # ... no region mask
                 (4, 6, 20, 50, 3, True, False),     # E = 50 (GloVe-50d)
                 (3, 5, 20, 516, 2, True, False),    # E = 516 > 512
                 (2, 5, 3, 3, 2, True, False),       # E = 3, R = 3
                 (2, 4, 20, 64, 17, True, False),    # w = 17 >= T
                 (2, 3, 5, 50, 20, True, False),     # w = 20 >= T
                 (3, 12, 36, 50, 3, True, True),     # cnt = 0; invalid centre
                 (2, 5, 49, 50, 3, True, False),     # R = 49: 16 x 3 + 1
                 (2, 5, 64, 68, 2, True, False),     # R = 64: the largest tile
                 (2, 4, 65, 50, 2, True, False)]     # R = 65: the wide kernels
# ... with real halo frames (B, T, R, E, w), w > T in the first and third
CTX_ANY_HALO_CASES = [(4, 5, 36, 1024, 6), (3, 8, 36, 50, 3),
                      (3, 4, 33, 50, 17)]
# K3's cases past the bf16 kernel's envelope (E not a multiple of 4, or
# above 512), as CROSS_CASES: the general variant takes them in bf16, the
# f32 kernel in f32
CROSS_ANY_CASES = [
    (16, 128, 20, 36, 1024, True, (), False),     # phase 17's R = 36, E = 1024
    (2, 40, 5, 36, 1024, False, (), False),       # ... no region mask
    (16, 128, 20, 20, 50, True, (), False),       # E = 50 (GloVe-50d)
    (4, 40, 6, 20, 3, True, (), True),            # E = 3
    (4, 40, 6, 7, 6, True, (), False),            # E = 6
    (3, 40, 5, 20, 516, True, (), False),         # E = 516 > 512
    (2, 40, 5, 20, 520, True, (), False),         # bf16 rows of 8, not 16
    (2, 33, 3, 81, 50, True, ((0, 80),), False),  # one past a chunk of 80
    (3, 40, 5, 40, 50, True, ((3, 35), (8, 39)), True),   # r + 32, last row
]
# K4f/K4b's cases past their envelope (K > 32, E not a multiple of 4, E >
# 512), which the general variants take, as DIAG_CASES: K, R and Kc also at
# and one past both kernels' words a pass (64), regions a tile (64) and
# K4f's centers a pass (128), an exact tie across the tiles and across the
# passes; for K4b's general variant also E past its 64-column stages and
# 256-column dv blocks (E = 257, 258, 300, 320), its dv ring's depth (K =
# 16 / 17), rows past its dw blocks' 256-row lists (T R = 260, 1040), its
# dw clusters of 1, 2, 4 and 8 parts of a video's rows (B ceil(E / 64) of
# 64 and more, 32, 16, and fewer, down to parts without rows), and, with an
# 11th entry True, every second frame without context (its dw blocks skip
# those rows)
DIAG_ANY_CASES = [
    (16, 8, 20, 36, 1024, 67, True, (), (), False),   # R = 36, E = 1024
    (4, 33, 5, 20, 256, 67, True, (), (), False),     # K = 33
    (4, 40, 5, 20, 256, 67, True, (), (), False),     # K = 40
    (2, 40, 4, 20, 1024, 67, True, (), (), False),    # K = 40 at E = 1024
    (16, 8, 20, 20, 50, 67, True, (), (), False),     # E = 50 (GloVe-50d)
    (4, 8, 9, 20, 3, 67, True, (), (), False),        # E = 3
    (3, 8, 5, 20, 516, 67, True, (), (), False),      # E = 516 > 512
    (3, 8, 5, 20, 1024, 67, False, (), (), False),    # no region mask
    (4, 8, 9, 20, 50, 130, True, (), (), False),      # Kc = 130 at E = 50
    (4, 8, 9, 40, 50, 67, True, ((3, 35),), ((3, 35),), True),   # across 32
    (2, 64, 4, 20, 50, 67, True, (), (), False),      # K = 64: one pass
    (2, 65, 4, 20, 50, 67, True, (), (), False),      # K = 65: two passes
    (2, 8, 5, 64, 50, 67, True, ((3, 63),), (), False),   # R = 64: one tile
    (2, 8, 5, 65, 50, 67, True, ((3, 64),), (), False),   # R = 65: two tiles
    (3, 8, 5, 20, 50, 129, True, (), ((5, 128),), False),  # Kc = 129
    (2, 16, 4, 20, 50, 67, True, (), (), False),      # K = 16: 3 dv stages
    (2, 17, 4, 20, 50, 67, True, (), (), False),      # K = 17: 2 stages
    (2, 40, 13, 20, 256, 67, True, (), (), False),    # K = 40, T R = 260
    (2, 8, 26, 40, 50, 67, True, (), (), False),      # T R = 1040
    (3, 8, 5, 20, 258, 67, True, (), (), False),      # E = 258: 256 + 2
    (2, 8, 4, 20, 257, 67, True, (), (), False),      # E = 257 (odd)
    (2, 33, 4, 20, 320, 67, True, (), (), False),     # E = 320: 256 + 64
    (2, 65, 3, 20, 300, 67, True, (), (), False),     # K = 65 at E = 300
    (1, 65, 3, 65, 50, 67, True, ((3, 64),), (), False),   # K, R = 65
    (4, 8, 10, 36, 1024, 67, True, (), (), False, True),   # half off
    (2, 16, 4, 20, 1024, 67, True, (), (), False),    # 2 parts of dw rows
    (1, 8, 3, 3, 50, 67, True, (), (), False),        # 8 parts of 9 rows
]
ANY_STEPS = 3                    # steps of each phase-17 fit
# one step's gradients, card against CPU, at phase 17's shapes: rtol as
# CPU_GRAD_TOL's, and atol 1e-5 of each leaf's largest entry where
# CPU_GRAD_TOL has 1e-6: at E = 1024 w_v's gradient sums 11,520 rows in
# another order on each device, and its entries near zero differ by 1.37e-6
# of the largest (seen on the card). The card's gradients rounded to bf16,
# and those of a step with TF32 products, must fall outside it
# (any_grads_agree).
ANY_GRAD_TOL = (CPU_GRAD_TOL[0], 1e-5)
# phase 17's servers' box accuracy: the planted signal among 36 regions and
# an oracle that keeps 50 of the 67 class directions at E = 50 score below
# ACC_BAR (0.78 and 0.63 on the card and the CPU alike); chance is 1/R
ANY_ACC_BAR = 0.5
# phase 17's servers: (model.dtype, model.quantize, overrides, oracle E,
# requests at R = 36 or the config4 ones)
ANY_SERVERS = (("float32", "", ["data.num_regions=36", "model.embed_dim=1024"],
                1024, True),
               ("bfloat16", "", ["data.num_regions=36",
                                 "model.embed_dim=1024"], 1024, True),
               ("float32", "int8pre", ["model.embed_dim=50"], 50, False))
# phase 17's fits: name -> (overrides, training split (check_any's roots),
# E, whether the context mix takes its general variant, routes). K = 40:
# config4's widths with words past 32 (data.max_words=40); every fit here
# is past K4f and K4b's envelope
ANY_FITS = {"R36_E1024_w3": (["data.num_regions=36", "model.embed_dim=1024",
                              "loss.ctx_window=3"], "r36", 1024, True,
                             ROUTES),
            "E50_w20": (["model.embed_dim=50", "loss.ctx_window=20"], "c4",
                        50, True, ROUTES),
            "K40": (["data.max_words=40"], "k40", 256, False, ("pallas",))}
# the kernels' times at the new shapes: name -> (B, T, R, E, w)
ANY_TIMED = {"R36_E1024_w3": (16, 20, 36, 1024, 3),
             "E50_w20": (16, 20, 20, 50, 20)}


def check_fused_any(torch, device) -> dict:
    """Phase 17 (g): K3 at CROSS_ANY_CASES and K4f, K4b at DIAG_ANY_CASES
    against their plain versions in f32 and bf16 (check_cross_mil,
    check_diag: every launch twice, equal bit for bit)."""
    return {"cross_mil": check_cross_mil(torch, device, CROSS_ANY_CASES,
                                         SEED + 19),
            "diag": check_diag(torch, device, DIAG_ANY_CASES, SEED + 20)}


def check_ctx_any(torch, device) -> dict:
    """Phase 17 (a): K1f, K1fr, K1b and K1br against their plain versions
    at CTX_ANY_CASES and CTX_ANY_HALO_CASES in f32 and bf16 (the general
    variant), and two launches of each bitwise equal at R = 36, E = 1024."""
    gen = torch.Generator().manual_seed(SEED + 17)
    errs = {"ctx_mix_fwd": check_ctx_mix(torch, device, CTX_ANY_CASES,
                                         CTX_ANY_HALO_CASES, SEED + 17)}
    errs["grads"] = check_grad_cases(
        torch, device, gen, [c + (False,) for c in CTX_ANY_CASES]
        + [c + (True, False, True) for c in CTX_ANY_HALO_CASES])
    check_repeatable(torch, device, gen, 4, 6, 36, 1024, 3)
    return errs


def check_any_serving(torch, reqs: dict, tmp: str) -> dict:
    """Phase 17 (b): the config4 servers of ANY_SERVERS on the oracle
    params at their E: every batch of their requests (reqs[True]: the R = 36
    split's, reqs[False]: the config4 ones) through the serving graph
    (check_serve_batches); one more batch, a replay traced (traced_replay,
    its trace written to tmp), runs the general variant's K1f kernels once
    each; ground_segments as a user calls it, K1f once a batch, box
    accuracy over ANY_ACC_BAR; one batch re-run on the CPU
    (check_batch_cpu_rerun)."""
    from nafae_torch.config import load_config
    from nafae_torch.serve import GroundingServer

    out = {}
    for dt, q, extra, embed, r36 in ANY_SERVERS:
        segs, gts = reqs[r36]
        name = f"{q or dt}_{'R36_' if r36 else ''}E{embed}"
        cfg = load_config(preset_name="config4", overrides=[
            f"model.dtype={dt}", f"model.quantize={q}", *extra])
        params = oracle_params(embed=embed)
        srv = GroundingServer(cfg, params, device="cuda")
        batches = check_serve_batches(torch, srv, segs, name)
        traced = traced_replay(
            torch, srv._program, lambda: srv.run_batch(batches[0]),
            dict(dict.fromkeys(read_counts(), 0), ctx_mix_fwd=1),
            os.path.join(tmp, f"any_serve_{name}.json"), ANY_TRACE_NAMES)
        zero_counts()                           # serving starts here
        results = srv.ground_segments(segs)
        counts = read_counts()                  # ... and ends here
        want = dict.fromkeys(counts, 0)
        want["ctx_mix_fwd"] = len(batches)
        if counts != want:
            fail(f"the {name} server launched {counts}; K1f once a batch "
                 f"({len(batches)}) expected")
        acc = box_accuracy(torch, segs, results, gts)
        if acc < ANY_ACC_BAR:
            fail(f"the {name} server's box accuracy {acc:.4f} is under "
                 f"{ANY_ACC_BAR}")
        entry = {"box_acc": acc, "batches": len(batches),
                 "launches_ctx_mix_fwd": counts["ctx_mix_fwd"],
                 "program": dict(srv._program.stats), "traced_replay": traced,
                 **check_batch_cpu_rerun(torch, cfg, params, srv, segs)}
        out[name] = entry
        log(f"phase 17 (b): {name} server ({len(segs)} segments, "
            f"{len(batches)} batches): graph bit for bit make_ground_fn "
            f"eagerly, K1f once a batch; a traced replay names {traced}; "
            f"box accuracy {acc:.4f} (bar {ANY_ACC_BAR}); CPU re-run max "
            f"|diff| {entry['cpu_max_diff']:.3e} (limit "
            f"{SERVE_CPU_TOL[dt]}), {entry['cpu_regions_moved_at_ties']} of "
            f"{entry['cpu_pairs']} regions moved at ties")
    return out


def any_grads_agree(torch, cfg, batch, kernels: str) -> dict:
    """Phase 17 (c, h): one f32 step's gradients on `batch` from the
    initial state on the `kernels` route, card against CPU, within
    ANY_GRAD_TOL; and two controls that
    must fall outside the same limit: the card's gradients rounded to
    bf16, and the card's step with TF32 products. Returns each one's
    largest |diff| / largest entry and the leaves outside the limit."""
    from nafae_torch.train import TrainState

    def card(tf32: bool) -> dict:
        st = TrainState.create(cfg, device="cuda")   # turns TF32 off
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            return step_grads(torch, cfg, st, batch, kernels)[1]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    want = step_grads(torch, cfg, TrainState.create(cfg, device="cpu"),
                      batch, kernels)[1]
    got = card(False)
    out = {}
    for tag, g in (("f32", got),
                   ("bf16_rounded", {k: v.to(torch.bfloat16).float()
                                     for k, v in got.items()}),
                   ("tf32", card(True))):
        worst, bad = grad_gap(torch, g, want, ANY_GRAD_TOL)
        out[tag] = {"rel_diff": worst, "outside": bad}
    if out["f32"]["outside"]:
        fail(f"gradients of {out['f32']['outside']}: card and CPU differ by "
             f"up to {out['f32']['rel_diff']:.3e} of the largest entry "
             f"(limit {ANY_GRAD_TOL})")
    for tag in ("bf16_rounded", "tf32"):
        if not out[tag]["outside"]:
            fail(f"the card's {tag} gradients are within {ANY_GRAD_TOL} of "
                 "the CPU's: the limit does not tell them from f32")
    return out


def check_any_fits(torch, roots: dict, tmp: str) -> dict:
    """Phase 17 (c, h): config4 `fit`, ANY_STEPS steps in f32 and bf16, at
    each shape and route of ANY_FITS (roots: its training splits): (c) the
    auto route, K1fr and K1br once a step; (h) train.kernels=pallas, also
    K3 twice and K4f, K4b once a step. Each run captured (two graphs, a
    replay a step), rows and state bit for bit the eager train_step chain;
    one more step, a replay traced (traced_replay), names the kernels of
    any_fit_names once a launch and none of the specialised kernels past
    their envelope; each run re-run on the CPU, its rows within
    CPU_METRIC_TOL, and, in f32, one step's gradients within ANY_GRAD_TOL
    (any_grads_agree)."""
    out = {}
    for name, (extra, data, e, ctx_any, routes) in ANY_FITS.items():
        root = roots[data]
        for route in routes:
            for dt in GRAPH_DTYPES:
                tag = f"{name}_{dt}" + ("_pallas" if route == "pallas" else "")
                part = "(h)" if route == "pallas" else "(c)"
                cfg = train_cfg(root, os.path.join(tmp, "ck_any_" + tag), dt,
                                ANY_STEPS, route, extra=extra)
                zero_counts()                   # main path starts here
                run = traced_fit(torch, cfg)
                counts = read_counts()          # ... and ends here
                per = per_step_launches(route)
                want = {k: n * ANY_STEPS for k, n in per.items()}
                if counts != want:
                    fail(f"phase 17 fit ({tag}) launched {counts}, expected "
                         f"{want}")
                st = expect_graphed(run, f"phase 17 fit ({tag})", 2,
                                    ANY_STEPS)
                eager = eager_chain(torch, cfg, run["seen"])
                bad = rows_differ(run["logs"], eager["rows"])
                bad += state_diffs(torch, run["state"], eager["state"])
                if bad:
                    fail(f"phase 17 fit ({tag}) differs from the eager "
                         f"train_step chain in {bad}")
                prog = run["programs"][0]
                names, absent = any_fit_names(e, ctx_any, dt)
                traced = traced_replay(
                    torch, prog, lambda: prog(run["state"], run["seen"][-1]),
                    per, os.path.join(tmp, f"any_replay_{tag}.json"), names,
                    absent)
                cpu_cfg = train_cfg(root,
                                    os.path.join(tmp, "ck_any_cpu_" + tag),
                                    dt, ANY_STEPS, route, extra=extra)
                worst = cpu_rows_agree(run["logs"],
                                       run_fit(torch, cpu_cfg, "cpu"),
                                       f"phase 17 fit ({tag})")
                grads = (any_grads_agree(torch, cpu_cfg, run["seen"][0],
                                         route)
                         if dt == "float32" else None)
                out[tag] = {**st, "launches": counts,
                            "wall_s": run["wall_s"], "traced_replay": traced,
                            "cpu_metric_rel_diff": worst, "cpu_grads": grads,
                            "loss_first_last": [run["logs"][0]["loss"],
                                                run["logs"][-1]["loss"]]}
                log(f"phase 17 {part}: fit {tag} ({ANY_STEPS} steps, "
                    f"train.kernels={route}): {st['graphs']} graphs, "
                    f"{st['replays']} replays, bit for bit the eager chain; "
                    f"launches {counts}; a traced replay names {traced} and "
                    f"none of {list(absent)}; CPU re-run rows max relative "
                    f"diff {worst:.3e} (limit {CPU_METRIC_TOL})" + (
                        "; one step's gradients max |diff| / largest entry "
                        + ", ".join(f"{k} {v['rel_diff']:.3e}"
                                    + (" (outside)" if v["outside"] else "")
                                    for k, v in grads.items())
                        + f" (limit rtol {ANY_GRAD_TOL[0]}, atol "
                        f"{ANY_GRAD_TOL[1]} x largest entry)"
                        if grads is not None else ""))
                del run, eager, prog
                torch.cuda.empty_cache()
    return out


# the general variants' kernels, as a traced replay names them: each once
# in a launch of K1f or K1fr (pairs, mix), of K1br (pairs, gather), of K3,
# of K4f (the centers kernel, then the general scores and sims kernels) and
# of K4b
ANY_TRACE_NAMES = {
    **TRACE_NAMES,
    "ctx_mix_fwd": ("ctx_mix_fwd_pairs_any", "ctx_mix_fwd_mix_any"),
    "ctx_mix_fwd_res": ("ctx_mix_fwd_pairs_any", "ctx_mix_fwd_mix_any"),
    "ctx_mix_bwd_res": ("ctx_mix_bwd_pairs_any", "ctx_mix_bwd_gather_any"),
    "cross_mil": ("cross_mil_any",),
    "diag_epilogue": ("diag_centers_kernel", "diag_scores_any",
                      "diag_sims_any"),
    "diag_epilogue_bwd": ("diag_bwd_any",)}
CTX_KEYS = ("ctx_mix_fwd", "ctx_mix_fwd_res", "ctx_mix_bwd_res")


def any_fit_names(e: int, ctx_any: bool, dt: str) -> tuple[dict, tuple]:
    """(the kernels a traced replay of a phase-17 fit at embedding width e
    names, each once a launch: ANY_TRACE_NAMES, with the context mix's
    specialised kernels where not ctx_any and K3's specialised kernel of
    dt where csrc/cross_mil.cu takes it (f32 any E; bf16 and f16 E a
    multiple of 4 up to 512: cross_mil_mma); the specialised kernels the
    replay must not name: K4f's and K4b's, and K3's of dt where its
    general variant runs)."""
    names = dict(ANY_TRACE_NAMES)
    if not ctx_any:
        names.update({k: TRACE_NAMES[k] for k in CTX_KEYS})
    spec = "cross_mil_f32" if dt == "float32" else "cross_mil_mma"
    absent = ("diag_fwd_kernel", "diag_bwd_kernel")
    if dt == "float32" or (e % 4 == 0 and e <= 512):
        names["cross_mil"] = (spec,)
        return names, absent + ("cross_mil_any",)
    return names, absent + (spec,)


def any_timings(torch) -> dict:
    """Phase 17 (d): device times (device_ms) of K1f, K1fr, K1b and K1br at
    each shape of ANY_TIMED (ctx_inputs' random masks, du from a seed) in
    f32 and bf16, each beside its plain version (torch.profiler's device
    time of context_mix_plain, its backward alone for K1b/K1br) and its
    bound, K1b/K1br also beside the empty-kernel floor of their grids; and
    K1f's SDPA yardstick (sdpa_mix) there, with its max |error| against the
    plain version and whether it is within CTX_TOL."""
    from nafae_torch.ops.kernels import ctx_mix as K

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 18)
    out = {}
    for name, (b, t, r, e, w) in ANY_TIMED.items():
        v32, fm, rm = ctx_inputs(torch, gen, b, t, r, e, w, dev)
        du = torch.randn(b, t, r, e, generator=gen).to(dev)
        res = out[name] = {"shapes": {"B": b, "T": t, "R": r, "E": e,
                                      "w": w}}
        for tag, v in (("", v32), ("_bf16", v32.to(torch.bfloat16))):
            dt = torch.bfloat16 if tag else None
            _, alpha = K.launch_fwd(v, fm, w, 0.1, rm, residual=True)
            for key, fn in (
                    ("fwd", lambda: K.launch_fwd(v, fm, w, 0.1, rm)),
                    ("fwd_res", lambda: K.launch_fwd(v, fm, w, 0.1, rm,
                                                     residual=True)),
                    ("bwd", lambda: K.launch_bwd(v, fm, w, 0.1, rm, du)),
                    ("bwd_res", lambda: K.launch_bwd(v, fm, w, 0.1, rm, du,
                                                     alpha))):
                res[key + "_ms" + tag] = device_ms(torch, fn)
            with torch.no_grad():
                res["plain_fwd_ms" + tag] = profile_forward(
                    torch, lambda: K.context_mix_plain(v32, fm, w, 0.1,
                                                       dtype=dt,
                                                       rm_ext=rm))[1]
            vp = v32.detach().clone().requires_grad_()
            res["plain_fwd_res_ms" + tag] = profile_forward(
                torch, lambda: K.context_mix_plain(vp, fm, w, 0.1, dtype=dt,
                                                   rm_ext=rm))[1]
            up, _ = K.context_mix_plain(vp, fm, w, 0.1, dtype=dt, rm_ext=rm)
            res["plain_bwd_ms" + tag] = profile_forward(
                torch, lambda: torch.autograd.grad(up, vp, du,
                                                   retain_graph=True))[1]
            del up, vp
            res["library_fwd_ms" + tag] = device_ms(
                torch, lambda: sdpa_mix(torch, v, fm, rm, w, 0.1))
            with torch.no_grad():
                want, _ = K.context_mix_plain(v, fm, w, 0.1, dtype=dt,
                                              rm_ext=rm)
                got = sdpa_mix(torch, v, fm, rm, w, 0.1)
            rtol, atol = CTX_TOL["bfloat16" if tag else "float32"]
            res["library_fwd_err" + tag] = (got - want).abs().max().item()
            res["library_fwd_within_tol" + tag] = bool(torch.allclose(
                got, want, rtol=rtol, atol=atol))
            del want, got
            for key, bnd in (
                    ("fwd", fwd_bound_ms(torch, v, fm, rm, w)),
                    ("fwd_res", fwd_bound_ms(torch, v, fm, rm, w, True)),
                    ("bwd", bwd_bound_ms(torch, v, fm, rm, w, False)),
                    ("bwd_res", bwd_bound_ms(torch, v, fm, rm, w, True))):
                res[key + "_bound_ms" + tag], res[key + "_bound_by" + tag] = \
                    bnd
            # the backward's floor: empty kernels of its two grids (the same
            # for K1b and K1br)
            res["bwd_floor_ms" + tag] = res["bwd_res_floor_ms" + tag] = \
                device_ms(torch, lambda: K.launch_floor_bwd(
                    b, t, r, e, w, v.dtype, dev))
        torch.cuda.empty_cache()
    card = card_line()
    for name, res in out.items():
        for tag, dt in (("", "f32"), ("_bf16", "bf16")):
            log(f"phase 17 (d): context mix at {res['shapes']}, {dt} (device "
                "ms; plain; bound): " + "; ".join(
                    f"{k} {res[key + '_ms' + tag]:.4f} "
                    f"({res['plain_' + pk + '_ms' + tag]:.4f}; "
                    f"{res[key + '_bound_ms' + tag]:.4f}, "
                    f"{res[key + '_bound_by' + tag]})"
                    for k, key, pk in (("K1f", "fwd", "fwd"),
                                       ("K1fr", "fwd_res", "fwd_res"),
                                       ("K1b", "bwd", "bwd"),
                                       ("K1br", "bwd_res", "bwd")))
                + f"; K1b/K1br's floor {res['bwd_floor_ms' + tag]:.4f}"
                + f"; K1f's SDPA yardstick {res['library_fwd_ms' + tag]:.4f}"
                f" (max |err| vs plain {res['library_fwd_err' + tag]:.3e}, "
                f"within CTX_TOL: {res['library_fwd_within_tol' + tag]})"
                + f" — {card}")
    return out


def any_fused_timings(torch, roots: dict, tmp: str) -> dict:
    """Phase 17 (d): K3, K4f and K4b at each shape of ANY_FITS (R = 36 /
    E = 1024, E = 50, K = 40; B = 16, T = 20) on the fused route's own
    inputs there (fused_inputs: the first batch of its split, the initial
    params): fused_kernel_times without the dense variant, so device ms in
    f32 and bf16, the plain version's, the bound from the batch's masks,
    the empty-kernel floor of the grid each launch takes, and for K3
    torch.matmul + torch.max."""
    out = {}
    card = card_line()
    for name, (extra, data, *_) in ANY_FITS.items():
        res = out[name] = fused_kernel_times(
            torch, fused_inputs(torch, roots[data], tmp, extra), dense=False)
        torch.cuda.empty_cache()
        for tag, dt in (("", "f32"), ("_bf16", "bf16")):
            log(f"phase 17 (d): fused route at {name} {res['shapes']}, {dt} "
                "(device ms; plain; bound; an empty kernel of its grid): "
                + "; ".join(
                    f"{k} {res[key + '_ms' + tag]:.4f} "
                    f"({res[key + '_plain_ms' + tag]:.4f}; "
                    f"{res[key + '_bound_ms' + tag]:.4f}, "
                    f"{res[key + '_bound_by' + tag]}; "
                    f"{res[key + '_floor_ms' + tag]:.4f})"
                    for k, key in (("K3", "cross_mil"), ("K4f", "diag"),
                                   ("K4b", "diag_bwd")))
                + f"; K3's torch.matmul + torch.max "
                f"{res['cross_mil_library_ms' + tag]:.4f} — {card}")
    return out


# int8_matmul at shapes torch._int_mm does not take itself (M <= 16, K or N
# not a multiple of 8), which it zero-pads: (M, K, N)
INT8_ANY_SHAPES = ((5, 2048, 256), (16, 2048, 256), (40, 2048, 50),
                   (5, 2043, 50))


def check_int8_any(torch) -> dict:
    """Phase 17 (f): int8_matmul on the card at INT8_ANY_SHAPES, with the
    weight row-major and column-major (`int8_weight`), equal bit for bit
    to the CPU's exact int64 product."""
    from nafae_torch.ops import grounding as TG

    rng = np.random.default_rng(SEED)
    for m, k, n in INT8_ANY_SHAPES:
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
        want = TG.int8_matmul(a, b)
        for w in (b, TG.int8_weight(b)):
            got = TG.int8_matmul(a.cuda(), w.cuda())
            if got.shape != want.shape or not torch.equal(got.cpu(), want):
                fail(f"int8_matmul on the card at M={m} K={k} N={n} differs "
                     "from the int64 product")
    log(f"phase 17 (f): int8_matmul on the card at (M, K, N) "
        f"{INT8_ANY_SHAPES}: equal to the int64 product bit for bit")
    return {"shapes": [list(x) for x in INT8_ANY_SHAPES]}


def check_any(torch, tmp: str, reqs20: tuple) -> dict:
    """Phase 17: the context mix, K3, K4f and K4b at every shape the
    reference takes. (a) check_ctx_any; (g) check_fused_any; R = 36 data
    written (train and val splits at config4 widths), and a config4-width
    split with up to 40 words; (b) check_any_serving; (c, h)
    check_any_fits; (e) config1 eval of the R = 36 split with the oracle
    params, hits card = CPU (eval_card_vs_cpu); (f) check_int8_any; (d)
    any_timings and any_fused_timings."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    free, total = torch.cuda.mem_get_info()
    log(f"phase 17: {free / 2**30:.2f} of {total / 2**30:.2f} GiB of device "
        "memory free")
    errs = check_ctx_any(torch, dev)
    fused_errs = check_fused_any(torch, dev)
    roots = {"c4": tmp, "r36": os.path.join(tmp, "r36"),
             "k40": os.path.join(tmp, "k40")}
    reqs36 = make_requests(roots["r36"], regions=36)
    make_train_data(roots["r36"], regions=36)
    make_train_data(roots["k40"], words=40)
    serving = check_any_serving(torch, {True: reqs36, False: reqs20}, tmp)
    fits = check_any_fits(torch, roots, tmp)
    evals = eval_card_vs_cpu(torch, eval_cfg(
        roots["r36"], os.path.join(tmp, "ck_any_eval"),
        ["data.num_regions=36"]), oracle_params(), "oracle, R = 36")
    int8 = check_int8_any(torch)
    gc.collect()
    torch.cuda.empty_cache()
    times = any_timings(torch)
    fused_times = any_fused_timings(torch, roots, tmp)
    wall = time.perf_counter() - t0
    log(f"phase 17 took {wall:.1f} s")
    return {"errs": errs, "fused_errs": fused_errs, "serving": serving,
            "fits": fits, "eval": evals, "int8_matmul": int8, "times": times,
            "fused_times": fused_times, "phase_s": wall}


ANY_RESULT = "any.json"           # phase 17's results, in the run's tmp


def any_child(tmp: str) -> None:
    """`python3 chip_smoke.py --any-child TMP`: phase 17 (check_any) in a
    process of its own, on phase 5's data in TMP and the serving phase's
    requests made again under TMP/any_reqs; writes its results to
    TMP/ANY_RESULT. Late in a full run torch.profiler leaves kernels out
    of a short trace in the process that ran the earlier phases (a
    replayed phase-17 step kept its backward's kernels and lost its
    forward's); a fresh process traces them all, as phase 12's `train
    --profile` does."""
    import torch

    from nafae_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        fail("no CUDA device")
    _build.build_all(SOURCES)
    out = check_any(torch, tmp, make_requests(os.path.join(tmp, "any_reqs")))
    with open(os.path.join(tmp, ANY_RESULT), "w") as f:
        json.dump(out, f, default=lambda o: o.tolist() if hasattr(o, "tolist")
                  else float(o))


def run_child(torch, tmp: str, flag: str, result: str, phase: str) -> dict:
    """`chip_smoke.py <flag> TMP` (any_child, precision_child) in a child
    process, started once this process has given its cached device memory
    back (the earlier phases' graph pools); the child's lines are logged
    here, and its failure fails the run. Returns its results, TMP/result."""
    gc.collect()
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    run = subprocess.run([sys.executable, os.path.join(here, "chip_smoke.py"),
                          flag, tmp], cwd=here, capture_output=True,
                         text=True, timeout=900)
    for ln in run.stdout.splitlines():
        log(ln)
    if run.returncode != 0:
        fail(f"{phase} (its child process) exited {run.returncode}: "
             f"{run.stderr[-3000:]}")
    with open(os.path.join(tmp, result)) as f:
        return json.load(f)


def any_keys(anyp: dict, name: str, key: str, pkey: str) -> dict:
    """A context-mix kernel's phase-17 numbers for its JSON entry: its max
    |error| against plain over phase 17's cases (f32, bf16), and at each
    shape of ANY_TIMED its device ms, its plain version's and its bound
    (K1f also its SDPA yardstick's ms and max |error|)."""
    errs = anyp["errs"]
    err = {d: (errs["ctx_mix_fwd"][d] if name == "ctx_mix_fwd"
               else errs["grads"][d][name]) for d in GRAPH_DTYPES}
    names = (("ms", key + "_ms"), ("plain_ms", "plain_" + pkey + "_ms"),
             ("bound_ms", key + "_bound_ms"),
             ("bound_by", key + "_bound_by")) + (
        (("library_ms", "library_fwd_ms"),
         ("library_max_abs_err", "library_fwd_err"))
        if name == "ctx_mix_fwd" else ()) + (
        (("floor_ms", key + "_floor_ms"),) if key.startswith("bwd") else ())
    return {"max_abs_err_any": err["float32"],
            "max_abs_err_any_bf16": err["bfloat16"],
            "any_shapes": {
                shape: {"shapes": res["shapes"], **{
                    k + tag: res[f + tag] for tag in ("", "_bf16")
                    for k, f in names}}
                for shape, res in anyp["times"].items()}}


def fused_any_keys(anyp: dict, key: str) -> dict:
    """K3's, K4f's or K4b's phase-17 numbers for its JSON entry (key:
    fused_kernel_times' prefix, cross_mil, diag or diag_bwd): its max
    |error| against plain over CROSS_ANY_CASES or DIAG_ANY_CASES (f32,
    bf16), and at each shape of ANY_FITS its device ms, its plain
    version's, its bound, the empty-kernel floor of its grid and, for K3,
    torch.matmul + torch.max."""
    errs = anyp["fused_errs"]
    outs = {"diag": ("ctx", "clu", "d"), "diag_bwd": ("dw", "dv")}
    err = {d: (errs["cross_mil"][d] if key == "cross_mil" else
               max(errs["diag"][d][n] for n in outs[key]))
           for d in GRAPH_DTYPES}
    names = ("ms", "plain_ms", "bound_ms", "bound_by", "floor_ms") + (
        ("library_ms",) if key == "cross_mil" else ())
    return {"max_abs_err_any": err["float32"],
            "max_abs_err_any_bf16": err["bfloat16"],
            "any_shapes": {
                shape: {"shapes": res["shapes"],
                        **{n + tag: res[f"{key}_{n}{tag}"]
                           for tag in ("", "_bf16") for n in names}}
                for shape, res in anyp["fused_times"].items()}}


# ------------------------------------ phase 18: model.matmul_precision

PREC_MODES = ("highest", "default")
# a `default` step against a `highest` one from one state on one batch:
# each loss term (rtol), each gradient leaf (atol, a fraction of the leaf's
# largest entry) and the gradient's norm (rtol, the same fraction); the
# reference states ~1e-3 for its mode. The control: some leaf must fall
# outside ANY_GRAD_TOL, or TF32 reached no product
PREC_METRIC_RTOL = 2e-3
PREC_GRAD_TOL = (0.0, 1e-2)
PREC_STEPS = 3                  # graphed `default` steps held against eager
PREC_ROUNDS = 8                 # timing rounds: highest, default x2, highest
PREC_C5_STEPS = 2               # the config-5 fit under `default`
PREC_C5_ROUNDS = 2              # ... then its timed rounds on one batch
H100_TF32_FLOPS = 495e12        # TF32 on tensor cores, dense, data sheet
GEMM_MARKS = ("gemm", "nvjet", "xmma")   # in cuBLAS / CUTLASS kernel names
# the projection's [B·T·R, D] x [D, E]: config 4, phase 17's R = 36 / E = 1024
PREC_PROJ = {"config4": (16 * 20 * 20, 2048, 256),
             "R36_E1024": (16 * 20 * 36, 2048, 1024)}
PREC_INPUT = "precision_in.json"   # phase 18's inputs, in the run's tmp
PREC_RESULT = "precision.json"     # ... and its results


def gemm_kernels(torch, fn) -> list[str]:
    """The GEMM kernels (cuBLAS or CUTLASS) of one fn() call after a
    warm-up call, by torch.profiler: full names, most device time first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and any(
                m in ev.name.lower() for m in GEMM_MARKS):
            us[ev.name] = us.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    return sorted(us, key=lambda n: -us[n])


def projection_gemms(torch) -> dict:
    """Phase 18 (d): the projection's forward GEMM (f2 @ w_v) and its
    weight gradient (f2^T @ dv), f32, at PREC_PROJ's shapes under each
    mode: device ms (device_ms, captured inside the mode), the kernels
    torch.profiler names, the bound (bytes, or operations at the f32 or the
    TF32 rate) and default's largest |diff| / largest entry against
    highest's. The two modes must run different kernels, and TF32 must
    change the result."""
    from nafae_torch.device import matmul_precision

    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    out = {}
    for name, (n, d, e) in PREC_PROJ.items():
        f2 = torch.randn(n, d, device="cuda", generator=gen)
        w = torch.randn(d, e, device="cuda", generator=gen) / d ** 0.5
        dv = torch.randn(n, e, device="cuda", generator=gen)
        calls = {"fwd": lambda: f2 @ w, "bwd": lambda: f2.T @ dv}
        moved = 4 * (n * d + d * e + n * e)    # each: two read, one written
        res = out[name] = {"shapes": {"N": n, "D": d, "E": e}}
        got = {}
        for mode in PREC_MODES:
            res["bound_ms_" + mode], res["bound_by_" + mode] = bound(
                torch, moved, 2 * n * d * e, torch.float32,
                H100_TF32_FLOPS if mode == "default" else None)
            with matmul_precision(mode):
                for key, fn in calls.items():
                    res[f"{key}_ms_{mode}"] = device_ms(torch, fn)
                    res[f"{key}_kernels_{mode}"] = gemm_kernels(torch, fn)
                    got[key, mode] = fn()
        for key in calls:
            want = got[key, "highest"]
            res[key + "_rel_diff"] = ((got[key, "default"] - want).abs().max()
                                      / want.abs().max()).item()
            names = [res[f"{key}_kernels_{m}"] for m in PREC_MODES]
            if not all(names) or names[0][0] == names[1][0] or \
                    res[key + "_rel_diff"] == 0:
                fail(f"phase 18 (d): the projection's {key} GEMM at "
                     f"{res['shapes']} ran {names} (highest, default), "
                     f"default off highest by {res[key + '_rel_diff']:.3e}: "
                     "TF32 did not reach it")
        del f2, w, dv, got
        torch.cuda.empty_cache()
    card = card_line()
    for name, res in out.items():
        log(f"phase 18 (d): projection GEMMs at {res['shapes']} f32, device "
            "ms highest / default (bound): " + "; ".join(
                f"{key} {res[key + '_ms_highest']:.4f} "
                f"({res['bound_ms_highest']:.4f}, {res['bound_by_highest']})"
                f" / {res[key + '_ms_default']:.4f} "
                f"({res['bound_ms_default']:.4f}, {res['bound_by_default']})"
                f", default off by {res[key + '_rel_diff']:.3e}"
                for key in ("fwd", "bwd")) + f" — {card}")
        for key in ("fwd", "bwd"):
            log(f"phase 18 (d): projection {key} kernels at {name}: highest "
                f"{res[key + '_kernels_highest']}; default "
                f"{res[key + '_kernels_default']}")
    return out


def prec_programs(torch, cfgs: dict, cache) -> tuple[dict, dict]:
    """Each mode's step program on the device cache, and its initial
    state: ({mode: TrainFn}, {mode: TrainState})."""
    import nafae_torch.train as TT

    dev = torch.device("cuda")
    return ({m: TT.build_train_fn(c, TT.make_optimizer(c), dev, cache=cache)
             for m, c in cfgs.items()},
            {m: TT.TrainState.create(c, device=dev) for m, c in cfgs.items()})


def prec_cache(torch, root: str, regions: int) -> tuple[dict, list]:
    """The train split at `root` on the device (`build_cache`) and the
    first four batches' index tensors, in fit's order."""
    import nafae_torch.train as TT
    from nafae_torch.data.loader import BatchLoader
    from nafae_torch.data.youcook2 import SegmentDataset

    ds = SegmentDataset(root, "train", 20, regions, 2048, 8)
    return (TT.build_cache(ds, torch.device("cuda")),
            [torch.from_numpy(b["segment_id"].astype(np.int64)).cuda()
             for _, b in BatchLoader(ds, 16, seed=0).steps(4)])


def prec_step_times(torch, progs: dict, states: dict, idxs: list,
                    modes=PREC_MODES) -> dict:
    """Phase 18 (e): each mode's graphed step host to host (an index batch
    in, metrics on the host), PREC_ROUNDS rounds of the modes in order
    then reversed (highest, default, default, highest); then a step's
    device busy time (torch.profiler) and the idle share. Phase 20 (e)
    passes its dtypes as the modes."""
    host = {m: [] for m in progs}

    def run(m, i):
        states[m], mt = progs[m](states[m], idxs[i % len(idxs)])
        return mt

    for i in range(PREC_ROUNDS):
        for m in tuple(modes) + tuple(modes)[::-1]:
            t0 = time.perf_counter()
            float(run(m, i)["loss"])
            host[m].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for m in modes:
        top, busy, ops = profile_forward(torch, lambda: run(m, 0))
        ms = statistics.median(host[m])
        out[m] = {"host_ms": ms, "host_ms_all": host[m],
                  "device_busy_ms": busy, "device_ops": ops,
                  "idle_share": 1 - busy / ms, "kernels": top}
    return out


class Decisions:
    """The discrete choices of one training step's losses on the auto
    route, in the order the step makes them: the MIL max's region of each
    (video, word, frame), each (word, frame)'s top region r* and its
    nearest center c*. Recorded (record None), or replayed from a record,
    so that two steps in other modes take the same choices and differ only
    in their rounding. The fused route makes them inside K3 and K4f, which
    take no record; the hinges' signs are not pinned."""

    def __init__(self, torch, record=None):
        self.torch, self.made = torch, []
        self.replay = None if record is None else list(record)

    def take(self, kind: str, make):
        choice = self.replay.pop(0)[1] if self.replay else make()
        self.made.append((kind, choice))
        return choice

    def flips(self, other: "Decisions") -> dict:
        """{kind: [choices that differ from other's, choices]}."""
        out = {}
        for (kind, a), (_, b) in zip(self.made, other.made):
            n = out.setdefault(kind, [0, 0])
            n[0] += int((a != b).sum().item())
            n[1] += a.numel()
        return out

    def __enter__(self):
        from nafae_torch.ops import grounding as G
        from nafae_torch.ops import losses as L

        torch = self.torch
        self.real = real = (G.frame_mil_max, L.select_top_regions,
                            L.kmeans_assign)

        def mil_max(s, frame_mask):
            r = self.take("mil_max", lambda: torch.argmax(s, -1, True))
            a = s.gather(-1, r)[..., 0]
            return torch.where(frame_mask[..., None, :] > 0, a, 0.0)

        def top_regions(s, *args, r_star=None, **kw):
            r = self.take("r_star", lambda: torch.argmax(s, -1)
                          if r_star is None else r_star)
            return real[1](s, *args, r_star=r, **kw)

        def assign(*args, **kw):
            return self.take("c_star", lambda: real[2](*args, **kw))

        G.frame_mil_max, L.select_top_regions, L.kmeans_assign = \
            mil_max, top_regions, assign
        return self

    def __exit__(self, *exc):
        from nafae_torch.ops import grounding as G
        from nafae_torch.ops import losses as L

        G.frame_mil_max, L.select_top_regions, L.kmeans_assign = self.real


def prec_rows_off(rows: list, want: list) -> tuple[dict, list]:
    """(each metric's largest relative diff over the rows, the metrics past
    their limits): the loss terms at PREC_METRIC_RTOL, grad_norm at
    PREC_GRAD_TOL's fraction; the rates and the step are not compared."""
    rel = {}
    for got, ref in zip(rows, want):
        for k, v in ref.items():
            if k not in RATES and k != "step":
                rel[k] = max(rel.get(k, 0.0),
                             abs(got[k] - v) / max(abs(v), 1e-30))
    return rel, [k for k, r in rel.items() if r > (
        PREC_GRAD_TOL[1] if k == "grad_norm" else PREC_METRIC_RTOL)]


def prec_one_step(torch, cfgs: dict, batch: dict, route: str) -> dict:
    """Phase 18 (a): one eager `train_step` in each mode from the initial
    state on `batch`, the gradients as the update receives them
    (`recording`), the choices recorded (`Decisions`): default's metrics
    within their limits of highest's (prec_rows_off). A choice that flips
    between the modes (a near tie) moves a gradient by a whole term, so on
    the auto route a third step, `default` replaying highest's choices, holds each
    gradient leaf within PREC_GRAD_TOL of highest's and some leaf outside
    ANY_GRAD_TOL (the control: TF32 reached the products). On the fused
    route, whose choices K3 and K4f make, the control holds on the free
    step and its gradients are reported."""
    import nafae_torch.train as TT

    def step(m, dec):
        tx = TT.make_optimizer(cfgs[m])
        got = recording(tx)
        with dec:
            _, mt = TT.train_step(TT.TrainState.create(cfgs[m], device="cuda"),
                                  batch, cfgs[m], tx)
        return ({k: float(v) for k, v in mt.items()},
                {k: torch.from_numpy(v) for k, v in got[0].items()})

    dec = {m: Decisions(torch) for m in PREC_MODES}
    (rows, want), (rows_d, free) = (step(m, dec[m]) for m in PREC_MODES)
    rel, off = prec_rows_off([rows_d], [rows])
    free_gap = grad_gap(torch, free, want, PREC_GRAD_TOL)
    held = free
    if route == "auto":
        replay = Decisions(torch, dec["highest"].made)
        held = step("default", replay)[1]
        if replay.replay or not replay.made:
            fail(f"phase 18 (a): the replayed step took "
                 f"{len(replay.made)} choices, "
                 f"{len(dec['highest'].made)} recorded")
    worst, bad = grad_gap(torch, held, want, PREC_GRAD_TOL)
    _, outside = grad_gap(torch, held, want, ANY_GRAD_TOL)
    if off or (route == "auto" and bad):
        fail(f"phase 18 (a): the `default` step ({route}) is off the "
             f"`highest` one: metrics {rel} ({off} past their limits); with "
             f"highest's choices, gradients of {bad} up to {worst:.3e} of "
             f"the largest entry (limit {PREC_GRAD_TOL[1]})")
    if not outside:
        fail(f"phase 18 (a): every gradient leaf of the `default` step "
             f"({route}) is within {ANY_GRAD_TOL} of `highest`'s: TF32 "
             "reached no product")
    return {"metric_rel_diff": rel,
            "grad_rel_diff_free": free_gap[0], "outside_free": free_gap[1],
            "grad_rel_diff_pinned": worst if route == "auto" else None,
            "outside_any_grad_tol": outside,
            "flips": dec["default"].flips(dec["highest"])}


def check_precision_c4(torch, root: str, tmp: str, proj: dict) -> dict:
    """Phase 18 (a, b, c, e) at config 4 f32 on both routes, on phase 5's
    data on the device: (a) prec_one_step on the first batch; (b) the
    `default` program (`build_train_fn`) PREC_STEPS steps, launches
    per_step_launches a step, captured (two graphs, a replay a step), rows
    and state bit for bit the eager `train_step` chain; (c) one more replay
    of each mode's program traced: it names the projection's forward
    kernel of its mode (projection_gemms' at config 4); (e)
    prec_step_times."""
    cache, idxs = prec_cache(torch, root, 20)
    fwd = {m: proj["config4"]["fwd_kernels_" + m][0] for m in PREC_MODES}
    out = {}
    for route in ROUTES:
        cfgs = {m: cache_cfg(root, os.path.join(tmp, f"ck_prec_{route}_{m}"),
                             route, ["train.steps=1000",
                                     f"model.matmul_precision={m}"])
                for m in PREC_MODES}
        res = out[route] = {"one_step": prec_one_step(
            torch, cfgs, {k: v.index_select(0, idxs[0])
                          for k, v in cache.items()}, route)}
        progs, states = prec_programs(torch, cfgs, cache)
        rows = {}
        zero_counts()                   # the `default` steps start here
        for i in range(PREC_STEPS):
            states["default"], mt = progs["default"](states["default"],
                                                     idxs[i])
            rows[i + 1] = {k: float(v) for k, v in mt.items()}
        counts = read_counts()          # ... and end here
        want = {k: n * PREC_STEPS for k, n in per_step_launches(route).items()}
        st = dict(progs["default"].stats)
        if counts != want or not progs["default"].graphed or \
                st["graphs"] != 2 or st["replays"] != PREC_STEPS:
            fail(f"phase 18 (b): the `default` program ({route}) launched "
                 f"{counts} (expected {want}) and ran {st}")
        eager = eager_chain(torch, cfgs["default"], idxs[:PREC_STEPS],
                            cache=cache)
        bad = [i for i, r in rows.items()
               if not metrics_equal(r, eager["rows"][i])]
        bad += state_diffs(torch, states["default"], eager["state"])
        if bad:
            fail(f"phase 18 (b): the graphed `default` step ({route}) differs "
                 f"from the eager train_step chain in {bad}")
        for i in range(PREC_STEPS):
            states["highest"], _ = progs["highest"](states["highest"],
                                                    idxs[i])
        traced = {}
        for m in PREC_MODES:
            def replay():
                states[m], _ = progs[m](states[m], idxs[3])
            traced[m] = gemm_kernels(torch, replay)
            if fwd[m] not in traced[m]:
                fail(f"phase 18 (c): a traced `{m}` replay ({route}) names "
                     f"the GEMMs {traced[m]}, not the projection's {fwd[m]}")
        res.update(launches=counts, program=st, traced_gemms=traced,
                   times=prec_step_times(torch, progs, states, idxs))
        del progs, states, eager
        torch.cuda.empty_cache()
    del cache
    torch.cuda.empty_cache()
    card = card_line()
    for route, res in out.items():
        one, t = res["one_step"], res["times"]
        pinned = one["grad_rel_diff_pinned"]
        log(f"phase 18 (a): config4 f32 {route}, one step `default` against "
            f"`highest`: metrics' relative diffs "
            + ", ".join(f"{k} {v:.3e}" for k, v in
                        one["metric_rel_diff"].items())
            + f" (limits {PREC_METRIC_RTOL}, grad_norm {PREC_GRAD_TOL[1]});"
            f" gradients max |diff| / largest entry "
            f"{one['grad_rel_diff_free']:.3e} (leaves past "
            f"{PREC_GRAD_TOL[1]}: {one['outside_free']}; choices flipped "
            f"{one['flips']})" + (
                f", with highest's choices {pinned:.3e} (limit "
                f"{PREC_GRAD_TOL[1]})" if pinned is not None else "")
            + f"; outside {ANY_GRAD_TOL}: {one['outside_any_grad_tol']}")
        log(f"phase 18 (b, c): config4 f32 {route} `default`: {PREC_STEPS} "
            f"graphed steps bit for bit the eager chain, launches "
            f"{res['launches']}; a traced replay's GEMMs by device time: "
            f"highest {res['traced_gemms']['highest']}; default "
            f"{res['traced_gemms']['default']}")
        log(f"phase 18 (e): config4 f32 {route} cached step as a graph, host "
            "to host (busy, idle): " + "; ".join(
                f"{m} {t[m]['host_ms']:.4f} ms ({t[m]['device_busy_ms']:.4f} "
                f"ms in {t[m]['device_ops']:.0f} operations, "
                f"{100 * t[m]['idle_share']:.1f}%)" for m in PREC_MODES)
            + f", medians of {2 * PREC_ROUNDS} interleaved — {card}")
        for m in PREC_MODES:
            log(f"device time per {m} {route} step by kernel: " + "; ".join(
                f"{us:.1f} us {k}" for k, us in t[m]["kernels"]))
    return out


def prec_r36_times(torch, root: str, tmp: str) -> dict:
    """Phase 18 (e): phase 17's R = 36 / E = 1024 / w = 3 auto step, f32,
    from the device cache of its split, graphed in each mode
    (prec_step_times, after PREC_STEPS steps of each)."""
    cache, idxs = prec_cache(torch, root, 36)
    cfgs = {m: cache_cfg(root, os.path.join(tmp, f"ck_prec_r36_{m}"), "auto",
                         ["train.steps=1000", *ANY_FITS["R36_E1024_w3"][0],
                          f"model.matmul_precision={m}"])
            for m in PREC_MODES}
    progs, states = prec_programs(torch, cfgs, cache)
    for i in range(PREC_STEPS):
        for m in PREC_MODES:
            states[m], mt = progs[m](states[m], idxs[i])
            if not np.isfinite(float(mt["loss"])):
                fail(f"phase 18 (e): the R = 36 `{m}` step's loss is {mt}")
    t = prec_step_times(torch, progs, states, idxs)
    del progs, states, cache
    torch.cuda.empty_cache()
    log("phase 18 (e): R = 36 / E = 1024 / w = 3 auto step f32 as a graph, "
        "host to host (busy, idle): " + "; ".join(
            f"{m} {t[m]['host_ms']:.4f} ms ({t[m]['device_busy_ms']:.4f} ms,"
            f" {100 * t[m]['idle_share']:.1f}%)" for m in PREC_MODES)
        + f" — {card_line()}")
    return t


def check_precision_c5(torch, ann: str, tmp: str, highest_rows: list) -> dict:
    """Phase 18 (f): config-5 `fit`, PREC_C5_STEPS f32 steps under
    `default` on phase 9's videos: launches c5_launches a step, captured
    (two graphs, a replay a step), each row's metrics within their limits
    (prec_rows_off) of phase 9's f32 fit's (`highest`; the same seed, data
    and schedule's first rows: its first update has lr 0); then the step
    eagerly on the first batch resident on the card in each mode: a
    warm-up step each, then PREC_C5_ROUNDS rounds of highest, default,
    default, highest."""
    import nafae_torch.train as TT

    cfg = c5_cfg(ann, os.path.join(tmp, "ck5_prec"), "float32",
                 PREC_C5_STEPS, ["model.matmul_precision=default"])
    torch.cuda.empty_cache()
    zero_counts()                               # main path starts here
    fitted = traced_fit(torch, cfg)
    counts = read_counts()                      # ... and ends here
    want = {k: n * PREC_C5_STEPS for k, n in c5_launches(cfg).items()}
    if counts != want:
        fail(f"phase 18 (f): the `default` config-5 fit launched {counts}, "
             f"expected {want}")
    st = expect_graphed(fitted, "phase 18 (f)", 2, PREC_C5_STEPS)
    rel, off = prec_rows_off(fitted["logs"], highest_rows)
    if off:
        fail(f"phase 18 (f): the `default` config-5 rows {fitted['logs']} "
             f"are off phase 9's `highest` rows {highest_rows}: {rel}, "
             f"{off} past their limits")
    batch = fitted["seen"][0]
    del fitted
    gc.collect()
    torch.cuda.empty_cache()

    dev = torch.device("cuda")
    det = c5_detector(torch, cfg)
    tb = TT.batch_to_device(batch, dev)
    cfgs = {m: c5_cfg(ann, os.path.join(tmp, f"ck5_prec_{m}"), "float32",
                      1000, [f"model.matmul_precision={m}"])
            for m in PREC_MODES}
    txs = {m: TT.make_optimizer(c) for m, c in cfgs.items()}
    states = {m: TT.TrainState.create(c, device=dev) for m, c in cfgs.items()}
    host = {m: [] for m in PREC_MODES}
    order = PREC_MODES + (PREC_MODES + PREC_MODES[::-1]) * PREC_C5_ROUNDS
    for i, m in enumerate(order):
        t0 = time.perf_counter()
        states[m], mt = TT.train_step(states[m], tb, cfgs[m], txs[m], det)
        float(mt["loss"])
        if i >= len(PREC_MODES):               # the first of each warms up
            host[m].append((time.perf_counter() - t0) * 1e3)
    del det, tb, states
    torch.cuda.empty_cache()
    res = {"launches": counts, "program": st, "rows_rel_diff": rel,
           "resident_step_ms": {m: statistics.median(v)
                                for m, v in host.items()},
           "resident_step_ms_all": host}
    log(f"phase 18 (f): config5 f32 fit of {PREC_C5_STEPS} steps under "
        f"`default`: launches {counts}, {st['graphs']} graphs, "
        f"{st['replays']} replays; rows against phase 9's `highest` max "
        f"relative diff {rel} (limits {PREC_METRIC_RTOL}, grad_norm "
        f"{PREC_GRAD_TOL[1]}); "
        "the step on a resident batch, eager: " + ", ".join(
            f"{m} {res['resident_step_ms'][m]:.2f} ms" for m in PREC_MODES)
        + f" — {card_line()}")
    return res


def check_precision(torch, tmp: str, ann: str, c5_rows: list) -> dict:
    """Phase 18: model.matmul_precision=default against highest.
    (d) projection_gemms; (a, b, c, e) check_precision_c4; (e)
    prec_r36_times on phase 17's R = 36 split; (f) check_precision_c5."""
    t = [time.perf_counter()]
    proj = projection_gemms(torch)
    t.append(time.perf_counter())
    c4 = check_precision_c4(torch, tmp, tmp, proj)
    t.append(time.perf_counter())
    r36 = prec_r36_times(torch, os.path.join(tmp, "r36"), tmp)
    t.append(time.perf_counter())
    c5 = check_precision_c5(torch, ann, tmp, c5_rows)
    t.append(time.perf_counter())
    parts = [b - a for a, b in zip(t, t[1:])]
    log(f"phase 18 took {t[-1] - t[0]:.1f} s (projection, config 4, R = 36, "
        f"config 5: {', '.join(f'{x:.1f}' for x in parts)} s)")
    return {"projection": proj, "config4": c4, "r36_step": r36,
            "config5": c5, "phase_s": t[-1] - t[0], "parts_s": parts}


def precision_child(tmp: str) -> None:
    """`python3 chip_smoke.py --precision-child TMP`: phase 18
    (check_precision) in a process of its own, as phase 17 runs (its
    profiler traces whole), on phase 5's data in TMP, phase 17's R = 36
    split in TMP/r36 and phase 9's videos; reads TMP/PREC_INPUT (the
    videos' annotations, phase 9's f32 rows) and writes its results to
    TMP/PREC_RESULT."""
    import torch

    from nafae_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        fail("no CUDA device")
    _build.build_all(SOURCES)
    with open(os.path.join(tmp, PREC_INPUT)) as f:
        given = json.load(f)
    out = check_precision(torch, tmp, given["ann"], given["c5_rows"])
    with open(os.path.join(tmp, PREC_RESULT), "w") as f:
        json.dump(out, f, default=float)


# --------------------------------------------- phase 19: orbax checkpoints

# the JAX package's orbax checkpoint of TrainState.create(PRNGKey(0),
# config4) at full width, with expected.json (tests/test_torch_orbax.py
# writes both): the leaves' sha256s as JAX restores them, the JAX
# package's first fit row from it and its eval with its params, and the
# data and overrides those ran with
ORBAX_FIXTURE = os.path.join("tests", "data", "orbax_config4")
ORBAX_ACC_TOL = 1e-12           # eval accuracies, card against JAX


def orbax_leaves(state) -> dict[str, np.ndarray]:
    """The port's config-4 TrainState under the names of the JAX package's
    orbax leaves: adamw after clip_by_global_norm, so opt_state.1.0 holds
    adam's count, mu and nu and opt_state.1.2 the schedule's count (the
    port keeps one count; the two are equal)."""
    out = {"step": np.asarray(state.step, np.int32),
           "centers": state.centers.cpu().numpy(),
           "opt_state.1.0.count": np.asarray(state.opt_state["count"],
                                             np.int32)}
    out["opt_state.1.2.count"] = out["opt_state.1.0.count"]
    for k, v in state.params.items():
        out[f"params.{k}"] = v.cpu().numpy()
    for m in ("mu", "nu"):
        for k, v in state.opt_state[m].items():
            out[f"opt_state.1.0.{m}.{k}"] = v.cpu().numpy()
    return out


def digest(a: np.ndarray | None) -> dict | None:
    if a is None:
        return None
    a = np.ascontiguousarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def files_digest(path: str) -> dict[str, str]:
    """sha256 of every file under path, by relative path."""
    out = {}
    for d, _, names in os.walk(path):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), path)] = \
                    hashlib.sha256(f.read()).hexdigest()
    return out


def check_orbax(torch, tmp: str) -> dict:
    """Phase 19: the JAX package's orbax checkpoint (ORBAX_FIXTURE) on the
    card. (a) CheckpointManager.restore_latest and load_eval_params
    restore it there, every leaf's sha256 expected.json's (host seconds of
    each restore printed); (b) a graphed f32 GroundingServer serves the
    fixture's val split from its params (K1f launched, one batch held
    against a CPU re-run) and `evaluate_config` gives the JAX package's
    eval: num_annotations and hits equal, accuracies within ORBAX_ACC_TOL;
    (c) `fit` for one step in a copy of the checkpoint directory, on each
    route, CUDA graphs on: it resumes from the orbax step, its first row
    within phase 13's SP_METRIC_TOL of the JAX package's, state_1.pt
    written beside the untouched step directory, and the route's kernels
    launched (K1fr and K1br; pallas also K3, K4f and K4b)."""
    from nafae_torch.config import load_config
    from nafae_torch.data.synthetic import generate_synthetic_dataset
    from nafae_torch.evaluate import evaluate_config
    from nafae_torch.serve import GroundingServer
    from nafae_torch.train import TrainState
    from nafae_torch.utils.checkpoint import (CheckpointManager,
                                              load_eval_params)

    t_phase = time.perf_counter()
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           ORBAX_FIXTURE)
    with open(os.path.join(fixture, "expected.json")) as f:
        expected = json.load(f)
    root = os.path.join(tmp, "orbax_data")
    for split, kw in expected["data"].items():
        generate_synthetic_dataset(root, split, **kw)

    def cfg_of(ckpt: str, route: str = "auto"):
        return load_config(preset_name="config4", overrides=[
            f"data.root={root}", f"train.ckpt_dir={ckpt}",
            *expected["fit_overrides"], f"train.kernels={route}"])

    # (a) restore on the card
    cfg = cfg_of(fixture)
    template = TrainState.create(cfg, device="cuda")
    t0 = time.perf_counter()
    state = CheckpointManager(fixture).restore_latest(template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = load_eval_params(cfg, fixture, device="cuda")
    torch.cuda.synchronize()
    params_s = time.perf_counter() - t0
    if state is None or params is None:
        fail(f"phase 19 (a): nothing restored from {fixture}")
    if state.device.type != "cuda" or any(
            v.device.type != "cuda" for v in params.values()):
        fail("phase 19 (a): the restored state is not on the card")
    want = expected["leaves"]
    got = {k: digest(v) for k, v in orbax_leaves(state).items()}
    got_params = {f"params.{k}": digest(v.cpu().numpy())
                  for k, v in params.items()}
    bad = sorted(k for k in want.keys() | got.keys()
                 if got.get(k) != want.get(k))
    bad += sorted(k for k, v in got_params.items() if v != want.get(k))
    if bad:
        fail(f"phase 19 (a): leaves {bad} differ from the JAX package's "
             "restore (sha256, dtype or shape)")
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, names in
               os.walk(os.path.join(fixture, "0")) for n in names)
    log(f"phase 19 (a): the JAX package's orbax checkpoint of config 4 "
        f"({size} bytes) restored on the card, {len(got)} leaves bit for "
        f"bit the JAX package's: restore_latest {restore_s:.3f} s, "
        f"load_eval_params "
        f"{params_s:.3f} s of host time")

    # (b) serving and eval from the restored params
    segs, _ = read_requests(root)
    zero_counts()                               # serving starts here
    srv = GroundingServer(cfg, params, device="cuda")
    results = srv.ground_segments(segs)
    serve_counts = read_counts()                # ... and ends here
    if serve_counts["ctx_mix_fwd"] == 0 or any(
            n for k, n in serve_counts.items() if k != "ctx_mix_fwd"):
        fail(f"phase 19 (b): serving launched {serve_counts}; it must "
             "launch K1f and no other kernel")
    vals = [fr["score"] for r in results for w in r["words"]
            for fr in w["frames"]]
    if len(results) != len(segs) or not np.all(np.isfinite(vals)):
        fail("phase 19 (b): the server's answers are not finite")
    check_cpu_rerun(torch, cfg, params, srv, segs)
    zero_counts()
    ev = evaluate_config(cfg, params=params, device="cuda")
    jev = expected["eval"]
    hits = {who: round(r["box_acc_micro"] * r["num_annotations"])
            for who, r in (("card", ev), ("jax", jev))}
    acc_diff = max(abs(ev[k] - jev[k])
                   for k in ("box_acc_micro", "box_acc_macro"))
    if ev["num_annotations"] != jev["num_annotations"] or \
            hits["card"] != hits["jax"] or acc_diff > ORBAX_ACC_TOL:
        fail(f"phase 19 (b): eval on the card {ev} differs from the JAX "
             f"package's {jev}")
    log(f"phase 19 (b): served {len(segs)} segments from the restored "
        f"params (launches {serve_counts}); eval {ev['num_annotations']} "
        f"annotations, hits card {hits['card']} / JAX {hits['jax']}, "
        f"accuracies within {acc_diff:.1e} of the JAX package's")

    # (c) fit resumes from the orbax step, each route
    rtol, atol = SP_METRIC_TOL
    jrow = expected["fit_first_row"]
    fits = {}
    for route in ROUTES:
        ck = os.path.join(tmp, f"orbax_fit_{route}")
        shutil.copytree(os.path.join(fixture, "0"), os.path.join(ck, "0"))
        before = files_digest(os.path.join(ck, "0"))
        zero_counts()                           # the fit starts here
        logs = run_fit(torch, cfg_of(ck, route))
        counts = read_counts()                  # ... and ends here
        row = logs[0]
        diff = {k: abs(row[k] - v) / max(abs(v), 1e-30)
                for k, v in jrow.items() if k != "step"}
        off = {k: (row[k], v) for k, v in jrow.items() if k != "step" and
               abs(row[k] - v) > atol + rtol * abs(v)}
        if row["step"] != jrow["step"] or off:
            fail(f"phase 19 (c): the resumed fit's first row ({route}) is "
                 f"off the JAX package's: {off} (limit {SP_METRIC_TOL})")
        if not os.path.exists(os.path.join(ck, "state_1.pt")):
            fail(f"phase 19 (c): the resumed fit ({route}) wrote no "
                 "state_1.pt")
        if files_digest(os.path.join(ck, "0")) != before:
            fail(f"phase 19 (c): the fit ({route}) changed the orbax step "
                 "directory it resumed from")
        per = per_step_launches(route)
        wrong = {k: n for k, n in counts.items() if (n > 0) != (per[k] > 0)}
        if wrong:
            fail(f"phase 19 (c): the resumed fit ({route}) launched "
                 f"{counts}; expected the kernels of {per}")
        fits[route] = {"row": row, "launches": counts,
                       "max_rel_diff": max(diff.values())}
        log(f"phase 19 (c): fit ({route}, graphed) resumed from the orbax "
            f"step 0, one step: first row within {max(diff.values()):.2e} "
            f"(relative) of the JAX package's; launches {counts}; "
            "state_1.pt beside the untouched step directory")
    wall = time.perf_counter() - t_phase
    log(f"phase 19 took {wall:.1f} s")
    return {"restore_s": restore_s, "load_eval_params_s": params_s,
            "bytes": size, "leaves": len(got),
            "serve_launches": serve_counts,
            "eval": {"card": ev, "jax": jev, "hits": hits,
                     "max_acc_diff": acc_diff},
            "fits": fits, "phase_s": wall}


# ------------------------------------------ phase 20: model.dtype=float16

# K1f, K1fr, K1b and K1br on f16 tensors against their plain versions at f16
# (context_mix_plain, context_alpha_plain and context_mix_bwd_plain: the
# kernels' rounding points, so the two differ by the order of the f32 sums
# and the few values that round the other way, an alpha or a ds one f16 ulp
# apart; where du_n is an f16 subnormal one ulp is a large part of a ds, so
# a norm, not the largest entry, tells a right rounding from a wrong one):
# ||got - want|| / ||want|| within F16_REL, and max |got - want| within
# F16_MAX of max |want| (a value read as another type's bits, or flushed to
# zero, lands far past it). The bf16-rounded control, the plain versions at
# bf16 on the same f32 inputs, must exceed F16_REL wherever it differs from
# the f16 ones at all (at R = 1 alpha is 1 in both).
F16_REL = 7e-4
F16_MAX = 1e-2
# du scaled so that du_n lies below f16's smallest normal (6.1e-5), where
# bf16 keeps it normal: a flush to zero takes all of dv
F16_SUBNORMAL = 1e-5
# phase 20's cases: the specialised kernels' (CTX_CASES), the general
# variant's (CTX_ANY_CASES: R = 33 to 65, E = 3 to 1024, w = 17 and 20)
# and R = 81 at E = 516 (its wide kernels); with real halo frames both
# sets of halo cases
F16_CASES = CTX_CASES + CTX_ANY_CASES + [(2, 3, 81, 516, 2, True, False)]
F16_HALO_CASES = CTX_HALO_CASES + CTX_ANY_HALO_CASES
F16_KEYS = ("ctx_mix_fwd", "ctx_mix_fwd_res", "alpha", "ctx_mix_bwd",
            "ctx_mix_bwd_res")
# one f16 step's gradients, card against CPU: each leaf within this
# fraction of its largest entry. The card's kernels round du_n, ds and
# alpha where the TPU kernel does, the CPU's autograd rounds at its casts,
# so at full width they are further apart than the port and JAX at the
# CPU tests' widths (2e-3): 1.887e-3 on the first batch (NVIDIA H100 80GB
# HBM3). The card's bf16 step must fall outside it (3.6e-2 there).
F16_GRAD_TOL = (0.0, 5e-3)
F16_STEPS = 3                    # steps of the recompute route's fit
# a traced replay of an f16 step names the f16 instantiations, and no
# other, of each kernel of the context mix it launches
F16_TRACE = {
    "ctx_mix_fwd": ("ctx_mix_fwd_pairs", "ctx_mix_fwd_mix",
                    ("ctx_mix_fwd_pairs", "__half"),
                    ("ctx_mix_fwd_mix", "__half")),
    "ctx_mix_fwd_res": ("ctx_mix_fwd_pairs", "ctx_mix_fwd_mix",
                        ("ctx_mix_fwd_pairs", "__half"),
                        ("ctx_mix_fwd_mix", "__half")),
    "ctx_mix_bwd": ("ctx_mix_bwd_pairs", "ctx_mix_bwd_gather",
                    ("ctx_mix_bwd_pairs", "__half"),
                    ("ctx_mix_bwd_gather", "__half")),
    "ctx_mix_bwd_res": ("ctx_mix_bwd_pairs", "ctx_mix_bwd_gather",
                        ("ctx_mix_bwd_pairs", "__half"),
                        ("ctx_mix_bwd_gather", "__half"))}
# the kernels' times: config 4 and phase 17's R = 36 shape
F16_TIMED = {"config4": (16, 20, 20, 256, 3),
             "R36_E1024_w3": ANY_TIMED["R36_E1024_w3"]}
F16_DTYPES = ("float32", "bfloat16", "float16")
F16_RESULT = "f16.json"          # phase 20's results, in the run's tmp


def f16_gap(torch, got, want) -> tuple[float, float]:
    """(||got - want|| / ||want||, max |got - want| / max |want|)."""
    got, want = got.float(), want.float()
    d = got - want
    top = max(want.abs().max().item(), 1e-30)
    return ((d.norm() / max(want.norm().item(), 1e-30)).item(),
            d.abs().max().item() / top)


def f16_plain(torch, v32, fm, rm, w, du, dt, alpha=None) -> dict:
    """The plain versions at compute dtype dt on the f32 inputs: u (K1f,
    K1fr), alpha (K1fr), dv of K1b and of K1br (on `alpha`, else the plain
    alpha), for each du in `du` ({tag: du})."""
    from nafae_torch.ops.kernels import ctx_mix as K

    a = K.context_alpha_plain(v32, fm, w, 0.1, dtype=dt, rm_ext=rm)
    u = K.context_mix_plain(v32, fm, w, 0.1, dtype=dt, rm_ext=rm)[0]
    out = {"ctx_mix_fwd": u, "ctx_mix_fwd_res": u, "alpha": a}
    for tag, d in du.items():
        out["ctx_mix_bwd" + tag] = K.context_mix_bwd_plain(
            v32, fm, w, 0.1, d, dt, rm)
        out["ctx_mix_bwd_res" + tag] = K.context_mix_bwd_plain(
            v32, fm, w, 0.1, d, dt, rm, a if alpha is None else alpha)
    return out


def check_f16_kernels(torch, device) -> dict:
    """Phase 20 (a): K1f, K1fr, K1b and K1br launched on f16 tensors at
    F16_CASES and F16_HALO_CASES, du as drawn and scaled by F16_SUBNORMAL,
    against their plain versions at f16 (f16_plain; K1br on K1fr's alpha)
    within F16_REL and F16_MAX; the bf16-rounded control (f16_plain at
    bf16) outside F16_REL wherever it differs; and two launches of each
    bitwise equal at R = 36, E = 1024. Returns the worst gaps of each
    kernel and of the control, and the largest |error|."""
    from nafae_torch.ops.kernels import ctx_mix as K

    gen = torch.Generator().manual_seed(SEED + 23)
    worst = {k: [0.0, 0.0, 0.0] for k in F16_KEYS}   # rel, max, max abs
    control = {k: float("inf") for k in F16_KEYS}
    cases = ([c + (False,) for c in F16_CASES]
             + [c + (True, False, True) for c in F16_HALO_CASES])
    for b, t, r, e, w, with_rm, edges, halos in cases:
        v32, fm, rm = ctx_inputs(torch, gen, b, t, r, e, w, device, edges,
                                 halos)
        rm = rm if with_rm else None
        du = torch.randn(b, t, r, e, generator=gen).to(device)
        dus = {"": du, "_subnormal": du * F16_SUBNORMAL}
        v16 = v32.half()
        got = {"ctx_mix_fwd": K.launch_fwd(v16, fm, w, 0.1, rm)[0]}
        got["ctx_mix_fwd_res"], got["alpha"] = K.launch_fwd(
            v16, fm, w, 0.1, rm, residual=True)
        for tag, d in dus.items():
            got["ctx_mix_bwd" + tag] = K.launch_bwd(v16, fm, w, 0.1, rm, d)
            got["ctx_mix_bwd_res" + tag] = K.launch_bwd(v16, fm, w, 0.1, rm,
                                                        d, got["alpha"])
        torch.cuda.synchronize()
        want = f16_plain(torch, v32, fm, rm, w, dus, torch.float16,
                         got["alpha"])
        ctrl = f16_plain(torch, v32, fm, rm, w, dus, torch.bfloat16)
        case = (f"B={b} T={t} R={r} E={e} w={w} rm={with_rm} edges={edges} "
                f"halos={halos}")
        for key, x in got.items():
            name = key.replace("_subnormal", "")
            if not torch.isfinite(x).all():
                fail(f"phase 20: f16 {key} gave non-finite values: {case}")
            rel, top = f16_gap(torch, x, want[key])
            if rel > F16_REL or top > F16_MAX:
                fail(f"phase 20: f16 {key} differs from its plain version "
                     f"by {rel:.3e} of its norm, {top:.3e} of its largest "
                     f"entry (limits {F16_REL}, {F16_MAX}): {case}")
            crel, _ = f16_gap(torch, ctrl[key], want[key])
            if not torch.equal(ctrl[key].float(), want[key].float()):
                if crel <= F16_REL:
                    fail(f"phase 20: the bf16-rounded {key} is within "
                         f"{crel:.3e} of the f16 plain version: F16_REL does "
                         f"not tell them apart: {case}")
                control[name] = min(control[name], crel)
            w_ = worst[name]
            worst[name] = [max(w_[0], rel), max(w_[1], top), max(
                w_[2], (x.float() - want[key].float()).abs().max().item())]
    gen = torch.Generator().manual_seed(SEED + 24)
    v32, fm, rm = ctx_inputs(torch, gen, 4, 6, 36, 1024, 3, device)
    v16 = v32.half()
    du = torch.randn(4, 6, 36, 1024, generator=gen).to(device)
    runs = [K.launch_fwd(v16, fm, 3, 0.1, rm, residual=True)
            for _ in range(2)]
    dvs = [K.launch_bwd(v16, fm, 3, 0.1, rm, du, a) for _, a in runs
           for a in (a, None)]
    torch.cuda.synchronize()
    if not (torch.equal(runs[0][0], runs[1][0])
            and torch.equal(runs[0][1], runs[1][1])
            and torch.equal(dvs[0], dvs[2]) and torch.equal(dvs[1], dvs[3])):
        fail("phase 20: two launches of an f16 kernel on one input differ")
    log("phase 20 (a): f16 kernels vs plain over "
        f"{len(cases)} cases (du as drawn and x {F16_SUBNORMAL}): "
        + "; ".join(f"{k} ||err||/||want|| {v[0]:.3e}, max |err| / max "
                    f"|want| {v[1]:.3e}, max |err| {v[2]:.3e}"
                    for k, v in worst.items())
        + f" (limits {F16_REL}, {F16_MAX}); the bf16-rounded control's "
        "smallest ||err||/||want||: " + ", ".join(
            f"{k} {v:.3e}" for k, v in control.items())
        + "; two launches of each bitwise equal (R = 36, E = 1024)")
    return {"worst": worst, "control_min_rel": control,
            "cases": len(cases)}


def f16_names(residual: bool) -> dict:
    """F16_TRACE's entries of the context mix's kernels of a step on the
    residual route (K1fr, K1br) or the recompute route (K1f, K1b)."""
    keys = (("ctx_mix_fwd_res", "ctx_mix_bwd_res") if residual
            else ("ctx_mix_fwd", "ctx_mix_bwd"))
    return {k: F16_TRACE[k] for k in keys}


def json_keys(d: dict) -> dict:
    """A traced replay's counts with its tuple names joined by '+'."""
    return {"+".join(k) if isinstance(k, tuple) else k: v
            for k, v in d.items()}


def f16_grads(torch, cfg, batch, kernels: str = "auto",
              phase: str = "phase 20") -> dict:
    """Phase 20 (b) (and 21 (b), kernels="pallas"): one f16 step's
    gradients from the initial state, card (the kernels) against CPU (the
    plain versions at f16) within F16_GRAD_TOL; the card's bf16 step must
    fall outside it."""
    from nafae_torch.train import TrainState

    want = step_grads(torch, cfg, TrainState.create(cfg, device="cpu"),
                      batch, kernels)[1]
    out = {}
    for dt in ("float16", "bfloat16"):
        c = replace(cfg, model=replace(cfg.model, dtype=dt))
        got = step_grads(torch, c, TrainState.create(c, device="cuda"),
                         batch, kernels)[1]
        worst, bad = grad_gap(torch, got, want, F16_GRAD_TOL)
        out[dt] = {"rel_diff": worst, "outside": bad}
    if out["float16"]["outside"]:
        fail(f"{phase}: f16 gradients of {out['float16']['outside']}: card "
             f"and CPU differ by up to {out['float16']['rel_diff']:.3e} of "
             f"the largest entry (limit {F16_GRAD_TOL[1]})")
    if not out["bfloat16"]["outside"]:
        fail(f"{phase}: the card's bf16 step is within {F16_GRAD_TOL[1]} of "
             "the CPU's f16 step: the limit does not tell them apart")
    return out


def check_f16_fits(torch, root: str, tmp: str) -> dict:
    """Phase 20 (b): config-4 `fit` at model.dtype=float16 on the auto
    route: streaming and from the device cache, GRAPH_STEPS steps a step a
    call, refreshing every 3, and, with ALPHA_RESIDUAL
    off, F16_STEPS streaming steps (K1f + K1b). Each captured (two graphs,
    a replay a step), rows and state bit for bit the eager train_step
    chain on the card over the same batches, its launches
    per_step_launches a step, one more replay traced naming the f16
    instantiations of its kernels (F16_TRACE); the first CPU_STEPS rows
    against a CPU re-run (CPU_METRIC_TOL), and one step's gradients
    (f16_grads)."""
    from nafae_torch.ops.kernels import ctx_mix as K

    runs = {"streaming": (graph_cfg(root, os.path.join(tmp, "ck_f16_s"),
                                    "float16", "auto", 1, False), True),
            "cached": (graph_cfg(root, os.path.join(tmp, "ck_f16_c"),
                                 "float16", "auto", 1, True), True),
            "recompute": (train_cfg(root, os.path.join(tmp, "ck_f16_r"),
                                    "float16", F16_STEPS), False)}
    out = {}
    for name, (cfg, residual) in runs.items():
        steps = cfg.train.steps
        K.ALPHA_RESIDUAL = residual
        try:
            zero_counts()                       # main path starts here
            run = traced_fit(torch, cfg)
            counts = read_counts()              # ... and ends here
            per = per_step_launches("auto", residual)
            if counts != {k: n * steps for k, n in per.items()}:
                fail(f"phase 20 fit ({name}) launched {counts}, expected "
                     f"{per} a step")
            st = expect_graphed(run, f"phase 20 fit ({name})", 2, steps)
            prog = run["programs"][0]
            eager = eager_chain(torch, cfg, run["seen"], prog.cache)
            bad = rows_differ(run["logs"], eager["rows"])
            bad += state_diffs(torch, run["state"], eager["state"])
            if bad:
                fail(f"phase 20 fit ({name}) differs from the eager "
                     f"train_step chain in {bad}")
            traced = traced_replay(
                torch, prog, lambda: prog(run["state"], run["seen"][-1]),
                per, os.path.join(tmp, f"f16_replay_{name}.json"),
                f16_names(residual))
        finally:
            K.ALPHA_RESIDUAL = True
        cpu_cfg = replace(cfg, train=replace(
            cfg.train, steps=CPU_STEPS,
            ckpt_dir=os.path.join(tmp, f"ck_f16_cpu_{name}")))
        worst = cpu_rows_agree(run["logs"], run_fit(torch, cpu_cfg, "cpu"),
                               f"phase 20 fit ({name})")
        out[name] = {**st, "launches": counts, "wall_s": run["wall_s"],
                     "traced_replay": json_keys(traced),
                     "cpu_metric_rel_diff": worst,
                     "loss_first_last": [run["logs"][0]["loss"],
                                         run["logs"][-1]["loss"]]}
        log(f"phase 20 (b): f16 fit, {name} ({steps} steps, "
            f"ALPHA_RESIDUAL={residual}): {st['graphs']} graphs, "
            f"{st['replays']} replays, rows and state bit for bit the eager "
            f"chain; launches {counts}; a traced replay names "
            f"{json_keys(traced)}; CPU re-run rows max relative diff "
            f"{worst:.3e} (limit {CPU_METRIC_TOL})")
        del run, eager, prog
        torch.cuda.empty_cache()
    out["grads"] = f16_grads(torch, runs["streaming"][0], first_batch(root))
    log("phase 20 (b): one step's gradients, card against CPU, max |diff| / "
        "largest entry: " + ", ".join(
            f"{k} {v['rel_diff']:.3e}" + (" (outside)" if v["outside"] else "")
            for k, v in out["grads"].items())
        + f" (limit {F16_GRAD_TOL[1]} x largest entry)")
    return out


def check_f16_serving(torch, params, segs, tmp: str) -> dict:
    """Phase 20 (c): a config4 GroundingServer at model.dtype=float16
    (graphed) serves `segs` bit for bit as the f32 server does, K1f
    launched as often (f32 K1f: serving computes in f32 at float16, as the
    reference's serve.py does); its exported artifact, loaded here,
    answers the first batch bit for bit as the f32 server, K1f once."""
    from nafae_torch.ops.kernels import ctx_mix as K
    from nafae_torch.serve import (GroundingServer, export_grounding,
                                   load_exported)

    got, counts = {}, {}
    for dt in ("float32", "float16"):
        srv = GroundingServer(serve_cfg(dt, ""), params, device="cuda")
        zero_counts()                           # serving starts here
        got[dt] = srv.ground_segments(segs)
        counts[dt] = read_counts()              # ... and ends here
        if dt == "float32":
            batch = serving_batch(srv, segs)
            live = srv.run_batch(batch)
        del srv
    if got["float16"] != got["float32"]:
        fail("phase 20: the float16 server's answers differ from the f32 "
             "server's")
    if counts["float16"] != counts["float32"] or \
            counts["float16"]["ctx_mix_fwd"] == 0:
        fail(f"phase 20: the float16 server launched {counts['float16']}, "
             f"the f32 one {counts['float32']}")
    d = os.path.join(tmp, "artifact_f16")
    export_grounding(serve_cfg("float16", ""), params, d)
    call, manifest = load_exported(d)
    K.launches["ctx_mix_fwd"] = 0               # the artifact's run starts
    res = {k: v.cpu().numpy() for k, v in call(
        *[batch[k] for k in ARG_KEYS]).items()}
    launches = K.launches["ctx_mix_fwd"]        # ... and ends here
    if manifest["model"]["dtype"] != "float16" or set(res) != set(live) or \
            not all(np.array_equal(res[k], live[k]) for k in live) or \
            launches != 1:
        fail(f"phase 20: the float16 artifact (manifest dtype "
             f"{manifest['model']['dtype']}, K1f {launches}) differs from "
             "the f32 server")
    log(f"phase 20 (c): float16 server ({len(segs)} segments) bit for bit "
        f"the f32 server's answers, launches {counts['float16']} as f32's; "
        "its exported artifact bit for bit the f32 server's batch, K1f once")
    return {"segments": len(segs), "launches": counts["float16"],
            "artifact_launches": launches}


def f16_kernel_times(torch) -> dict:
    """Phase 20 (e): device ms (device_ms) of K1f, K1fr, K1b and K1br at
    F16_TIMED on ctx_inputs' random masks, bf16 and f16 in turns (bf16,
    f16, f16, bf16; medians of each pair), each f16 time beside its bound,
    its plain version's (torch.profiler, as any_timings) and, for K1f, the
    SDPA yardstick at f16."""
    from nafae_torch.ops.kernels import ctx_mix as K

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 25)
    out = {}
    for name, (b, t, r, e, w) in F16_TIMED.items():
        v32, fm, rm = ctx_inputs(torch, gen, b, t, r, e, w, dev)
        du = torch.randn(b, t, r, e, generator=gen).to(dev)
        vs = {"bf16": v32.to(torch.bfloat16), "f16": v32.half()}
        alphas = {k: K.launch_fwd(v, fm, w, 0.1, rm, residual=True)[1]
                  for k, v in vs.items()}
        fns = {key: {k: f(v, alphas[k]) for k, v in vs.items()}
               for key, f in (
                   ("fwd", lambda v, a: lambda: K.launch_fwd(v, fm, w, 0.1,
                                                             rm)),
                   ("fwd_res", lambda v, a: lambda: K.launch_fwd(
                       v, fm, w, 0.1, rm, residual=True)),
                   ("bwd", lambda v, a: lambda: K.launch_bwd(v, fm, w, 0.1,
                                                             rm, du)),
                   ("bwd_res", lambda v, a: lambda: K.launch_bwd(
                       v, fm, w, 0.1, rm, du, a)))}
        res = out[name] = {"shapes": {"B": b, "T": t, "R": r, "E": e,
                                      "w": w}}
        for key, by in fns.items():
            ms = {k: [] for k in by}
            for k in ("bf16", "f16", "f16", "bf16"):
                ms[k].append(device_ms(torch, by[k]))
            for k, v in ms.items():
                res[f"{key}_ms_{k}"] = statistics.mean(v)
                res[f"{key}_ms_{k}_runs"] = v
        v = vs["f16"]
        for key, bnd in (("fwd", fwd_bound_ms(torch, v, fm, rm, w)),
                         ("fwd_res", fwd_bound_ms(torch, v, fm, rm, w, True)),
                         ("bwd", bwd_bound_ms(torch, v, fm, rm, w, False)),
                         ("bwd_res", bwd_bound_ms(torch, v, fm, rm, w,
                                                  True))):
            res[key + "_bound_ms_f16"], res[key + "_bound_by_f16"] = bnd
        with torch.no_grad():
            res["plain_fwd_ms_f16"] = profile_forward(
                torch, lambda: K.context_mix_plain(v32, fm, w, 0.1,
                                                   dtype=torch.float16,
                                                   rm_ext=rm))[1]
        vp = v32.detach().clone().requires_grad_()
        res["plain_fwd_res_ms_f16"] = profile_forward(
            torch, lambda: K.context_mix_plain(vp, fm, w, 0.1,
                                               dtype=torch.float16,
                                               rm_ext=rm))[1]
        up, _ = K.context_mix_plain(vp, fm, w, 0.1, dtype=torch.float16,
                                    rm_ext=rm)
        res["plain_bwd_ms_f16"] = profile_forward(
            torch, lambda: torch.autograd.grad(up, vp, du,
                                               retain_graph=True))[1]
        del up, vp
        res["library_fwd_ms_f16"] = device_ms(
            torch, lambda: sdpa_mix(torch, v, fm, rm, w, 0.1))
        with torch.no_grad():
            want, _ = K.context_mix_plain(v, fm, w, 0.1, rm_ext=rm)
            res["library_fwd_err_f16"] = (sdpa_mix(torch, v, fm, rm, w, 0.1)
                                          - want).abs().max().item()
        torch.cuda.empty_cache()
    card = card_line()
    for name, res in out.items():
        log(f"phase 20 (e): context mix at {res['shapes']} (device ms, bf16 "
            "-> f16; f16 bound; f16 plain): " + "; ".join(
                f"{k} {res[key + '_ms_bf16']:.4f} -> "
                f"{res[key + '_ms_f16']:.4f} ({res[key + '_bound_ms_f16']:.4f}"
                f", {res[key + '_bound_by_f16']}; "
                f"{res['plain_' + pk + '_ms_f16']:.4f})"
                for k, key, pk in (("K1f", "fwd", "fwd"),
                                   ("K1fr", "fwd_res", "fwd_res"),
                                   ("K1b", "bwd", "bwd"),
                                   ("K1br", "bwd_res", "bwd")))
            + f"; K1f's SDPA yardstick at f16 {res['library_fwd_ms_f16']:.4f}"
            f" (max |err| vs plain {res['library_fwd_err_f16']:.3e}) — "
            f"{card}")
    return out


def f16_step_times(torch, root: str) -> dict:
    """Phase 20 (e): the config-4 auto step from the device cache, graphed,
    at model.dtype float32, bfloat16 and float16 (prec_step_times: host to
    host in interleaved rounds, then busy and idle from torch.profiler)."""
    idx_cache, idxs = prec_cache(torch, root, 20)
    cfgs = {dt: cache_cfg(root, "", "auto", ["train.steps=1000",
                                             f"model.dtype={dt}"])
            for dt in F16_DTYPES}
    progs, states = prec_programs(torch, cfgs, idx_cache)
    out = prec_step_times(torch, progs, states, idxs, F16_DTYPES)
    log("phase 20 (e): config4 auto step from the cache, graphed, host to "
        "host median (device busy; idle share): " + "; ".join(
            f"{dt} {v['host_ms']:.4f} ms ({v['device_busy_ms']:.4f} ms; "
            f"{100 * v['idle_share']:.1f}%)" for dt, v in out.items())
        + f" — {card_line()}")
    return {dt: {k: v for k, v in r.items() if k != "kernels"}
            for dt, r in out.items()}


def check_f16(torch, tmp: str) -> dict:
    """Phase 20: model.dtype=float16 on the card. (a) check_f16_kernels;
    (b) check_f16_fits on phase 5's data; (c) check_f16_serving on the
    serving phase's requests made again under tmp; (e) f16_kernel_times
    and f16_step_times ((d), the refusals at float16, went when phase 21
    took those settings on)."""
    t0 = time.perf_counter()
    kernels = check_f16_kernels(torch, torch.device("cuda"))
    fits = check_f16_fits(torch, tmp, tmp)
    segs, _ = make_requests(os.path.join(tmp, "f16_reqs"))
    serving = check_f16_serving(torch, oracle_params(), segs, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    times = f16_kernel_times(torch)
    steps = f16_step_times(torch, tmp)
    wall = time.perf_counter() - t0
    log(f"phase 20 took {wall:.1f} s")
    return {"kernels": kernels, "fits": fits, "serving": serving,
            "times": times, "step_times": steps, "phase_s": wall}


def f16_child(tmp: str) -> None:
    """`python3 chip_smoke.py --f16-child TMP`: phase 20 (check_f16) in a
    process of its own (its traces whole, as phase 17's), on phase 5's
    data in TMP; writes its results to TMP/F16_RESULT."""
    import torch

    from nafae_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        fail("no CUDA device")
    _build.build_all(SOURCES)
    out = check_f16(torch, tmp)
    with open(os.path.join(tmp, F16_RESULT), "w") as f:
        json.dump(out, f, default=float)


def f16_keys(f16p: dict, name: str, key: str, pkey: str,
             fit: str | None) -> dict:
    """A context-mix kernel's phase-20 numbers for its JSON entry: its f16
    launches a step in the phase-20 fit that runs it, its max |error|
    against plain at f16, and at each shape of F16_TIMED its f16 device ms
    (beside bf16's, timed in turns), bound and plain ms (K1f also its SDPA
    yardstick's ms at f16)."""
    k = f16p["kernels"]["worst"]
    out = {"max_abs_err_f16": k[name][2],
           "max_rel_err_f16": k[name][0],
           "launches_f16": (f16p["fits"][fit]["launches"][name]
                            if fit else None)}
    for shape, res in f16p["times"].items():
        out[f"f16_{shape}"] = {
            "shapes": res["shapes"], "ms_f16": res[key + "_ms_f16"],
            "ms_bf16": res[key + "_ms_bf16"],
            "bound_ms_f16": res[key + "_bound_ms_f16"],
            "bound_by_f16": res[key + "_bound_by_f16"],
            "plain_ms_f16": res["plain_" + pkey + "_ms_f16"],
            **({"library_ms_f16": res["library_fwd_ms_f16"]}
               if key == "fwd" else {})}
    return out


# ---------------- phase 21: the fused route and the detector at float16

# K3, K4f, K4b and K5 on f16 tensors against their plain versions at f16.
# Both round where the TPU kernels round (K4f's ctx terms and centers, K4b's
# dctx, ds and df, K5's weights; f16 products are exact in f32), so they
# differ by the order of the f32 sums and, in ctx, a term that rounds the
# other way: ||got - want|| / ||want|| within F16B_REL (F16B_REL_CTX for
# ctx) and max |got - want| within F16B_MAX of max |want| (K3's a over
# frames with a valid region; clu and f where r* and c* are clear of ties).
# The bf16-rounded control, the plain versions at bf16 on the same inputs,
# must exceed that limit wherever it differs from the f16 ones (on an
# H100 its smallest was 1.37e-4, clu's, and ctx's 1.06e-3, where the
# kernel's ctx came within 2.8e-5: a term of a frame with few regions may
# round the other way); a value read as another type's bits, or an f16
# subnormal flushed to zero, lands far past them.
F16B_REL = 2e-5
F16B_REL_CTX = 1e-4
F16B_MAX = 1e-3
# K4b's dctx at the config-4 step's own scale: ctx_weight · wm / Σ(m3 ·
# rsum) over up to B·K·T·R = 51,200 terms, about 2e-5, so that 2·dctx·d
# lies below f16's smallest normal (6.1e-5), where bf16 keeps it normal
F16B_STEP_DCTX = 2e-5
# phase 21's K3 cases: phase 3's edge cases, phase 17's (R = 36 / E =
# 1024, E = 50 and the general variant's edges), config 4 at K = 40 (M =
# 640 words) and the DP ranks' shapes (I = 8 and 4 videos against M = 128)
F16B_CROSS_CASES = (CROSS_CASES + CROSS_ANY_CASES
                    + [(16, 640, 20, 20, 256, True, (), False),
                       (8, 128, 20, 20, 256, True, (), False),
                       (4, 128, 20, 20, 256, True, (), False)])
# ... and K4f / K4b's: phase 3's, phase 17's and config 4 at K = 40
F16B_DIAG_CASES = (DIAG_CASES + DIAG_ANY_CASES
                   + [(16, 40, 20, 20, 256, 67, True, (), (), False)])
F16B_KEYS = ("a", "ctx", "clu", "f", "d", "dw", "dv", "dw_step", "dv_step",
             "roi_align")


def f16b_hold(torch, key, got, want, ctrl, case, res) -> None:
    """One output of a phase-21 kernel against its plain version at f16
    (F16B_REL, F16B_MAX) and the bf16-rounded control `ctrl` outside
    F16B_REL wherever it differs; the worst gaps go to res."""
    if not torch.isfinite(got).all():
        fail(f"phase 21: f16 {key} gave non-finite values: {case}")
    if got.numel() == 0:
        return
    lim = F16B_REL_CTX if key == "ctx" else F16B_REL
    rel, top = f16_gap(torch, got, want)
    if rel > lim or top > F16B_MAX:
        fail(f"phase 21: f16 {key} differs from its plain version by "
             f"{rel:.3e} of its norm, {top:.3e} of its largest entry "
             f"(limits {lim}, {F16B_MAX}): {case}")
    w_ = res["worst"].setdefault(key, [0.0, 0.0, 0.0])
    res["worst"][key] = [max(w_[0], rel), max(w_[1], top), max(
        w_[2], (got.float() - want.float()).abs().max().item())]
    if ctrl is not None and not torch.equal(ctrl.float(), want.float()):
        crel = f16_gap(torch, ctrl, want)[0]
        if crel <= lim:
            fail(f"phase 21: the bf16-rounded {key} is within {crel:.3e} of "
                 f"the f16 plain version: the limit {lim} does not tell "
                 f"them apart: {case}")
        res["control_min_rel"][key] = min(
            res["control_min_rel"].get(key, float("inf")), crel)


def twice(torch, fn, case: str):
    """fn() launched twice: the two results must be equal bit for bit."""
    one, two = fn(), fn()
    torch.cuda.synchronize()
    one_t = one if isinstance(one, tuple) else (one,)
    two_t = two if isinstance(two, tuple) else (two,)
    if not all(torch.equal(x, y) for x, y in zip(one_t, two_t)):
        fail(f"phase 21: two launches on one input differ: {case}")
    return one


def check_f16_cross(torch, device, res: dict) -> None:
    """Phase 21 (a): K3 on f16 operands at F16B_CROSS_CASES against
    cross_mil_plain at f16 (a over frames with a valid region; the -1e9 of
    all-masked frames and the 0 of invalid ones equal), idx equal where the
    top two scores are clear of ties, exact ties to the first region."""
    from nafae_torch.ops.kernels import cross_mil as K3

    gen = torch.Generator().manual_seed(SEED + 26)
    for i, m, t, r, e, with_rm, ties, dead_video in F16B_CROSS_CASES:
        w = unit_rows(torch, gen, m, e)
        v = unit_rows(torch, gen, i, t, r, e)
        fm, rm = frame_region_masks(torch, gen, i, t, r)
        for first, later in ties:
            v[:, :, later] = v[:, :, first]
            rm[:, :, later] = rm[:, :, first]
        if dead_video:
            fm[1] = 0.0
        fm, rm = fm.to(device), rm.to(device) if with_rm else None
        w16, v16 = w.half().to(device), v.half().to(device)
        case = (f"K3 I={i} M={m} T={t} R={r} E={e} rm={with_rm} "
                f"ties={ties} dead_video={dead_video}")
        a, idx = twice(torch, lambda: K3.launch(w16, v16, fm, rm), case)
        ap, idxp = K3.cross_mil_plain(w16, v16, fm, rm)
        ac, _ = K3.cross_mil_plain(w.bfloat16().to(device),
                                   v.bfloat16().to(device), fm, rm)
        live = ap > K3.NEG / 2
        if not torch.equal(a[~live], ap[~live]):
            fail(f"phase 21: f16 cross_mil differs at all-masked frames: "
                 f"{case}")
        f16b_hold(torch, "a", a[live], ap[live], ac[live], case, res)
        s = torch.einsum("me,itre->imtr", w16.float(), v16.float())
        if rm is not None:
            s = torch.where(rm[:, None] > 0, s, K3.NEG)
        clear = clear_of_ties(torch, s)
        if not torch.equal(idx[clear], idxp[clear]):
            fail(f"phase 21: f16 cross_mil idx differs where the top two "
                 f"scores are clear of ties: {case}")
        if any((idx == later).any() for _, later in ties):
            fail(f"phase 21: f16 cross_mil resolved an exact tie to the "
                 f"later region: {case}")
        res["cases"]["cross_mil"] = res["cases"].get("cross_mil", 0) + 1


def check_f16_diag(torch, device, res: dict) -> None:
    """Phase 21 (a): K4f on f16 operands at F16B_DIAG_CASES against
    diag_fwd_plain at f16 (ctx and d everywhere, clu and f where r* and c*
    are clear of ties; r* and c* equal there; exact ties to the first
    index), and K4b on K4f's residuals against diag_bwd_plain at f16 on
    them, with dctx as drawn and at the step's scale (F16B_STEP_DCTX: ds
    an f16 subnormal)."""
    from nafae_torch.ops.grounding import l2_normalize
    from nafae_torch.ops.kernels import diag as K4

    gen = torch.Generator().manual_seed(SEED + 27)
    rnd = K4._rounder(torch.float16)
    for b, k, t, r, e, kc, with_rm, ties_r, ties_c, dead, *off in \
            F16B_DIAG_CASES:
        w = unit_rows(torch, gen, b, k, e)
        v = unit_rows(torch, gen, b, t, r, e)
        u = 0.5 * torch.randn(b, t, r, e, generator=gen)
        centers = unit_rows(torch, gen, kc, e)
        fm, rm = frame_region_masks(torch, gen, b, t, r)
        hc = (torch.rand(b, t, generator=gen) > 0.2).float()
        for first, later in ties_r:
            v[:, :, later] = v[:, :, first]
            rm[:, :, later] = rm[:, :, first]
        for first, later in ties_c:
            centers[later] = centers[first]
        if dead:
            fm[1] = 0.0
        if off and off[0]:
            hc[:, 1::2] = 0.0
        dctx = torch.rand(b, k, t, generator=gen).to(device)
        dclu = torch.rand(b, k, t, generator=gen).to(device)
        centers, fm, hc = (x.to(device) for x in (centers, fm, hc))
        rm = rm.to(device) if with_rm else None
        x16 = [x.half().to(device) for x in (w, v, u)]
        xbf = [x.bfloat16().to(device) for x in (w, v, u)]
        case = (f"K4 B={b} K={k} T={t} R={r} E={e} Kc={kc} rm={with_rm} "
                f"ties={ties_r}/{ties_c} dead_video={dead}"
                + (" half without context" if off and off[0] else ""))
        got = twice(torch, lambda: K4.launch_fwd(*x16, centers, fm, hc, rm),
                    case)
        want = K4.diag_fwd_plain(*x16, centers, fm, hc, rm)
        ctrl = K4.diag_fwd_plain(*xbf, centers, fm, hc, rm)
        ctx, clu, f, d, rstar, cstar = got
        s = torch.einsum("bke,btre->bktr", x16[0].float(), x16[1].float())
        if rm is not None:
            s = torch.where(rm[:, None] > 0, s, K4.NEG)
        clear_r = clear_of_ties(torch, s)
        both = clear_r & clear_of_ties(torch, torch.einsum(
            "btke,ce->bktc", want[2], rnd(l2_normalize(centers))))
        if not torch.equal(rstar[clear_r], want[4][clear_r]) or \
                not torch.equal(cstar[both], want[5][both]):
            fail(f"phase 21: f16 diag_epilogue r* or c* differ from the "
                 f"plain version where clear of ties: {case}")
        if any((rstar == x).any() for _, x in ties_r) or \
                any((cstar == x).any() for _, x in ties_c):
            fail(f"phase 21: f16 diag_epilogue resolved an exact tie to "
                 f"the later index: {case}")
        pf = [x.permute(0, 2, 1, 3) for x in (f, want[2], ctrl[2])]
        f16b_hold(torch, "ctx", ctx, want[0], ctrl[0], case, res)
        f16b_hold(torch, "d", d, want[3], ctrl[3], case, res)
        f16b_hold(torch, "clu", clu[both], want[1][both], ctrl[1][both],
                  case, res)
        f16b_hold(torch, "f", pf[0][both], pf[1][both], pf[2][both], case,
                  res)
        for tag, dc in (("", dctx), ("_step", dctx * F16B_STEP_DCTX)):
            args = (centers, d, rstar, cstar, f, dc, dclu)
            dw, dv = twice(torch, lambda: K4.launch_bwd(*x16[:2], *args),
                           case + " K4b" + tag)
            pdw, pdv = K4.diag_bwd_plain(*x16[:2], *args)
            cdw, cdv = K4.diag_bwd_plain(*xbf[:2], *args)
            f16b_hold(torch, "dw" + tag, dw, pdw, cdw, case, res)
            f16b_hold(torch, "dv" + tag, dv, pdv, cdv, case, res)
        res["cases"]["diag"] = res["cases"].get("diag", 0) + 1


def check_f16_roi(torch, feat, boxes, res: dict) -> None:
    """Phase 21 (c): K5 on f16 features against roi_align_plain at f16:
    the f16 detector's own map of phase 9's first batch with its NMS
    boxes, then phase 9's edge cases; the control the plain version on
    the same features in bf16."""
    from nafae_torch.ops.kernels import roi_align as K5

    gen = torch.Generator().manual_seed(SEED + 7)
    cases = [("config5 f16 detector", feat, boxes, 1 / 16, 2)]
    cases += [(n, f.cuda(), b.cuda(), s, sr)
              for n, f, b, s, sr in roi_edge_cases(torch, gen)]
    for name, f, b, scale, sr in cases:
        f16 = f.half().contiguous()
        got = twice(torch, lambda: K5.launch(f16, b, scale, sr), name)
        want = K5.roi_align_plain(f16, b, 7, scale, sr)
        ctrl = K5.roi_align_plain(f.bfloat16().contiguous(), b, 7, scale,
                                  sr)
        f16b_hold(torch, "roi_align", got, want, ctrl, "K5 " + name, res)
        res["cases"]["roi_align"] = res["cases"].get("roi_align", 0) + 1


def f16b_log(res: dict, what: str) -> None:
    log(f"phase 21 ({what}): f16 kernels vs plain at f16 over "
        f"{res['cases']} cases: " + "; ".join(
            f"{k} ||err||/||want|| {v[0]:.3e}, max |err| / max |want| "
            f"{v[1]:.3e}, max |err| {v[2]:.3e}"
            for k, v in res["worst"].items())
        + f" (limits {F16B_REL}, ctx {F16B_REL_CTX}, {F16B_MAX}); the "
        "bf16-rounded control's "
        "smallest ||err||/||want||: " + ", ".join(
            f"{k} {v:.3e}" for k, v in res["control_min_rel"].items())
        + "; every launch twice, equal bit for bit; idx, r* and c* equal "
        "where clear of ties")


# a traced replay of an f16 pallas step names the f16 instantiations, and
# no other, of each kernel it launches
F16B_TRACE = {
    **{k: F16_TRACE[k] for k in ("ctx_mix_fwd_res", "ctx_mix_bwd_res")},
    "cross_mil": ("cross_mil_mma", ("cross_mil_mma", "__half")),
    "diag_epilogue": ("diag_centers_kernel", "diag_fwd_kernel",
                      ("diag_centers_kernel", "__half"),
                      ("diag_fwd_kernel", "__half")),
    "diag_epilogue_bwd": ("diag_bwd_kernel", ("diag_bwd_kernel", "__half"))}
# ... and of a config-5 step with an f16 detector, K2 (f32 scores and boxes
# in every detector dtype) and, with roi_impl=pallas, K5 at f16
F16B_C5_TRACE = {"nms": ("nms_kernel",),
                 "roi_align": ("roi_align_kernel",
                               ("roi_align_kernel", "__half"))}
# phase 21's config-5 runs at detector.dtype=float16: name -> (overrides on
# the preset, the VGG16 checkpoint's?); each F16B_C5_STEPS steps graphed
F16B_C5_RUNS = {"resnet_f32_model": (["detector.dtype=float16"], False),
                "resnet_pallas_roi_f16_model": (
                    ["detector.dtype=float16", "detector.roi_impl=pallas",
                     "model.dtype=float16"], False),
                "vgg_pallas_roi_f16_model": (
                    [*VGG_OVERRIDES, "detector.dtype=float16",
                     "detector.roi_impl=pallas", "model.dtype=float16"],
                    True)}
F16B_C5_STEPS = 4
F16B_C5_TRACED = "resnet_pallas_roi_f16_model"
# the config-5 step at f16 on the card against the CPU at C5_CPU's size,
# stage by stage on the card's inputs: with random weights the RPN's
# objectness is nearly flat, and f16's objectness on the two devices
# (1.2e-3 to 1.5e-3 apart on an H100) sends greedy NMS to other boxes in
# every frame, so the whole step is not comparable. f16 rounds every
# layer's output in another order on each device: C4 and the pooled RoIs
# within 4e-3 of the largest entry (1.9e-3 and 1.5e-3 seen), the head on
# the same RoIs within 1e-3 (2.1e-4); the bf16 detector outside each
# (1.2e-2, 1.2e-2, 1.8e-3)
F16B_C5_TOL = {"c4": 4e-3, "pooled": 4e-3, "head": 1e-3}
F16_LIMIT = 65504.0              # the largest finite f16
F16B_INPUT = "f16b_in.json"      # phase 21's inputs, in the run's tmp
F16B_RESULT = "f16b.json"        # ... and its results
EXTRACT_FRAMES = 8               # extract_segments' frames a detector call


def check_f16b_fits(torch, root: str, tmp: str) -> dict:
    """Phase 21 (b): config-4 `fit` with train.kernels=pallas at
    model.dtype=float16, streaming at steps_per_call 3 and from the device
    cache, GRAPH_STEPS steps refreshing every 3: each captured (two
    graphs, a replay a step), rows and state bit for bit the eager
    train_step chain over the same batches, launches per_step_launches a
    step (K3 twice; K4f, K4b, K1fr, K1br once), one more replay traced
    naming the f16 instantiations (F16B_TRACE); the cached run's first
    CPU_STEPS rows against a CPU re-run (CPU_METRIC_TOL); one step's
    gradients card against CPU (F16_GRAD_TOL, the card's bf16 step
    outside). With train.use_pallas=true, the legacy flag, one step takes
    the same route."""
    runs = {"streaming_spc3": graph_cfg(root, os.path.join(
                tmp, "ck_f16b_s"), "float16", "pallas", 3, False),
            "cached": graph_cfg(root, os.path.join(tmp, "ck_f16b_c"),
                                "float16", "pallas", 1, True)}
    per = per_step_launches("pallas")
    out = {}
    for name, cfg in runs.items():
        steps = cfg.train.steps
        zero_counts()                           # main path starts here
        run = traced_fit(torch, cfg)
        counts = read_counts()                  # ... and ends here
        if counts != {k: n * steps for k, n in per.items()}:
            fail(f"phase 21 fit ({name}) launched {counts}, expected {per} "
                 "a step")
        st = expect_graphed(run, f"phase 21 fit ({name})", 2, steps)
        prog = run["programs"][0]
        eager = eager_chain(torch, cfg, run["seen"], prog.cache)
        bad = rows_differ(run["logs"], eager["rows"])
        bad += state_diffs(torch, run["state"], eager["state"])
        if bad:
            fail(f"phase 21 fit ({name}) differs from the eager train_step "
                 f"chain in {bad}")
        traced = traced_replay(
            torch, prog, lambda: prog(run["state"], run["seen"][-1]), per,
            os.path.join(tmp, f"f16b_replay_{name}.json"), F16B_TRACE)
        out[name] = {**st, "launches": counts, "wall_s": run["wall_s"],
                     "traced_replay": json_keys(traced),
                     "loss_first_last": [run["logs"][0]["loss"],
                                         run["logs"][-1]["loss"]]}
        if name == "cached":
            cpu_cfg = replace(cfg, train=replace(
                cfg.train, steps=CPU_STEPS,
                ckpt_dir=os.path.join(tmp, "ck_f16b_cpu")))
            out[name]["cpu_metric_rel_diff"] = cpu_rows_agree(
                run["logs"], run_fit(torch, cpu_cfg, "cpu"),
                f"phase 21 fit ({name})")
        log(f"phase 21 (b): pallas fit at f16, {name} ({steps} steps): "
            f"{st['graphs']} graphs, {st['replays']} replays, rows and state "
            f"bit for bit the eager chain; launches {counts}; a traced "
            f"replay names {json_keys(traced)}"
            + (f"; CPU re-run rows max relative diff "
               f"{out[name]['cpu_metric_rel_diff']:.3e} (limit "
               f"{CPU_METRIC_TOL})" if name == "cached" else ""))
        del run, eager, prog
        torch.cuda.empty_cache()
    legacy = train_cfg(root, os.path.join(tmp, "ck_f16b_u"), "float16", 1,
                       "auto", ["train.use_pallas=true"])
    zero_counts()
    run_fit(torch, legacy)
    if read_counts() != per:
        fail(f"phase 21: train.use_pallas=true at float16 launched "
             f"{read_counts()}, expected {per}")
    out["use_pallas_launches"] = per
    out["grads"] = f16_grads(torch, runs["cached"], first_batch(root),
                             "pallas", "phase 21")
    log("phase 21 (b): one pallas step's gradients, card against CPU, max "
        "|diff| / largest entry: " + ", ".join(
            f"{k} {v['rel_diff']:.3e}" + (" (outside)" if v["outside"] else "")
            for k, v in out["grads"].items())
        + f" (limit {F16_GRAD_TOL[1]} x largest entry); train.use_pallas=true"
        f" at float16 launched {per} in its step")
    return out


def check_f16b_c5(torch, info: dict, tmp: str) -> dict:
    """Phase 21 (d): config-5 `fit` at detector.dtype=float16 at full
    width (640x640, B=16, T=20), one run each of F16B_C5_RUNS, F16B_C5_STEPS
    steps graphed: launches c5_launches a step (K2; K5 with
    roi_impl=pallas), captured (two graphs, a replay a step), the loss
    lowered, rows and state bit for bit the eager train_step chain with
    the same detector; peak device memory; the largest |activation| of
    the backbone's features on the first batch against F16_LIMIT; one
    replay of F16B_C5_TRACED traced (K2, K5 at f16, K1fr and K1br at f16)."""
    ann = info["ann"]
    out = {}
    for run, (extra, vgg) in F16B_C5_RUNS.items():
        more = [*extra, *([f"detector.weights={info['vgg_pth']}"]
                          if vgg else [])]
        cfg = c5_cfg(ann, os.path.join(tmp, f"ck5_f16b_{run}"), "float32",
                     F16B_C5_STEPS, more)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()                           # main path starts here
        fitted = traced_fit(torch, cfg)
        counts = read_counts()                  # ... and ends here
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        peak_reserved = torch.cuda.max_memory_reserved() / 2 ** 30
        per = c5_launches(cfg)
        if counts != {k: n * F16B_C5_STEPS for k, n in per.items()}:
            fail(f"phase 21 config-5 fit ({run}) launched {counts}, "
                 f"expected {per} a step")
        st = expect_graphed(fitted, f"phase 21 config-5 fit ({run})", 2,
                            F16B_C5_STEPS)
        logs = fitted["logs"]
        first = statistics.mean(m["loss"] for m in logs[:2])
        last = statistics.mean(m["loss"] for m in logs[-2:])
        if not all(np.isfinite(v) for m in logs for v in m.values()) or \
                not last < first:
            fail(f"phase 21 config-5 fit ({run}) logged {logs}: not finite, "
                 f"or the loss did not fall ({first} -> {last})")
        prog, seen, state = (fitted["programs"][0], fitted["seen"],
                             fitted["state"])
        final = state_copy(torch, state)
        entry = {**st, "launches": counts, "peak_gib": peak,
                 "peak_reserved_gib": peak_reserved,
                 "wall_s": fitted["wall_s"], "loss_first_last": [
                     logs[0]["loss"], logs[-1]["loss"]]}
        if run == F16B_C5_TRACED:
            names = {**f16_names(True), **F16B_C5_TRACE}
            entry["traced_replay"] = json_keys(traced_replay(
                torch, prog, lambda: prog(state, seen[-1]), per,
                os.path.join(tmp, f"f16b_replay_c5_{run}.json"), names))
        frames = seen[0]["frames"]
        del fitted, prog, state
        torch.cuda.empty_cache()
        det = c5_detector(torch, cfg)
        with torch.no_grad():
            x = torch.from_numpy(frames.reshape((-1,) + frames.shape[2:]))
            feat = torch.cat([det.backbone(x[i:i + 40].cuda()).float()
                              for i in range(0, x.shape[0], 40)])
        entry["feat_abs_max"] = feat.abs().max().item()
        entry["feat_finite"] = bool(torch.isfinite(feat).all())
        del feat
        eager = eager_chain(torch, cfg, seen, extractor=det)
        bad = rows_differ(logs, eager["rows"])
        bad += state_diffs(torch, final, eager["state"])
        if bad:
            fail(f"phase 21 config-5 fit ({run}) differs from the eager "
                 f"train_step chain in {bad}")
        del eager, final, det, seen
        torch.cuda.empty_cache()
        out[run] = entry
        log(f"phase 21 (d): config-5 fit ({run}, {cfg.detector.backbone} "
            f"detector float16, model {cfg.model.dtype}, roi_impl "
            f"{cfg.detector.roi_impl}, B={cfg.data.batch_size}, "
            f"{F16B_C5_STEPS} steps graphed): loss {logs[0]['loss']:.5f} -> "
            f"{logs[-1]['loss']:.5f}; rows and state bit for bit the eager "
            f"chain; launches {counts}; {st['graphs']} graphs, "
            f"{st['replays']} replays; peak device memory {peak:.2f} GiB "
            f"allocated, {peak_reserved:.2f} GiB reserved; the backbone's "
            f"largest |activation| on the first batch "
            f"{entry['feat_abs_max']:.1f} (f16's limit {F16_LIMIT:.0f}; "
            f"finite {entry['feat_finite']})"
            + (f"; a traced replay names {entry['traced_replay']}"
               if run == F16B_C5_TRACED else ""))
    return out


def check_f16b_c5_cpu(torch, info: dict, tmp: str) -> dict:
    """Phase 21 (d): the config-5 step at detector.dtype=float16 and
    model.dtype=float16 (ResNet-50), card against CPU at C5_CPU's size,
    stage by stage on the card's inputs (F16B_C5_TOL): C4, proposals from
    the card's RPN outputs, the pooled RoIs of each device's own C4 at the
    card's boxes, the head on the card's pooled RoIs, the step on the card
    detector's outputs (CPU_METRIC_TOL); the bf16 detector, the control,
    outside each limit. Then VGG16's fc6/fc7 at f16 on random RoIs, card
    against CPU, with and without cuBLAS's reduced-precision f16 sums
    (torch's default allows them; XLA sums f16 products in f32)."""
    from nafae_torch.models.detector.faster_rcnn import STRIDE
    from nafae_torch.models.detector.rpn import select_proposals_batched
    from nafae_torch.models.detector.vgg import VGG16RoIHead
    from nafae_torch.ops import roi_align as RA
    from nafae_torch.train import TrainState, batch_to_device, train_step

    def top(got, want):
        return ((got.float().cpu() - want.float()).abs().max()
                / want.float().abs().max()).item()

    small = [f"detector.image_size={C5_CPU['image']}",
             f"data.batch_size={C5_CPU['batch']}",
             f"data.max_frames={C5_CPU['frames']}"]
    out = {}
    for dt in ("float16", "bfloat16"):
        cfg = c5_cfg(info["ann_small"], os.path.join(tmp, "ck5_f16b_cpu"),
                     "float32", 1, [*small, f"detector.dtype={dt}",
                                    f"model.dtype={dt}"])
        dc = cfg.detector
        batch = c5_first_batch(cfg)
        x = torch.from_numpy(batch["frames"].reshape(
            (-1,) + batch["frames"].shape[2:]))
        det = {d: c5_detector(torch, cfg, d) for d in ("cuda", "cpu")}
        with torch.no_grad():
            c4 = {d: m.backbone(x.to(d)) for d, m in det.items()}
            obj, raw = det["cuda"].rpn(c4["cuda"], raw=True)
            sel = {d: select_proposals_batched(
                obj.to(d), None,
                det[d].anchors(c4[d].shape[1], c4[d].shape[2], d),
                dc.image_size, dc.rpn_pre_nms_topk, dc.num_proposals,
                dc.nms_iou_thresh, nms_impl=impl, topk_impl="none",
                deltas_raw=raw.to(d))
                for d, impl in (("cuda", "pallas"), ("cpu", "jnp"))}
            boxes = sel["cuda"][0]
            pooled = {d: RA.roi_align_matmul(
                c4[d], boxes.to(d), 7, 1.0 / STRIDE).reshape(
                    -1, 7, 7, c4[d].shape[-1]) for d in det}
            head = {d: m.head(pooled["cuda"].to(d)) for d, m in det.items()}
            det_out = det["cuda"](x.cuda())
        gaps = {"c4": top(c4["cuda"], c4["cpu"]),
                "pooled": top(pooled["cuda"], pooled["cpu"]),
                "head": top(head["cuda"], head["cpu"])}
        entry = {"gaps": gaps}
        if dt == "float16":
            box_err = (boxes.cpu() - sel["cpu"][0]).abs().max().item()
            if not torch.equal(sel["cuda"][2].cpu(), sel["cpu"][2]) or \
                    box_err > C5_BOX_TOL:
                fail(f"phase 21: the CPU's proposals from the card's f16 RPN "
                     f"outputs differ (boxes by {box_err} px)")
            off = [k for k, g in gaps.items() if g > F16B_C5_TOL[k]]
            if off:
                fail(f"phase 21: the f16 detector's {off}, card against CPU, "
                     f"lie {gaps} of the largest entry apart (limits "
                     f"{F16B_C5_TOL})")
            b_, t_ = batch["frames"].shape[:2]
            fb = {k: v for k, v in batch.items() if k != "frames"}
            fb["feats"] = det_out["feats"].reshape(
                b_, t_, *det_out["feats"].shape[1:]).cpu().numpy()
            fb["boxes"] = det_out["boxes"].reshape(b_, t_, -1, 4).cpu().numpy()
            fb["region_mask"] = det_out["region_valid"].reshape(
                b_, t_, -1).float().cpu().numpy()
            cfgf = replace(cfg, data=replace(cfg.data, from_videos=False))
            metrics = {}
            for d in ("cuda", "cpu"):
                _, m = train_step(TrainState.create(cfgf, device=d),
                                  batch_to_device(fb, torch.device(d)), cfgf)
                metrics[d] = {k: float(v) for k, v in m.items()}
            rtol, atol = CPU_METRIC_TOL
            bad = [k for k, c in metrics["cpu"].items()
                   if not np.isclose(metrics["cuda"][k], c, rtol=rtol,
                                     atol=atol)]
            if bad:
                fail(f"phase 21: the f16 step on the card detector's outputs,"
                     f" card {metrics['cuda']} against CPU {metrics['cpu']}")
            entry.update(box_abs_diff=box_err, metric_rel_diff=max(
                abs(metrics["cuda"][k] - c) / max(abs(c), 1e-30)
                for k, c in metrics["cpu"].items()))
        elif any(g <= F16B_C5_TOL[k] for k, g in gaps.items()):
            fail(f"phase 21: the bf16 detector, card against CPU, lies "
                 f"within {F16B_C5_TOL} ({gaps}): the limits do not tell "
                 "f16 from bf16")
        out[dt] = entry
        del det, c4, pooled, head, det_out
        torch.cuda.empty_cache()
    log(f"phase 21 (d): config-5 step at f16 (ResNet-50, {C5_CPU}), card "
        f"against CPU on the card's inputs, largest |diff| / largest entry: "
        f"{out['float16']['gaps']} (limits {F16B_C5_TOL}; the bf16 detector "
        f"{out['bfloat16']['gaps']}); proposals from the card's RPN outputs "
        f"the same (boxes within {out['float16']['box_abs_diff']:.3e} px); "
        f"the step on the card detector's outputs within "
        f"{out['float16']['metric_rel_diff']:.3e} (rtol {CPU_METRIC_TOL[0]})")
    head = VGG16RoIHead(dtype=torch.float16)
    gen = torch.Generator().manual_seed(SEED + 28)
    for fc in (head.Dense_0, head.Dense_1):
        fc.weight.data = torch.randn(fc.weight.shape, generator=gen) * (
            2.0 / fc.weight.shape[1]) ** 0.5
    rois = torch.rand(64, 7, 7, 512, generator=gen)
    flag = torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction
    res = {}
    with torch.no_grad():
        want = head(rois)
        head.cuda()
        try:
            for allow in (True, False):
                torch.backends.cuda.matmul \
                    .allow_fp16_reduced_precision_reduction = allow
                res[f"reduced_{allow}"] = f16_gap(torch, head(rois.cuda()),
                                                  want.cuda())
        finally:
            torch.backends.cuda.matmul \
                .allow_fp16_reduced_precision_reduction = flag
    out["vgg_fc"] = res
    log("phase 21 (d): VGG16's fc6/fc7 at f16 on 64 random RoIs, card "
        "against CPU (||diff|| / ||CPU||, max |diff| / max |CPU|), cuBLAS's "
        "reduced-precision f16 sums allowed or not: " + "; ".join(
            f"{k} {v[0]:.3e}, {v[1]:.3e}" for k, v in res.items()))
    return out


def check_f16b_extract(torch, info: dict, tmp: str) -> dict:
    """Phase 21 (d): `python -m nafae_torch.extract --override
    detector.dtype=float16` on one segment of phase 9's videos, as a user
    runs it: its boxes and f16 feats equal the inline f16 detector's (the
    same seeded weights) on the same frames, fed as extract_segments feeds
    them (EXTRACT_FRAMES a call, the last call zero-padded), at f16
    rounding. An f16 detector's objectness is nearly flat at random
    weights, so another frame count a call (other convolution kernels,
    other f16 roundings) sends greedy NMS to other boxes."""
    from nafae_torch.extract import decode_segment

    with open(info["ann"]) as f:
        first = f.readline()
    ann1 = os.path.join(tmp, "f16b_extract.jsonl")
    with open(ann1, "w") as f:
        f.write(first)
    meta = json.loads(first)
    out_dir = os.path.join(tmp, "f16bx", "train")
    cmd = [sys.executable, "-m", "nafae_torch.extract", "--annotations", ann1,
           "--out", out_dir, "--override", "detector.dtype=float16"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        fail(f"extract CLI at float16 failed ({run.returncode}): "
             f"{run.stderr[-2000:]}")
    cfg = c5_cfg(info["ann"], os.path.join(tmp, "ck5_f16bx"), "float32", 1,
                 ["detector.dtype=float16"])
    with np.load(os.path.join(out_dir, meta["id"] + ".npz")) as z:
        got, got_boxes = z["feats"].astype(np.float32), z["boxes"]
    frames = decode_segment(meta["video"], cfg.detector.frame_rate,
                            cfg.data.max_frames, cfg.detector.image_size)
    det = c5_detector(torch, cfg)
    n, fb = frames.shape[0], EXTRACT_FRAMES
    padded = np.zeros((-(-n // fb) * fb,) + frames.shape[1:], np.float32)
    padded[:n] = frames
    with torch.no_grad():
        outs = [det(torch.from_numpy(padded[lo:lo + fb]).cuda())
                for lo in range(0, n, fb)]
    want = torch.cat([o["feats"] for o in outs])[:n].float().cpu().numpy()
    boxes = torch.cat([o["boxes"] for o in outs])[:n].cpu().numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max()) / scale
    box_err = float(np.abs(got_boxes - boxes).max())
    if got.shape != want.shape or box_err > C5_BOX_TOL or not np.allclose(
            got, want, rtol=2 ** -10, atol=1e-6 * scale):
        fail(f"the f16 extract CLI's feats {got.shape} differ from the "
             f"inline f16 detector's {want.shape} beyond f16 rounding: {err} "
             f"of the largest entry (boxes {box_err} px apart)")
    log(f"phase 21 (d): extract CLI at detector.dtype=float16, one segment "
        f"({frames.shape[0]} frames) in {wall:.1f} s incl. start-up: boxes "
        f"within {box_err:.3e} px and feats equal the inline f16 detector's "
        f"({EXTRACT_FRAMES} frames a call) at f16 rounding (max |diff| / "
        f"largest {err:.3e})")
    return {"frames": int(frames.shape[0]), "wall_s": wall,
            "max_rel_diff": err, "box_abs_diff": box_err}


def f16b_kernel_times(torch, root: str, tmp: str, feat, boxes) -> dict:
    """Phase 21 (e): device ms (device_ms) of K3, K4f and K4b on the first
    config-4 training batch's fused-route inputs (fused_inputs) and of K5
    on the f16 detector's first config-5 batch (its map and NMS boxes),
    bf16 and f16 through one path in turns (bf16, f16, f16, bf16; means of
    each pair); each f16 time beside its bound (bf16's: the same bytes and
    tensor-core rate), its plain version's at f16 and, for K3, torch.matmul
    + torch.max at f16."""
    from nafae_torch.ops.kernels import cross_mil as K3
    from nafae_torch.ops.kernels import diag as K4
    from nafae_torch.ops.kernels import roi_align as K5

    w_emb, v_emb, u, centers, fm, rm, hc = fused_inputs(torch, root, tmp)
    b, t, r, e = v_emb.shape
    k = w_emb.shape[1]
    m = b * k
    gen = torch.Generator().manual_seed(SEED + 29)
    dctx = torch.rand((b, k, t), generator=gen).cuda()
    dclu = torch.rand((b, k, t), generator=gen).cuda()
    dts = {"bf16": torch.bfloat16, "f16": torch.float16}
    ins = {}
    for tag, dt in dts.items():
        wf = w_emb.reshape(m, e).to(dt).contiguous()
        wk, v, uu = w_emb.to(dt), v_emb.to(dt), u.to(dt)
        fwd = K4.launch_fwd(wk, v, uu, centers, fm, hc, rm)
        ins[tag] = (wf, wk, v, uu, fwd, feat.to(dt).contiguous())
    torch.cuda.synchronize()
    fns = {
        "cross_mil": lambda x: lambda: K3.launch(x[0], x[2], fm, rm),
        "diag_epilogue": lambda x: lambda: K4.launch_fwd(
            x[1], x[2], x[3], centers, fm, hc, rm),
        "diag_epilogue_bwd": lambda x: lambda: K4.launch_bwd(
            x[1], x[2], centers, x[4][3], x[4][4], x[4][5], x[4][2], dctx,
            dclu),
        "roi_align": lambda x: lambda: K5.launch(x[5], boxes, 1 / 16)}
    res = {"shapes": {"B": b, "K": k, "T": t, "R": r, "E": e,
                      "Kc": centers.shape[0], "roi_feat": list(feat.shape),
                      "roi_boxes": list(boxes.shape)}}
    for name, make in fns.items():
        ms = {tag: [] for tag in dts}
        reps = (2, 11) if name == "roi_align" else (10, 21)
        for tag in ("bf16", "f16", "f16", "bf16"):
            ms[tag].append(device_ms(torch, make(ins[tag]), *reps))
        for tag, v in ms.items():
            res[f"{name}_ms_{tag}"] = statistics.mean(v)
            res[f"{name}_ms_{tag}_runs"] = v
    wf, wk, v, uu, fwd, f16map = ins["f16"]
    live = int((rm > 0).sum())
    row = e * v.element_size()
    dw, dv = K4.launch_bwd(wk, v, centers, fwd[3], fwd[4], fwd[5], fwd[2],
                           dctx, dclu)
    res["cross_mil_bound_ms"], res["cross_mil_bound_by"] = bound(
        torch, nbytes(wf, fm, rm) + live * row + 2 * b * m * t * 4,
        2 * m * e * live, v.dtype)
    (res["diag_epilogue_bound_ms"], res["diag_epilogue_bound_by"]), \
        (res["diag_epilogue_bwd_bound_ms"],
         res["diag_epilogue_bwd_bound_by"]) = diag_bounds(
            torch, wk, v, centers, fm, hc, rm, fwd, dctx, dclu, dw, dv)
    res["roi_align_bound_ms"], res["roi_align_bound_by"] = roi_bound_ms(
        torch, f16map, boxes)
    res_args = (wk, v, centers, fwd[3], fwd[4], fwd[5], fwd[2], dctx, dclu)
    res["cross_mil_plain_ms"] = device_ms(
        torch, lambda: K3.cross_mil_plain(wf, v, fm, rm))
    res["diag_epilogue_plain_ms"] = device_ms(
        torch, lambda: K4.diag_fwd_plain(wk, v, uu, centers, fm, hc, rm))
    res["diag_epilogue_bwd_plain_ms"] = device_ms(
        torch, lambda: K4.diag_bwd_plain(*res_args))
    res["roi_align_plain_ms"] = profile_forward(
        torch, lambda: K5.roi_align_plain(f16map, boxes, 7, 1 / 16),
        reps=2)[1]
    v2 = v.reshape(b, t * r, e)
    res["cross_mil_library_ms"] = device_ms(
        torch, lambda: torch.max(torch.matmul(v2, wf.T).reshape(b, t, r, m),
                                 dim=2))
    card = card_line()
    log("phase 21 (e): f16 kernels (device ms, bf16 -> f16 in turns; f16 "
        "bound; f16 plain) on the first config-4 batch's fused inputs "
        f"{res['shapes']}: " + "; ".join(
            f"{n} {res[n + '_ms_bf16']:.4f} -> {res[n + '_ms_f16']:.4f} "
            f"({res[n + '_bound_ms']:.4f}, {res[n + '_bound_by']}; "
            f"{res[n + '_plain_ms']:.4f})" for n in fns)
        + f"; K3's torch.matmul + torch.max at f16 "
        f"{res['cross_mil_library_ms']:.4f} — {card}")
    return res


def f16b_step_times(torch, root: str, info: dict, tmp: str) -> dict:
    """Phase 21 (e): the config-4 pallas step from the device cache,
    graphed, at model.dtype bfloat16 and float16 (prec_step_times: host to
    host in interleaved rounds, then busy and idle from torch.profiler);
    and the config-5 step (ResNet-50, model f32) with a bf16 and an f16
    detector, graphed, on the first batch: host to host (the numpy batch
    in) and on a resident batch in interleaved rounds (bf16, f16, f16,
    bf16), then each step's device busy time and idle share."""
    from nafae_torch.train import (TrainState, batch_to_device,
                                   build_train_fn, make_optimizer)

    dts = ("bfloat16", "float16")
    idx_cache, idxs = prec_cache(torch, root, 20)
    cfgs = {dt: cache_cfg(root, "", "pallas", ["train.steps=1000",
                                               f"model.dtype={dt}"])
            for dt in dts}
    progs, states = prec_programs(torch, cfgs, idx_cache)
    c4 = prec_step_times(torch, progs, states, idxs, dts)
    del progs, states, idx_cache
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg5 = {dt: c5_cfg(info["ann"], "", "float32", 1000,
                       [f"detector.dtype={dt}"]) for dt in dts}
    batch = c5_first_batch(cfg5["float16"])
    tb = batch_to_device(batch, dev)
    progs, states = {}, {}
    for dt, cfg in cfg5.items():
        progs[dt] = build_train_fn(cfg, make_optimizer(cfg), dev,
                                   extractor=c5_detector(torch, cfg))
        states[dt] = TrainState.create(cfg, device=dev)
    res = {dt: {"host": [], "resident": []} for dt in dts}

    def step(dt, b):
        states[dt], m = progs[dt](states[dt], b)
        return m

    for dt in dts:
        step(dt, tb)
    for i in range(GRAPH_C5_ROUNDS):
        for dt in dts + dts[::-1]:
            for kind, b in (("host", batch), ("resident", tb)):
                t0 = time.perf_counter()
                float(step(dt, b)["loss"])
                res[dt][kind].append((time.perf_counter() - t0) * 1e3)
    c5 = {}
    for dt in dts:
        _, busy, ops = profile_forward(torch, lambda: step(dt, tb), reps=2)
        host = statistics.median(res[dt]["host"])
        c5[dt] = {"host_ms": host, "host_ms_all": res[dt]["host"],
                  "resident_ms": statistics.median(res[dt]["resident"]),
                  "device_busy_ms": busy, "device_ops": ops,
                  "idle_share": 1 - busy / host,
                  "program": dict(progs[dt].stats)}
    del progs, states
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    log("phase 21 (e): config4 pallas step from the cache, graphed, host to "
        "host median (device busy; idle share): " + "; ".join(
            f"{dt} {v['host_ms']:.4f} ms ({v['device_busy_ms']:.4f} ms; "
            f"{100 * v['idle_share']:.1f}%)" for dt, v in c4.items())
        + f" — {card}")
    log(f"phase 21 (e): config-5 step (ResNet-50, model f32, B=16 T=20 "
        f"640x640, graphed; {int(batch['frame_mask'].sum())} valid frames), "
        "bf16 and f16 detector in turns: " + "; ".join(
            f"{dt} host to host {v['host_ms']:.2f} ms, resident batch "
            f"{v['resident_ms']:.2f} ms, busy {v['device_busy_ms']:.2f} ms "
            f"in {v['device_ops']:.0f} operations (idle "
            f"{100 * v['idle_share']:.1f}%)" for dt, v in c5.items())
        + f" — {card}")
    return {"config4_pallas": {dt: {k: x for k, x in r.items()
                                    if k != "kernels"}
                               for dt, r in c4.items()},
            "config5": c5}


def check_f16b(torch, tmp: str) -> dict:
    """Phase 21: the fused route and the detector at float16 on the card.
    (a) check_f16_cross, check_f16_diag; (b) check_f16b_fits on phase 5's
    data; (c) check_f16_roi and K2 (nms_vs_plain) on the f16 detector's
    first config-5 batch;
    (d) check_f16b_c5, check_f16b_c5_cpu, check_f16b_extract on phase 9's
    videos (and phase 10's VGG16 checkpoint); (e) f16b_kernel_times,
    f16b_step_times."""
    t0 = time.perf_counter()
    with open(os.path.join(tmp, F16B_INPUT)) as f:
        info = json.load(f)
    dev = torch.device("cuda")
    parts = {}

    def part(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())

    kern = {"worst": {}, "control_min_rel": {}, "cases": {}}
    check_f16_cross(torch, dev, kern)
    check_f16_diag(torch, dev, kern)
    f16b_log(kern, "a")
    part("a")
    fits = check_f16b_fits(torch, tmp, tmp)
    part("b")
    cfg = c5_cfg(info["ann"], "", "float32", 1, ["detector.dtype=float16"])
    frames = torch.from_numpy(c5_first_batch(cfg)["frames"]).cuda()
    planes, scores, feat, boxes = detector_inputs(
        torch, c5_detector(torch, cfg),
        frames.reshape((-1,) + frames.shape[2:]))
    del frames
    roi = {"worst": {}, "control_min_rel": {}, "cases": {}}
    check_f16_roi(torch, feat, boxes, roi)
    f16b_log(roi, "c")
    nms = dict(zip(("max_abs_err", "valid_slots", "continuation_rows"),
                   nms_vs_plain(torch, "config5 f16 detector", *planes,
                                scores, 0.7)))
    log(f"phase 21 (c): K2 on the f16 detector's planes (f32 scores and "
        f"boxes) against its plain version: survivors exactly equal "
        f"({nms})")
    del planes, scores
    torch.cuda.empty_cache()
    part("c")
    c5 = check_f16b_c5(torch, info, tmp)
    c5_cpu = check_f16b_c5_cpu(torch, info, tmp)
    extract = check_f16b_extract(torch, info, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    part("d")
    times = f16b_kernel_times(torch, tmp, tmp, feat, boxes)
    del feat, boxes
    torch.cuda.empty_cache()
    steps = f16b_step_times(torch, tmp, info, tmp)
    part("e")
    wall = time.perf_counter() - t0
    log(f"phase 21 took {wall:.1f} s (" + ", ".join(
        f"({k}) {v:.1f} s" for k, v in parts.items()) + ")")
    return {"kernels": kern, "roi_align": roi, "nms": nms, "fits": fits,
            "config5": c5, "config5_cpu": c5_cpu, "extract": extract,
            "times": times, "step_times": steps, "phase_s": wall,
            "parts_s": parts}


def f16b_child(tmp: str) -> None:
    """`python3 chip_smoke.py --f16b-child TMP`: phase 21 (check_f16b) in
    a process of its own (its traces whole, as phase 17's), on phase 5's
    data and the videos and checkpoint TMP/F16B_INPUT names; writes its
    results to TMP/F16B_RESULT."""
    import torch

    from nafae_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        fail("no CUDA device")
    _build.build_all(SOURCES)
    out = check_f16b(torch, tmp)
    with open(os.path.join(tmp, F16B_RESULT), "w") as f:
        json.dump(out, f, default=float)


def f16b_keys(f16b: dict, name: str) -> dict:
    """K3's, K4f's, K4b's or K5's phase-21 numbers for its JSON entry: its
    f16 launches in the phase-21 run that takes it (the cached pallas fit;
    K5: the config-5 fit with roi_impl=pallas and an f16 model), its
    largest |error| against plain at f16, and its f16 device ms beside
    bf16's (in turns), bound, plain ms (K3 also torch.matmul + torch.max's
    at f16)."""
    outs = {"cross_mil": ("a",), "diag_epilogue": ("ctx", "clu", "f", "d"),
            "diag_epilogue_bwd": ("dw", "dv", "dw_step", "dv_step"),
            "roi_align": ("roi_align",)}[name]
    src = f16b["roi_align" if name == "roi_align" else "kernels"]["worst"]
    launches = (f16b["config5"][F16B_C5_TRACED]["launches"][name]
                if name == "roi_align"
                else f16b["fits"]["cached"]["launches"][name])
    t = f16b["times"]
    return {"max_abs_err_f16": max(src[o][2] for o in outs),
            "max_rel_err_f16": max(src[o][0] for o in outs),
            "launches_f16": launches,
            "f16_times": {"shapes": t["shapes"],
                          "ms_f16": t[name + "_ms_f16"],
                          "ms_bf16": t[name + "_ms_bf16"],
                          "bound_ms_f16": t[name + "_bound_ms"],
                          "bound_by_f16": t[name + "_bound_by"],
                          "plain_ms_f16": t[name + "_plain_ms"],
                          **({"library_ms_f16": t["cross_mil_library_ms"]}
                             if name == "cross_mil" else {})}}


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

        # data parallelism on a world-of-one NCCL mesh and the train CLI's
        # observability (phase 12), on phase 5's data and phase 7's split
        t12 = time.perf_counter()
        from nafae_torch.parallel.mesh import make_mesh, shutdown
        mesh = make_mesh()
        if torch.distributed.get_backend() != "nccl" or mesh.size() != 1:
            fail(f"make_mesh() on one card gave {mesh} on "
                 f"{torch.distributed.get_backend()}")
        dp = check_dp(torch, tmp, tmp, mesh)
        dp_t = dp_timings(torch, tmp, tmp, mesh)
        dp_k3 = check_cross_mil_dp(torch, tmp, tmp)
        clis = check_clis(torch, tmp, tmp, dp, evals)
        t12 = time.perf_counter() - t12

        # frame parallelism on the one card (phase 13; its --multihost CLI
        # run is among check_clis'), on phase 5's data
        t13 = time.perf_counter()
        sp = check_sp(torch, tmp, tmp)
        sp_k = check_sp_kernels(torch, tmp, tmp)
        t13 = time.perf_counter() - t13

        # the device-resident dataset, steps_per_call, the C++ packer and
        # grain (phase 14), on phase 5's data and phase 12's mesh
        t14 = time.perf_counter()
        cached = check_cache(torch, tmp, tmp)
        groups = check_grouping(torch, tmp)
        cache_mesh = check_cache_meshes(torch, tmp, tmp, mesh, cached)
        scale = check_cache_scale(torch, tmp, tmp)
        ct = cache_timings(torch, tmp, tmp)
        ft = fit_timings(torch, tmp, tmp)
        packer = check_packer(torch, tmp)
        grain = check_grain(torch, tmp, tmp)
        t14 = time.perf_counter() - t14

        # the training step as CUDA graphs (phase 15), on phase 5's data,
        # phase 14 (b)'s two buckets and phase 12's mesh
        t15 = time.perf_counter()
        graphs = check_graphs(torch, tmp, tmp)
        g_seeded = check_graph_seeded(torch, tmp, tmp)
        g_buckets = check_graph_buckets(torch, tmp, groups)
        g_bank = check_graph_bank(torch, tmp, tmp)
        g_mesh = check_graph_mesh(torch, tmp, tmp, mesh, graphs.pop("base"))
        g_resume = check_graph_resume(torch, tmp, tmp)
        gt = graph_timings(torch, tmp, tmp)
        t15 = time.perf_counter() - t15
        log(f"phase 15 took {t15:.1f} s")

        # int8 serving, eval, the exported artifact and visualize (main
        # path 7), on the serving phase's requests and val split
        t11 = time.perf_counter()
        q8 = serve_int8(torch, params, segs, gts)
        q8_eval = check_eval_int8(torch, tmp, tmp)
        art = check_export(torch, params, segs, tmp)
        viz = check_visualize(torch, tmp, tmp)
        q8t = int8_timings(torch, params, segs)
        t11 = time.perf_counter() - t11

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
        dp_c5 = check_dp_c5(torch, ann, tmp, mesh, c5)
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
        t10_s = time.perf_counter() - t10
        log(f"phase 9 took {t10 - t5:.1f} s, phase 10 {t10_s:.1f} s")

        # serving, eval, extraction and the config-5 step as graphs (phase
        # 16), on the serving phase's requests and val split and phase 9's
        # videos
        t16 = time.perf_counter()
        g_serve = check_serve_graphs(torch, params, segs)
        g_eval = check_eval_graphs(torch, tmp)
        g_c5 = check_c5_graphs(torch, ann, tmp)
        t16 = time.perf_counter() - t16
        log(f"phase 16 took {t16:.1f} s")

        # the context mix at every shape the reference takes (phase 17),
        # on the serving phase's requests and phase 5's data, and on an
        # R = 36 split written there, in a process of its own
        anyp = run_child(torch, tmp, "--any-child", ANY_RESULT, "phase 17")

        # model.matmul_precision=default against highest (phase 18), on
        # phase 5's data, phase 17's R = 36 split and phase 9's videos, in
        # a process of its own
        with open(os.path.join(tmp, PREC_INPUT), "w") as f:
            json.dump({"ann": ann,
                       "c5_rows": c5["float32"]["logs"][:PREC_C5_STEPS]}, f)
        precp = run_child(torch, tmp, "--precision-child", PREC_RESULT,
                          "phase 18")

        # the JAX package's orbax checkpoint restored, served, evaluated
        # and resumed on the card (phase 19), on data of its own
        orb = check_orbax(torch, tmp)

        # model.dtype=float16 (phase 20), on phase 5's data and the
        # serving phase's requests made again, in a process of its own
        f16p = run_child(torch, tmp, "--f16-child", F16_RESULT, "phase 20")

        # the fused route and the detector at float16 (phase 21), on phase
        # 5's data, phase 9's videos and phase 10's VGG16 checkpoint, in a
        # process of its own
        with open(os.path.join(tmp, F16B_INPUT), "w") as f:
            json.dump({"ann": ann, "ann_small": ann_small,
                       "vgg_pth": vgg_pth}, f)
        f16b = run_child(torch, tmp, "--f16b-child", F16B_RESULT, "phase 21")
    shutdown()
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
    log(f"projection on the first serving batch {q8t['shapes']} (device ms, "
        "CUDA graphs; bound): " + "; ".join(
            f"{n} {q8t['proj_' + n + '_ms']:.4f} (bound "
            f"{q8t['proj_' + n + '_bound_ms']:.4f}, "
            f"{q8t['proj_' + n + '_bound_by']})"
            for n in ("f32", "bf16", "int8", "int8pre"))
        + f"; the bare products: f32 matmul {q8t['matmul_f32_ms']:.4f}, "
        f"torch._int_mm {q8t['int_mm_ms']:.4f} — {card}")
    for name in ("float32", "int8", "int8pre"):
        log(f"serving batch ({name} server, B=16, "
            f"{q8t['batch_bytes_' + name]} bytes): host to host "
            f"{q8t['batch_host_ms_' + name]:.4f} ms, of which the batch's "
            f"copy to the card alone {q8t['batch_h2d_ms_' + name]:.4f} ms; "
            f"device {q8t['batch_device_ms_' + name]:.4f} ms (CUDA graph), "
            f"busy {q8t['batch_device_busy_ms_' + name]:.4f} ms in "
            f"{q8t['batch_device_ops_' + name]:.0f} operations (idle "
            f"{100 * q8t['device_idle_share_host_' + name]:.1f}% of host to "
            f"host); ingest of its 16 segments on the host "
            f"{q8t['ingest_ms_' + name]:.2f} ms — {card}")
        log(f"device time per {name} serving forward by kernel: "
            + "; ".join(f"{us:.1f} us {k}" for k, us in
                        q8t["kernels_by_device_time_" + name]))
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

    for name, what in (
            ("streaming", f"the {ct['batch_bytes']} B numpy batch copied in"),
            ("cached", "the batch gathered from the device cache")):
        c = ct[name]
        log(f"config4 f32 auto step host to host, {name} ({what}): median "
            f"{c['host_ms']:.4f} ms of {TIMED_ROUNDS} interleaved rounds; "
            f"device busy {c['device_busy_ms']:.4f} ms in "
            f"{c['device_ops']:.0f} device operations, idle "
            f"{100 * c['idle_share']:.1f}% of host to host — {card}")
        log(f"device time per {name} step by kernel: " + "; ".join(
            f"{us:.1f} us {k}" for k, us in c["kernels"]))
    log("config4 f32 auto fit host to host, a row a step (B*T / "
        "frames_per_sec, medians of the rows from step 4 of two rounds of "
        f"{FIT_TIMED_STEPS} steps): " + "; ".join(
            f"{w} {ft[w]['ms']:.4f} ms" for w in FIT_WAYS)
        + f" (streaming with the C++ packer, with the Python packer, from "
        f"the device cache) — {card}")
    for dt, p in packer.items():
        log(f"packing a config4 batch (B=16, {dt}, {p['batch_bytes']} B): "
            f"C++ packer {p['native_ms']:.3f} ms, Python "
            f"{p['python_ms']:.3f} ms (medians of {TIMED_ROUNDS} "
            f"interleaved rounds; {p['packs']} C++ packs) — {card}")

    f32, steps = trained["auto"]["float32"]["launches"], TRAIN_STEPS["float32"]
    # phase 13: launches a step on each SP rank (the same on every mesh),
    # and the kernels' times at the 2x2 mesh's rank (0, 1)
    sp_launch = sp_launches("pallas")
    sp_key = {"ctx_mix_fwd_res": "k1fr", "ctx_mix_bwd_res": "k1br",
              "diag_epilogue": "k4f", "diag_epilogue_bwd": "k4b"}
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
            shapes=tm["shapes"], path="serving",
            launches_orbax=orb["serve_launches"]["ctx_mix_fwd"],
            **any_keys(anyp, "ctx_mix_fwd", "fwd", "fwd"),
            # the forward-only route is the custom op
            # nafae::ctx_mix_fwd, also inside the exported program
            custom_op="nafae::ctx_mix_fwd",
            launches_int8={k: v["launches_ctx_mix_fwd"]
                           for k, v in q8.items()},
            launches_artifact={k: v["launches_ctx_mix_fwd"]
                               for k, v in art["kinds"].items()},
            # f16 (phase 20): K1f runs on the recompute route's f16 fit
            **f16_keys(f16p, "ctx_mix_fwd", "fwd", "fwd", "recompute")),
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
            shapes=tt["shapes"], path=path,
            launches_orbax={r: f["launches"][name]
                            for r, f in orb["fits"].items()},
            **any_keys(anyp, name, key, pkey),
            **f16_keys(f16p, name, key, pkey,
                       "streaming" if name.endswith("_res") else "recompute"),
            **({"launches_per_step_sp": sp_launch[name],
                "ms_sp": sp_k[sp_key[name] + "_ms"],
                "plain_ms_sp": sp_k[sp_key[name] + "_plain_ms"],
                "bound_ms_sp": sp_k[sp_key[name] + "_bound_ms"],
                "bound_by_sp": sp_k[sp_key[name] + "_bound_by"],
                "shapes_sp": sp_k["shapes_2x2_w3"]} if name in sp_key
               else {}))
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
                "bf16 output)",
                # each rank's shapes in a 2- and 4-card DP run (phase 12)
                "dp_shapes": dp_k3} if key == "cross_mil" else
               # *_dense: every region live, every frame valid with context
               {n + d: tf[key + "_" + n + d]
                for n in ("ms_dense", "bound_ms_dense", "bound_by_dense")
                for d in ("", "_bf16")}),
            floor_ms=tf[key + "_floor_ms"],
            floor_ms_bf16=tf[key + "_floor_ms_bf16"],
            shapes=tf["shapes"], path="training f32, kernels=pallas",
            launches_orbax=orb["fits"]["pallas"]["launches"][name],
            **fused_any_keys(anyp, key),
            # f16 (phase 21): the pallas fits at model.dtype=float16
            **f16b_keys(f16b, name),
            launches_per_step_sp=sp_launch[name],
            **({"ms_sp": sp_k[sp_key[name] + "_ms"],
                "plain_ms_sp": sp_k[sp_key[name] + "_plain_ms"],
                "bound_ms_sp": sp_k[sp_key[name] + "_bound_ms"],
                "bound_by_sp": sp_k[sp_key[name] + "_bound_by"],
                "shapes_sp": sp_k["shapes_2x2_w3"]} if name in sp_key
               else {}))
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
            shapes_vgg=t10m["shapes"], shapes_vgg_bf16=t10m["shapes_bf16"],
            # f16 (phase 21): config 5 at detector.dtype=float16
            **(f16b_keys(f16b, name) if name == "roi_align" else {
                "max_abs_err_f16": f16b["nms"]["max_abs_err"],
                "launches_f16": f16b["config5"][F16B_C5_TRACED][
                    "launches"][name]}))
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
        "int8": {"serving": q8, "eval": q8_eval, "export": art,
                 "visualize": viz,
                 "times": {k: v for k, v in q8t.items()
                           if not k.startswith("kernels")},
                 "phase_s": t11},
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
            **{f"program_{run}": c5[run]["program"] for run in C5_RUNS},
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
            **{f"program_{run}": r["program"] for run, r in c5v.items()},
            **{f"fit_wall_s_{run}": r["wall_s"] for run, r in c5v.items()},
            "load": vgg_load, "cpu_rerun": c5v_cpu, "extract_eval": c5v_x,
            "phase_s": t10_s},
        "dp": {"fit": {r: {k: v for k, v in d.items() if k != "logs"}
                       for r, d in dp.items()},
               "times": dp_t, "cli": clis,
               "config5": dp_c5, "phase_s": t12},
        "sp": {**sp, "kernels": {k: v for k, v in sp_k.items()
                                 if not k.startswith(("k1_errs", "k4_errs"))},
               "kernel_errs": {k: v for k, v in sp_k.items()
                               if k.startswith(("k1_errs", "k4_errs"))},
               "phase_s": t13},
        "cache": {"fit": {r: {"launches": cached[r]["launches"],
                              "wall_s": cached[r]["wall_s"]}
                          for r in ROUTES},
                  "cpu_rel_diff": cached["cpu"],
                  "cpu_grad_rel_diff": cached["cpu_grad_rel_diff"],
                  "grouping": groups,
                  "meshes": cache_mesh, "scale": scale,
                  "step": {n: {k: v for k, v in ct[n].items()
                               if k != "kernels"}
                           for n in ("streaming", "cached")},
                  "fit_step": ft,
                  "batch_bytes": ct["batch_bytes"], "packer": packer,
                  "grain": grain, "phase_s": t14},
        "graphs": {"fit": graphs["runs"], "seeded": g_seeded,
                   "buckets": g_buckets,
                   "bank": g_bank, "mesh": g_mesh, "resume": g_resume,
                   "times": {k: ({n: x for n, x in v.items()
                                  if n != "kernels"}
                                 if isinstance(v, dict) else v)
                             for k, v in gt.items()},
                   "phase_s": t15},
        "graphs_inference": {
            "serving": g_serve, "eval": g_eval,
            "extract": g_c5.pop("extract"), "config5": g_c5,
            "phase_s": t16},
        "any_shapes": {k: v for k, v in anyp.items()
                       if k not in ("times", "fused_times")},
        "precision": precp,
        "orbax": orb,
        "float16": {k: v for k, v in f16p.items() if k != "times"},
        "float16_fused_detector": {k: v for k, v in f16b.items()
                                   if k != "times"},
        "script_s": time.perf_counter() - t_start,
    }), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--artifact-child":
        artifact_child(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--any-child":
        any_child(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--precision-child":
        precision_child(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--f16-child":
        f16_child(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--f16b-child":
        f16b_child(sys.argv[2])
    else:
        main()
