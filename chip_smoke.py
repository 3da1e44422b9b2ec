#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nafae_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (the kernels are built from `nafae_torch/csrc`
at first use) and nothing else: weights and requests are made from seeds.
Phases, each of which fails loudly (exit code != 0):

1. card: prints the card's name and power limit and torch's CUDA version;
2. build: compiles every kernel source and prints the build time;
3. kernels against their plain PyTorch versions on the card, at the
   serving path's shapes and at edge shapes, in f32 and bf16;
4. serving (the main path): a config4 GroundingServer at full width, with
   planted-signal oracle weights, answers synthetic requests in process
   and over HTTP, in f32 and bf16; the launch counts show that the path
   went through every kernel, box accuracy must clear the planted-signal
   bar, and one batch re-run on the CPU must agree;
5. times from CUDA events (median of repeated runs after warm-up): each
   kernel, its plain version, and one full serving batch.

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
# kernel against plain, rtol and atol: the plain version rounds like the
# kernel (bf16 operands, alpha rounded to bf16, f32 sums), so bf16 differs
# only by the order of the sums and an occasional alpha rounded the other way
CTX_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-3, 1e-4)}


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


# ------------------------------------------------------------- phase 3


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


# ------------------------------------------------------------- phase 4


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


# ------------------------------------------------------------- phase 5


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
    """Device time per forward by kernel name, from torch.profiler (CUPTI):
    ([(name, us per forward)] largest first, total device ms per forward)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per[ev.name] = (per.get(ev.name, 0.0)
                            + ev.time_range.elapsed_us() / reps)
    if not per:
        fail("torch.profiler recorded no device time")
    top = sorted(per.items(), key=lambda kv: -kv[1])
    return [(name[:80], us) for name, us in top[:8]], sum(per.values()) / 1e3


def ctx_bound_ms(torch, v_ext, fm_ext, rm_ext, w) -> tuple[float, str]:
    """Least time for K1f on these inputs: inputs read once and u written
    once, over the memory rate; 4·R·R·E flops for each (video, centre
    frame, offset) with both frames valid (what the kernel computes), over
    the peak rate for the operands' type: f32 CUDA cores for f32, bf16
    tensor cores for bf16."""
    b, t_ext, r, e = v_ext.shape
    t = t_ext - 2 * w
    nbytes = (v_ext.numel() * v_ext.element_size()
              + fm_ext.numel() * 4 + (rm_ext.numel() * 4 if rm_ext is not None
                                      else 0) + b * t * r * e * 4)
    fm_c = fm_ext[:, w:w + t]
    live = sum(int((fm_ext[:, w + o:w + o + t] * fm_c).count_nonzero())
               for o in range(-w, w + 1) if o != 0)
    flops = 4 * r * r * e * live
    peak = (H100_BF16_FLOPS if v_ext.dtype == torch.bfloat16
            else H100_F32_FLOPS)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
                    torch, lambda: K.launch_kernel(v, fm, w, temp, rm_ext))
                res["plain_ms" + tag + dt_tag] = device_ms(
                    torch, lambda: K.context_mix_plain(v, fm, w, temp,
                                                       rm_ext=rm_ext))
                res["bound_ms" + tag + dt_tag], res["bound_by" + tag + dt_tag] \
                    = ctx_bound_ms(torch, v, fm, rm_ext, w)
        res["batch_device_ms"] = device_ms(torch, lambda: srv._fn(
            tb["feats"], tb["boxes"], tb["word_ids"], tb["frame_mask"],
            tb["word_mask"], tb["region_mask"]))
        res["kernels_by_device_time"], res["device_busy_ms"] = profile_forward(
            torch, lambda: srv._fn(tb["feats"], tb["boxes"], tb["word_ids"],
                                   tb["frame_mask"], tb["word_mask"],
                                   tb["region_mask"]))
    K.launches = 0
    srv.run_batch(batch)
    res["launches_per_batch"] = K.launches
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


# -------------------------------------------------------------------- main


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one NVIDIA GPU")
    from nafae_torch.config import load_config
    from nafae_torch.ops.kernels import _build
    from nafae_torch.ops.kernels import ctx_mix as K

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load("ctx_mix")
    log(f"built ctx_mix in {time.perf_counter() - t0:.1f} s")
    usage = [ln.strip() for ln in _build.build_log("ctx_mix").splitlines()
             if "registers" in ln or "spill" in ln]
    log("ctx_mix ptxas: " + " | ".join(usage))

    errs = check_ctx_mix(torch, torch.device("cuda"))

    def cfg_of(dt):
        return load_config(preset_name="config4",
                           overrides=[f"model.dtype={dt}"])

    params = oracle_params()
    with tempfile.TemporaryDirectory() as root:
        segs, gts = make_requests(root)
    K.launches = 0                                  # main path starts here
    served = serve(torch, cfg_of, params, segs, gts)
    launches = K.launches                           # ... and ends here
    log(f"main path: ctx_mix launched {launches} times")
    if launches == 0:
        fail("the serving path never launched the ctx_mix kernel")

    srv32 = served["float32"][0]
    check_cpu_rerun(torch, cfg_of("float32"), params, srv32, segs)

    tm = timings(torch, srv32, segs)
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

    print(json.dumps({"kernels": [{
        "name": "ctx_mix_fwd",
        "route": "cuda",
        "source": "nafae_torch/csrc/ctx_mix.cu",
        "replaces": "nafae_tpu/ops/pallas/fused_ctx.py:157",  # _fwd_kernel
        "launches": launches,
        "launches_per_batch": tm["launches_per_batch"],
        # f32, the default dtype; every *_bf16 key is the same number for
        # bf16 input, every *_dense key with every frame of the batch valid
        "max_abs_err": errs["float32"],
        "max_abs_err_bf16": errs["bfloat16"],
        "ms": tm["ms"],
        "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"],
        "bound_by": tm["bound_by"],
        # no single PyTorch call computes the banded group-softmax mix
        "library_ms": None,
        "ms_bf16": tm["ms_bf16"],
        "plain_ms_bf16": tm["plain_ms_bf16"],
        "bound_ms_bf16": tm["bound_ms_bf16"],
        "bound_by_bf16": tm["bound_by_bf16"],
        "ms_dense": tm["ms_dense"],
        "plain_ms_dense": tm["plain_ms_dense"],
        "bound_ms_dense": tm["bound_ms_dense"],
        "bound_by_dense": tm["bound_by_dense"],
        "ms_dense_bf16": tm["ms_dense_bf16"],
        "plain_ms_dense_bf16": tm["plain_ms_dense_bf16"],
        "bound_ms_dense_bf16": tm["bound_ms_dense_bf16"],
        "bound_by_dense_bf16": tm["bound_by_dense_bf16"],
        "shapes": tm["shapes"],
    }], "serving": {
        "batch_device_ms": tm["batch_device_ms"],
        "batch_host_ms": tm["batch_host_ms"],
        "frames_per_batch": tm["batch_frames"],
        "frames_per_s_device": tm["frames_per_s_device"],
        "frames_per_s_host": tm["frames_per_s_host"],
        "device_busy_ms": tm["device_busy_ms"],
        "device_idle_share_host": 1.0 - tm["device_busy_ms"]
        / tm["batch_host_ms"],
    }}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
