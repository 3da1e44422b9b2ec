"""Times this tree's greedy NMS (K2, csrc/nms.cu) and context-mix backward
(K1br and K1b, csrc/ctx_mix_bwd.cu) against other versions of the same
sources, on one card, in one process, on the main path's own inputs:

- K1br / K1b: the first config-4 training batch (B=16, T=20, R=20, E=256,
  w=3), v_ext in f32 and in bf16, du from a seed;
- K2: the first config-5 batch's detector planes (320 rows x 24,000
  anchors, num_keep 20), from the f32 and from the bf16 detector.

    python3 kernel_ab.py DIR [DIR ...]

Each DIR holds another version's nms.cu and ctx_mix_bwd.cu (with the
ctx_mix_common.cuh it includes), for example `git archive <commit>
nafae_torch/csrc` unpacked under the git-ignored build/. Both C interfaces
are taken: the tiered one of this tree and the earlier one (a scratch row
for long NMS rows, a backward without a scratch). Every version is first
held to this tree's output (K2 exactly, K1 within chip_smoke.GRAD_TOL of
its rounding), then timed with CUDA graphs (chip_smoke.device_ms) in the
order others, tree, tree, others reversed. Prints one JSON object as its
last line and writes it to build/kernel_ab.json.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import chip_smoke as CS

ROOT = Path(__file__).resolve().parent


def build(dirs: list[Path]) -> dict[str, dict]:
    """nvcc of each DIR's nms.cu and ctx_mix_bwd.cu into build/kernel_ab/,
    all at once; {DIR name: {source name: loaded library}}."""
    from nafae_torch.ops.kernels import _build

    procs = {}
    for d in dirs:
        out = ROOT / "build" / "kernel_ab" / d.name
        out.mkdir(parents=True, exist_ok=True)
        for n in ("nms", "ctx_mix_bwd"):
            procs[d.name, n] = (out / f"lib{n}.so", subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                 str(out / f"lib{n}.so"), str(d / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {d.name: {} for d in dirs}
    for (d, n), (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            CS.fail(f"nvcc failed on {d}/{n}.cu:\n{log}")
        libs[d][n] = ctypes.CDLL(str(so))
    return libs


def bind(torch, libs: dict):
    """(nms(x1, y1, x2, y2, sc) -> (idx, valid), bwd(v, fm, rm, du, w,
    temp, alpha) -> dv) for one version's libraries, either interface."""
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ln, lb = libs["nms"], libs["ctx_mix_bwd"]
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
        bf = int(v.dtype == torch.bfloat16)
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

    return nms, bwd


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
    from nafae_torch.ops import grounding as TG
    from nafae_torch.ops.kernels import _build, ctx_mix as K1, nms as K2
    from nafae_torch.train import TrainState, batch_to_device

    dirs = [Path(d) for d in sys.argv[1:]]
    CS.log(f"card: {CS.card_line()}")
    _build.build_all(CS.SOURCES)
    others = {name: bind(torch, libs) for name, libs in build(dirs).items()}
    res = {"card": CS.card_line()}
    with tempfile.TemporaryDirectory() as tmp:
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
        for tag, v in (("f32", v32), ("bf16", v32.to(torch.bfloat16))):
            _, alpha = K1.launch_fwd(v, fm, w, temp, rm, residual=True)
            tol = CS.GRAD_TOL["float32" if tag == "f32" else "bfloat16"]
            for kname, a in (("K1br", alpha), ("K1b", None)):
                fns = {"tree": lambda a=a, v=v: K1.launch_bwd(v, fm, w, temp,
                                                               rm, du, a)}
                want = fns["tree"]()
                for name, (_, ob) in others.items():
                    fns[name] = (lambda ob=ob, a=a, v=v:
                                 ob(v, fm, rm, du, w, temp, a))
                    got = fns[name]()
                    if not torch.allclose(got, want, rtol=tol[0],
                                          atol=tol[1]):
                        CS.fail(f"{kname} {tag}: {name} differs from this "
                                "tree")
                entry = {"ms": a_b(torch, fns),
                         "by_kernel_us": CS.profile_forward(
                             torch, fns["tree"], reps=20)[0]}
                res[f"{kname}_{tag}"] = entry
                CS.log(f"{kname} {tag}: {entry}")
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
            for name, (on, _) in others.items():
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
