"""The port's frame parallelism (nafae_torch.parallel.sp; train_step and fit
on a data × frame mesh) on one gloo world of 4 CPU processes, against the
port's single-device step on the whole batch and against the JAX
package's SP step (`build_train_fn(cfg, make_mesh(data, frame,
devices=...[:4]))`, as tests/test_sp.py builds it) on the same numpy
batches and initial state (`state_from_jax`).

The world is spawned once (tests/torch_sp_worker.py, which imports no
JAX) and runs every case of this file in it, each on the mesh it names;
the references are computed here. Held, as tests/test_sp.py holds the
JAX package's SP step: metrics within rtol 3e-4 / atol 1e-5, parameters
within atol 2e-6, centers within atol 1e-5; the reduced gradients within
rtol 1e-4 / atol 1e-6 of the single device's; bf16 within 2e-2 (of JAX's
f32 step: JAX's CPU backend cannot execute bf16 dots), the inline step's
parameters within atol 1e-5 (see INLINE_PARAM_TOL); parameters,
centers, metrics and gradients bit for bit equal across ranks. Steps run
with warmup 0, so the first update moves the parameters. Cases: the
halo exchange (one hop, and a window wider than a shard) and the online
frame softmax (attention and mean pooling) alone, values and gradients;
config-4 steps at (2,2) w=3, (1,4) w=2 and (1,4) w=3, a ragged region
mask, the pallas route, bf16, the bank, k-means++ and an inline config-5
step; fit across the mesh boundary both ways; a collective audit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nafae_tpu.config as jcfg
import nafae_torch.config as tcfg
from nafae_tpu import train as JT
from nafae_tpu.parallel import make_mesh as j_make_mesh
from nafae_torch import train as TT
from nafae_torch.models.grounding import state_from_jax
from nafae_torch.ops import grounding as G
from tests import torch_sp_worker as SW
from tests.test_torch_dp import (CACHE_OV, CACHE_STEPS, INLINE_OV, OV,
                                 _batches, _fit, _same_across_ranks,
                                 _single_device, check_cached_fit)
from tests.test_torch_train import _jax_gumbels

WORLD = 4
METRIC_TOL = dict(rtol=3e-4, atol=1e-5)
PARAM_TOL = dict(rtol=0, atol=2e-6)
# the inline config-5 step's parameters: tests/test_torch_dp.py's bound for
# the same step. After its one Adam step at warmup 0, w_v entries whose
# gradient is near zero differ by up to 1.04e-5 between the port's and
# JAX's single-device steps already, their gradients within GRAD_TOL
INLINE_PARAM_TOL = dict(rtol=0, atol=1e-5)
CENTER_TOL = dict(rtol=0, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# name: (mesh (data, frame), overrides, steps); the config-4 batches of
# tests/test_torch_dp.py (B=8, T=8, R=6, K=3)
STEP_CASES = {
    "w3_2x2": ((2, 2), ["loss.ctx_window=3"], 2),
    "w2_1x4": ((1, 4), ["loss.ctx_window=2"], 2),
    "w3_1x4": ((1, 4), ["loss.ctx_window=3"], 2),     # T_local = 2 < w
    "ragged_2x2": ((2, 2), ["loss.ctx_window=3"], 2),
    "pallas_2x2": ((2, 2), ["train.kernels=pallas"], 2),
    "bf16_2x2": ((2, 2), ["model.dtype=bfloat16"], 2),
    "bank_2x2": ((2, 2), ["loss.kmeans_source=bank", "loss.bank_steps=3"],
                 2),
    "pp_2x2": ((2, 2), ["loss.kmeans_init=plusplus"], 1),
}
SP_INLINE_OV = INLINE_OV + ["data.max_frames=4"]


def _ragged(batches):
    """tests/test_sp.py's holes in the region mask (one region kept)."""
    rng = np.random.RandomState(5)
    out = []
    for b in batches:
        b = dict(b)
        holes = (rng.rand(*b["region_mask"].shape) > 0.3).astype(np.float32)
        holes[:, :, 0] = 1.0
        b["region_mask"] = b["region_mask"] * holes
        out.append(b)
    return out


def _mesh_ov(shape):
    return [f"mesh.data_axis={shape[0]}", f"mesh.frame_axis={shape[1]}"]


def _jax_sp(jc, js, batches, shape, extractor=None):
    mesh = j_make_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])
    fn = JT.build_train_fn(jc, mesh, extractor=extractor,
                           with_frames=extractor is not None)
    state, metrics = jax.tree.map(jnp.asarray, js), []
    for b in batches:
        state, m = fn(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, state), metrics


def _inline():
    """tests/test_torch_dp.py's inline config-5 case at T = 4 frames."""
    from nafae_tpu.models.detector.faster_rcnn import init_detector
    from nafae_torch.models.detector.faster_rcnn import (
        FasterRCNNExtractor, detector_params_from_jax)
    ov = SP_INLINE_OV + _mesh_ov((2, 2))
    jc = jcfg.load_config(preset_name="config5", overrides=ov)
    tc = tcfg.load_config(preset_name="config5", overrides=ov)
    model, det_params = init_detector(jax.random.PRNGKey(1), jc.detector)
    rng = np.random.RandomState(0)
    batch = {
        "frames": rng.rand(4, 4, 64, 64, 3).astype(np.float32),
        "word_ids": rng.randint(0, 67, (4, 3)).astype(np.int32),
        "frame_mask": np.array([[1, 1, 1, 1], [1, 1, 1, 0], [1, 0, 0, 0],
                                [1, 1, 0, 0]], np.float32),
        "word_mask": np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0], [1, 1, 0]],
                              np.float32),
        "segment_id": np.arange(4, dtype=np.int32),
    }
    tdet = FasterRCNNExtractor(tc.detector).eval()
    tdet.load_state_dict(detector_params_from_jax(
        jax.tree.map(np.asarray, det_params)))
    return jc, tc, (model.apply, det_params), tdet, [batch]


def _primitive_cases():
    rng = np.random.RandomState(0)
    cases = {}
    for w in (2, 3):               # T = 8 over 4 shards: T_local = 2
        cases[f"halo_w{w}"] = {
            "kind": "halo", "mesh": (1, WORLD), "window": w,
            "x": rng.randn(3, 8, 5).astype(np.float32),
            "weights": rng.randn(WORLD, 3, 2 + 2 * w, 5).astype(np.float32)}
    for pool in ("attention", "mean"):
        cases[f"scores_{pool}"] = {
            "kind": "scores", "mesh": (1, WORLD), "pool": pool, "temp": 0.5,
            "a": rng.randn(4, 3, 8).astype(np.float32),
            "word_mask": (rng.rand(4, 3) > 0.2).astype(np.float32),
            "frame_mask": (rng.rand(4, 8) > 0.2).astype(np.float32),
            "weights": rng.randn(4).astype(np.float32)}
    cases["axes"] = {"kind": "axes", "mesh": (2, 2)}
    return cases


def _prepare_steps(root):
    cases, refs = {}, {}
    batches = _batches(root, 2)
    jax_f32 = None
    for name, (shape, extra, steps) in STEP_CASES.items():
        ov = OV + [f"data.root={root}"] + _mesh_ov(shape) + extra
        jc = jcfg.load_config(preset_name="config4", overrides=ov)
        tc = tcfg.load_config(preset_name="config4", overrides=ov)
        js = jax.tree.map(np.asarray, JT.TrainState.create(
            jax.random.PRNGKey(0), jc))
        bs = (_ragged(batches) if name.startswith("ragged")
              else batches)[:steps]
        gumbels = (_jax_gumbels(tc.train.seed, tc.loss.num_clusters,
                                8 * 8 * 3) if name.startswith("pp") else None)
        cases[name] = {"kind": "step", "preset": "config4", "overrides": ov,
                       "mesh": shape, "batches": bs, "gumbels": gumbels,
                       "state": state_from_jax(js, "cpu").state_dict()}
        single = _single_device(tc, state_from_jax(js, "cpu"), bs,
                                gumbels=gumbels)
        if name.startswith("bf16"):
            jref = jax_f32
        else:
            jref = _jax_sp(jc, js, bs, shape)
            jax_f32 = jref if name == "w3_2x2" else jax_f32
        refs[name] = {"single": single, "jax": jref, "centers0": js.centers}
    jc, tc, jext, tdet, bs = _inline()
    js = jax.tree.map(np.asarray, JT.TrainState.create(jax.random.PRNGKey(0),
                                                       jc))
    cases["inline_2x2"] = {"kind": "step", "preset": "config5",
                           "overrides": SP_INLINE_OV + _mesh_ov((2, 2)),
                           "mesh": (2, 2), "batches": bs,
                           "state": state_from_jax(js, "cpu").state_dict(),
                           "detector": tdet.state_dict()}
    refs["inline_2x2"] = {
        "single": _single_device(tc, state_from_jax(js, "cpu"), bs,
                                 extractor=tdet),
        "jax": _jax_sp(jc, js, bs, (2, 2), extractor=jext),
        "centers0": js.centers}
    return cases, refs


def _fit_ov(root, ckpt, steps, extra=()):
    return OV + [f"data.root={root}", f"train.ckpt_dir={ckpt}",
                 f"train.steps={steps}", "train.log_every=1",
                 "loss.kmeans_source=bank", "loss.bank_steps=3", *extra]


@pytest.fixture(scope="module")
def world(synth_root, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sp4"))
    cases, refs = _prepare_steps(synth_root)
    cases.update(_primitive_cases())
    # a single-device checkpoint at step 3, resumed under the mesh
    _fit(synth_root, os.path.join(tmp, "fb"), 3)
    mesh = _mesh_ov((2, 2))
    cases.update(
        fit={"kind": "fit", "preset": "config4", "mesh": (2, 2),
             "overrides": _fit_ov(synth_root, os.path.join(tmp, "fa"), 3)
             + mesh},
        fit_resume={"kind": "fit", "preset": "config4", "mesh": (2, 2),
                    "overrides": _fit_ov(synth_root, os.path.join(tmp, "fb"),
                                         5) + mesh},
        fit_cache={"kind": "fit", "preset": "config4", "mesh": (2, 2),
                   "overrides": _fit_ov(synth_root, os.path.join(tmp, "fc"),
                                        CACHE_STEPS, CACHE_OV) + mesh})
    return SW.spawn(WORLD, tmp, cases), refs, tmp


@pytest.mark.parametrize("window", [2, 3])
def test_halo_exchange_matches_padded_concat(world, window):
    """Each of 4 shards of T = 8 gets the window of the zero-padded global
    tensor around its frames (w = 3 > T_local = 2 takes two hops), and
    the gradient of every shard's frames is that of the zero-padded
    concatenation on one process."""
    outs, _, _ = world
    case = _primitive_cases()[f"halo_w{window}"]
    x = torch.from_numpy(case["x"]).requires_grad_()
    xp = torch.nn.functional.pad(x, (0, 0, window, window))
    tl, loss = 2, 0.0
    for f in range(WORLD):
        ext = xp[:, f * tl:f * tl + tl + 2 * window]
        np.testing.assert_array_equal(outs[f][f"halo_w{window}"]["out"],
                                      ext.detach().numpy())
        loss = loss + torch.sum(ext * torch.from_numpy(case["weights"][f]))
    (grad,) = torch.autograd.grad(loss, x)
    got = np.concatenate([outs[f][f"halo_w{window}"]["grad"]
                          for f in range(WORLD)], axis=1)
    np.testing.assert_allclose(got, grad.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pool", ["attention", "mean"])
def test_sp_video_scores_match_video_scores(world, pool):
    """The online frame softmax over 4 shards: S equals video_scores on
    the whole T (the port's and JAX's), on every shard, and the gradient
    of every shard's frames is the single device's."""
    from nafae_tpu.ops.grounding import video_scores as j_video_scores
    outs, _, _ = world
    case = _primitive_cases()[f"scores_{pool}"]
    a = torch.from_numpy(case["a"]).requires_grad_()
    wm, fm = (torch.from_numpy(case[k]) for k in ("word_mask", "frame_mask"))
    s, _ = G.video_scores(a, wm, fm, case["temp"], pool)
    (grad,) = torch.autograd.grad(
        torch.sum(s * torch.from_numpy(case["weights"])), a)
    js, _ = j_video_scores(jnp.asarray(case["a"]), jnp.asarray(wm.numpy()),
                           jnp.asarray(fm.numpy()), case["temp"], pool)
    for o in outs:
        np.testing.assert_allclose(o[f"scores_{pool}"]["s"],
                                   s.detach().numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o[f"scores_{pool}"]["s"], np.asarray(js),
                                   rtol=1e-5, atol=1e-6)
    got = np.concatenate([o[f"scores_{pool}"]["grad"] for o in outs], axis=2)
    np.testing.assert_allclose(got, grad.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("name", [*STEP_CASES, "inline_2x2"])
def test_sp_step_matches_single_device_and_jax(world, name):
    outs, refs, _ = world
    _same_across_ranks(outs, name)
    got = outs[0][name]
    s_state, s_metrics, s_grads = refs[name]["single"]
    j_state, j_metrics = refs[name]["jax"]
    bf16 = name.startswith("bf16")
    ptol = (BF16_TOL if bf16 else INLINE_PARAM_TOL if name == "inline_2x2"
            else PARAM_TOL)
    ctol = BF16_TOL if bf16 else CENTER_TOL
    for k, v in s_state.params.items():
        np.testing.assert_allclose(got["params"][k], v.numpy(), err_msg=k,
                                   **ptol)
        np.testing.assert_allclose(got["params"][k], j_state.params[k],
                                   err_msg=k, **ptol)
    np.testing.assert_allclose(got["centers"], s_state.centers.numpy(),
                               **ctol)
    np.testing.assert_allclose(got["centers"], j_state.centers, **ctol)
    assert len(got["metrics"]) == len(s_metrics) == len(j_metrics)
    mtol = BF16_TOL if bf16 else METRIC_TOL
    for g, s, j in zip(got["metrics"], s_metrics, j_metrics):
        assert set(g) == set(s) == set(j)
        for k in g:
            np.testing.assert_allclose(g[k], s[k], err_msg=k, **mtol)
            np.testing.assert_allclose(g[k], j[k], err_msg=k, **mtol)
    for k, g in s_grads.items():        # the reduced gradient, last step
        if bf16:
            scale = np.abs(g).max()
            np.testing.assert_allclose(got["grads"][k] / scale, g / scale,
                                       err_msg=k, **BF16_TOL)
        else:
            np.testing.assert_allclose(got["grads"][k], g, err_msg=k,
                                       **GRAD_TOL)
    if s_state.bank is not None:        # rank (d, f) holds rows d, frames f
        d, f = STEP_CASES[name][0]
        grid = [[outs[i * f + j][name] for j in range(f)] for i in range(d)]
        for key, want, jwant in (("bank", s_state.bank, j_state.bank),
                                 ("bank_valid", s_state.bank_valid,
                                  j_state.bank_valid)):
            whole = np.concatenate([np.concatenate(
                [o[key] for o in row], 2) for row in grid], 1)
            np.testing.assert_allclose(whole, want.numpy(), **PARAM_TOL)
            np.testing.assert_allclose(whole, jwant, **PARAM_TOL)
    # the refreshes (and the seeding) moved the centers
    assert not np.allclose(got["centers"], refs[name]["centers0"], atol=1e-3)


def test_sp_fit_logs_once_and_resumes_on_one_device(world, synth_root):
    """fit with the bank under a (2,2) mesh: rank 0 alone logs (one
    metrics.jsonl) and checkpoints, its metrics those of the single-device
    fit; its checkpoint, the bank gathered along both axes, resumes on one
    device to the single-device trajectory, and a single-device
    checkpoint resumes under the mesh."""
    from nafae_torch.utils.metrics_log import MetricsLogger
    outs, _, tmp = world
    logs = outs[0]["fit"]["logs"]
    assert all(o["fit"]["logs"] == [] for o in outs[1:])
    assert [m["step"] for m in logs] == [1, 2, 3]
    fa = os.path.join(tmp, "fa")
    assert [r["step"] for r in MetricsLogger(fa).read()] == [1, 2, 3]
    assert sorted(os.listdir(fa)) == ["metrics.jsonl", "state_3.pt"]
    _, single = _fit(synth_root, os.path.join(tmp, "fs"), 3)
    for g, s in zip(logs, single):
        for k in s:
            if k not in ("frames_per_sec", "ts"):
                np.testing.assert_allclose(g[k], s[k], err_msg=k,
                                           **METRIC_TOL)
    whole, _ = _fit(synth_root, os.path.join(tmp, "fs"), 5)
    resumed, _ = _fit(synth_root, fa, 5)
    assert resumed.step == 5
    for k, v in whole.params.items():
        np.testing.assert_allclose(resumed.params[k].numpy(), v.numpy(),
                                   err_msg=k, **PARAM_TOL)
    np.testing.assert_allclose(resumed.bank.numpy(), whole.bank.numpy(),
                               **PARAM_TOL)
    back = outs[0]["fit_resume"]
    assert back["step"] == 5
    for k, v in whole.params.items():
        np.testing.assert_allclose(back["params"][k], v.numpy(), err_msg=k,
                                   **PARAM_TOL)
    np.testing.assert_allclose(back["centers"], whole.centers.numpy(),
                               **CENTER_TOL)


def test_sp_cached_fit_matches_single_device(world, synth_root):
    """train.device_cache on a (2,2) mesh: each rank caches its frame
    shard of feats and masks (half of T) and gathers its rows of every
    global index batch; the run is the single device's."""
    outs, _, tmp = world
    check_cached_fit(outs, synth_root, tmp, [], PARAM_TOL)


def test_sp_halo_bytes_and_no_region_gather(world):
    """The collectives of one (1,4) step at w = 2 (a single hop; B_loc =
    8, T_local = 2, R = 6, E = 32, f32). Each way, an interior shard sends
    in the forward pass w·B_loc·R·E·4 = 12288 bytes of v̂, w·B_loc·4 = 64
    of the frame mask and w·B_loc·R·4 = 384 of the region mask, and in
    the backward pass 12288 bytes of v̂'s cotangent: 2·(12288 + 64 + 384
    + 12288) = 50048 bytes a step, and receives as much; an edge shard
    half of each. No all_gather moves a region tensor (B_loc·T_loc·R·E·4
    = 12288 bytes): only the words and the diagonal cross."""
    outs, _, _ = world
    w, b, r, e = 2, 8, 6, 32
    one_way = 2 * w * b * r * e * 4 + w * b * 4 + w * b * r * 4
    assert one_way == 25024
    for f, o in enumerate(outs):
        recs = o["w2_1x4"]["collectives"][0]
        ways = 1 if f in (0, WORLD - 1) else 2
        for op in ("send", "recv"):
            got = [x for x in recs if x[0] == op]
            assert sum(x[3] for x in got) == ways * one_way, (f, op, got)
            assert len(got) == ways * 4
        gathers = [x for x in recs if x[0] == "all_gather"]
        assert gathers and all(x[3] < b * 2 * r * e * 4 for x in gathers)


def test_axes_group_follows_the_mesh(world):
    """The group over both axes comes from the mesh itself: the world for
    a mesh of every rank, the data axis's group for a frame axis of 1 (an
    init_device_mesh mesh, not make_mesh's), make_mesh's own group for a
    mesh smaller than the world (1x2 on ranks 0-1: 1 + 2 = 3), and a
    ValueError naming make_mesh for a smaller mesh that it did not make."""
    outs, _, _ = world
    for rank, o in enumerate(outs):
        got = o["axes"]
        assert got["world"] and got["frame1"] == WORLD
        assert got["sub"] == ((2, 3.0) if rank < 2 else None)
        assert "make_mesh" in got["bare"]
