"""The port's data parallelism (nafae_torch.parallel, train_step / fit /
evaluate with a mesh) on gloo worlds of 2 and 4 CPU processes, against
the port's single-device step on the whole batch and against the JAX
package's mesh step (`build_train_fn(cfg, make_mesh(devices=...[:W]))`)
on the same numpy batches and initial state (`state_from_jax`).

Each world is spawned once (tests/torch_dp_worker.py, which imports no
JAX) and runs every case of this file in it; the references are computed
here. Held: parameters within atol 1e-5, metrics within rtol 2e-4 / atol
1e-5 (tests/test_train.py's DP bound), centers within atol 1e-5, the
reduced gradients within rtol 1e-4 / atol 1e-6 of the single device's
(test_torch_train.py's gradient bound), bf16 within 2e-2; parameters,
centers and metrics bit for bit equal across ranks. Steps run with warmup
0, so the first update moves the parameters. Cases: config4 f32 on the
auto and pallas routes, bf16, k-means++ from the batch and from the bank
(JAX's Gumbel draws fed in), the inline config-5 step; then fit (one
metrics.jsonl, checkpoints that resume across the mesh boundary both
ways), eval at batch 5 on 2 ranks (the single device's dict exactly), a
collective audit and the refusals.
"""

import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nafae_tpu.config as jcfg
import nafae_torch.config as tcfg
from nafae_tpu import train as JT
from nafae_tpu.data import BatchLoader, SegmentDataset
from nafae_tpu.parallel import make_mesh as j_make_mesh
from nafae_torch import train as TT
from nafae_torch.models.grounding import state_from_jax
from tests import torch_dp_worker as W
from tests.test_torch_train import _jax_gumbels

OV = ["data.feat_dim=64", "model.feat_dim=64", "model.embed_dim=32",
      "data.batch_size=8", "data.max_frames=8", "data.num_regions=6",
      "data.max_words=3", "loss.num_clusters=8", "loss.kmeans_interval=1",
      "train.warmup_steps=0", "train.log_every=1000",
      "train.ckpt_every=1000000", "train.eval_every=1000000"]
# name: (overrides, steps); bf16 is held against JAX's f32 "auto" step
# (JAX's CPU backend cannot execute bf16 dots)
STEP_CASES = {
    "auto": ([], 2),
    "pallas": (["train.kernels=pallas"], 2),
    "bf16": (["model.dtype=bfloat16"], 2),
    "pp_batch": (["loss.kmeans_init=plusplus"], 1),
    "pp_bank": (["loss.kmeans_init=plusplus", "loss.kmeans_source=bank",
                 "loss.bank_steps=3"], 2),
}
INLINE_OV = ["model.feat_dim=2048", "model.embed_dim=32", "data.batch_size=4",
             "data.max_frames=3", "data.num_regions=4", "data.max_words=3",
             "loss.num_clusters=4", "loss.ctx_window=2",
             "loss.kmeans_interval=1", "detector.image_size=64",
             "detector.num_proposals=4", "detector.rpn_pre_nms_topk=16",
             "detector.anchor_scales=[16,32]", "train.donate=false",
             "train.warmup_steps=0"]
PARAM_TOL = dict(rtol=0, atol=1e-5)
# train.device_cache under a mesh: two calls of 3 steps, with the bank
CACHE_OV = ["train.device_cache=true", "train.steps_per_call=3"]
CACHE_STEPS = 6
METRIC_TOL = dict(rtol=2e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _batches(root, n):
    ds = SegmentDataset(root, "train", 8, 6, 64, 3)
    return [{k: np.array(v) for k, v in b.items()}
            for _, b in BatchLoader(ds, 8, shuffle=True, seed=0).steps(n)]


def _single_device(cfg, state, batches, extractor=None, gumbels=None):
    """The port's steps on the whole batches: (state, metrics per step,
    last gradients)."""
    real = TT.kmeans_plusplus_init
    if gumbels is not None:
        TT.kmeans_plusplus_init = (
            lambda f, v, k, generator=None, **kw: real(
                f, v, k, gumbels=torch.from_numpy(gumbels), **kw))
    tx = W.RecordingOptimizer(cfg)
    metrics = []
    try:
        for b in batches:
            state, m = TT.train_step(
                state, TT.batch_to_device(b, torch.device("cpu")), cfg, tx,
                extractor)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        TT.kmeans_plusplus_init = real
    return state, metrics, {k: g.numpy() for k, g in tx.grads.items()}


def _jax_mesh(jc, js, batches, world, extractor=None):
    fn = JT.build_train_fn(jc, j_make_mesh(devices=jax.devices()[:world]),
                           extractor=extractor,
                           with_frames=extractor is not None)
    state, metrics = jax.tree.map(jnp.asarray, js), []
    for b in batches:
        state, m = fn(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, state), metrics


def _inline_case():
    from nafae_tpu.models.detector.faster_rcnn import init_detector
    from nafae_torch.models.detector.faster_rcnn import (
        FasterRCNNExtractor, detector_params_from_jax)
    jc = jcfg.load_config(preset_name="config5", overrides=INLINE_OV)
    tc = tcfg.load_config(preset_name="config5", overrides=INLINE_OV)
    model, det_params = init_detector(jax.random.PRNGKey(1), jc.detector)
    rng = np.random.RandomState(0)
    batch = {
        "frames": rng.rand(4, 3, 64, 64, 3).astype(np.float32),
        "word_ids": rng.randint(0, 67, (4, 3)).astype(np.int32),
        "frame_mask": np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0], [1, 1, 1]],
                               np.float32),
        "word_mask": np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0], [1, 1, 0]],
                              np.float32),
        "segment_id": np.arange(4, dtype=np.int32),
    }
    tdet = FasterRCNNExtractor(tc.detector).eval()
    tdet.load_state_dict(detector_params_from_jax(
        jax.tree.map(np.asarray, det_params)))
    return jc, tc, (model.apply, det_params), tdet, [batch]


def _prepare_steps(root, world):
    """The step cases for the workers, and each one's references."""
    cases, refs = {}, {}
    batches = _batches(root, 2)
    jax_auto = None
    for name, (extra, steps) in STEP_CASES.items():
        ov = OV + [f"data.root={root}"] + extra
        jc = jcfg.load_config(preset_name="config4", overrides=ov)
        tc = tcfg.load_config(preset_name="config4", overrides=ov)
        js = jax.tree.map(np.asarray, JT.TrainState.create(
            jax.random.PRNGKey(0), jc))
        gumbels = None
        if name.startswith("pp_"):
            n = int(np.prod(js.bank.shape[:-1]) if js.bank is not None
                    else 8 * 8 * 3)
            gumbels = _jax_gumbels(tc.train.seed, tc.loss.num_clusters, n)
        bs = batches[:steps]
        cases[name] = {"kind": "step", "preset": "config4", "overrides": ov,
                       "state": state_from_jax(js, "cpu").state_dict(),
                       "batches": bs, "gumbels": gumbels}
        single = _single_device(tc, state_from_jax(js, "cpu"), bs,
                                gumbels=gumbels)
        if name == "bf16":
            jref = jax_auto
        else:
            jref = _jax_mesh(jc, js, bs, world)
            jax_auto = jref if name == "auto" else jax_auto
        refs[name] = {"single": single, "jax": jref, "centers0": js.centers}
    jc, tc, jext, tdet, bs = _inline_case()
    js = jax.tree.map(np.asarray, JT.TrainState.create(jax.random.PRNGKey(0),
                                                       jc))
    cases["inline"] = {"kind": "step", "preset": "config5",
                       "overrides": INLINE_OV,
                       "state": state_from_jax(js, "cpu").state_dict(),
                       "batches": bs, "detector": tdet.state_dict()}
    refs["inline"] = {"single": _single_device(tc, state_from_jax(js, "cpu"),
                                               bs, extractor=tdet),
                      "jax": _jax_mesh(jc, js, bs, world, extractor=jext),
                      "centers0": js.centers}
    return cases, refs


def _fit_ov(root, ckpt, steps, extra=()):
    return OV + [f"data.root={root}", f"train.ckpt_dir={ckpt}",
                 f"train.steps={steps}", "train.log_every=1",
                 "loss.kmeans_source=bank", "loss.bank_steps=3", *extra]


def _fit(root, ckpt, steps, extra=()):
    logs = []
    cfg = tcfg.load_config(preset_name="config4",
                           overrides=_fit_ov(root, ckpt, steps, extra))
    state, _ = TT.fit(cfg, device="cpu", log_fn=logs.append)
    return state, logs


def _eval_cfg(root):
    return tcfg.load_config(preset_name="config1", overrides=[
        "data.feat_dim=64", "model.feat_dim=64", "model.embed_dim=32",
        "data.batch_size=5", f"data.root={root}"])


def _oracle():
    from nafae_torch.data.synthetic import _class_directions
    dirs = _class_directions(67, 64)
    w = dirs.T[:, :32].astype(np.float32)
    return {"word_emb": (dirs @ w).astype(np.float32), "w_v": w,
            "b_v": np.zeros(32, np.float32)}


def _audit_case():
    ov = OV + ["data.feat_dim=2048", "model.feat_dim=2048"]
    cfg = tcfg.load_config(preset_name="config4", overrides=ov)
    rng = np.random.RandomState(0)
    b, t, r, k = 8, 8, 6, 3
    batch = {"feats": rng.randn(b, t, r, 2048).astype(np.float32),
             "boxes": np.abs(rng.rand(b, t, r, 4)).astype(np.float32),
             "word_ids": rng.randint(0, 67, (b, k)).astype(np.int32),
             "frame_mask": np.ones((b, t), np.float32),
             "word_mask": np.ones((b, k), np.float32),
             "region_mask": np.ones((b, t, r), np.float32),
             "segment_id": np.arange(b, dtype=np.int32)}
    state = TT.TrainState.create(cfg, device="cpu")
    return {"kind": "step", "preset": "config4", "overrides": ov,
            "state": state.state_dict(), "batches": [batch]}


@pytest.fixture(scope="module")
def world2(synth_root, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp2"))
    cases, refs = _prepare_steps(synth_root, 2)
    # a single-device checkpoint at step 3, resumed under the mesh
    _fit(synth_root, os.path.join(tmp, "fb"), 3)
    cases.update(
        fit={"kind": "fit", "preset": "config4",
             "overrides": _fit_ov(synth_root, os.path.join(tmp, "fa"), 3)},
        fit_resume={"kind": "fit", "preset": "config4",
                    "overrides": _fit_ov(synth_root, os.path.join(tmp, "fb"),
                                         5)},
        eval={"kind": "eval", "preset": "config1",
              "overrides": ["data.feat_dim=64", "model.feat_dim=64",
                            "model.embed_dim=32", "data.batch_size=5",
                            f"data.root={synth_root}"],
              "params": _oracle()},
        fit_cache={"kind": "fit", "preset": "config4",
                   "overrides": _fit_ov(synth_root, os.path.join(tmp, "fc"),
                                        CACHE_STEPS, CACHE_OV)},
        audit=_audit_case(),
        errors={"kind": "errors", "preset": "config4",
                "overrides": OV + [f"data.root={synth_root}",
                                   "data.batch_size=5"]})
    return W.spawn(2, tmp, cases), refs, tmp


@pytest.fixture(scope="module")
def world4(synth_root, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp4"))
    cases, refs = _prepare_steps(synth_root, 4)
    return W.spawn(4, tmp, cases), refs, tmp


def _same_across_ranks(outs, name):
    first = outs[0][name]
    for o in outs[1:]:
        got = o[name]
        for k in first["params"]:
            np.testing.assert_array_equal(got["params"][k],
                                          first["params"][k], err_msg=k)
        np.testing.assert_array_equal(got["centers"], first["centers"])
        assert got["metrics"] == first["metrics"]
        for k in first["grads"]:
            np.testing.assert_array_equal(got["grads"][k], first["grads"][k],
                                          err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", [*STEP_CASES, "inline"])
def test_dp_step_matches_single_device_and_jax(request, world, name):
    outs, refs, _ = request.getfixturevalue(f"world{world}")
    _same_across_ranks(outs, name)
    got = outs[0][name]
    s_state, s_metrics, s_grads = refs[name]["single"]
    j_state, j_metrics = refs[name]["jax"]
    bf16 = name == "bf16"
    ptol = BF16_TOL if bf16 else PARAM_TOL
    for k, v in s_state.params.items():
        np.testing.assert_allclose(got["params"][k], v.numpy(), err_msg=k,
                                   **ptol)
        np.testing.assert_allclose(got["params"][k], j_state.params[k],
                                   err_msg=k, **ptol)
    np.testing.assert_allclose(got["centers"], s_state.centers.numpy(),
                               **ptol)
    np.testing.assert_allclose(got["centers"], j_state.centers, **ptol)
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
    if s_state.bank is not None:        # each rank holds its rows
        bank = np.concatenate([o[name]["bank"] for o in outs], 1)
        valid = np.concatenate([o[name]["bank_valid"] for o in outs], 1)
        assert bank.shape[1] // world == outs[0][name]["bank"].shape[1]
        np.testing.assert_allclose(bank, s_state.bank.numpy(), **PARAM_TOL)
        np.testing.assert_allclose(bank, j_state.bank, **PARAM_TOL)
        np.testing.assert_array_equal(valid, s_state.bank_valid.numpy())
    # the refreshes (and the seeding) moved the centers
    assert not np.allclose(got["centers"], refs[name]["centers0"], atol=1e-3)


def test_dp_fit_logs_once_and_resumes_on_one_device(world2, synth_root):
    """fit under a world-2 mesh: rank 0 alone logs (one metrics.jsonl) and
    checkpoints, its metrics those of the single-device fit; its
    checkpoint, bank gathered, resumes on one device to the trajectory of
    the single-device run resumed from its own checkpoint, and so does
    a single-device checkpoint resumed under the mesh."""
    from nafae_torch.utils.metrics_log import MetricsLogger
    outs, _, tmp = world2
    logs, quiet = outs[0]["fit"]["logs"], outs[1]["fit"]["logs"]
    assert quiet == [] and [m["step"] for m in logs] == [1, 2, 3]
    fa = os.path.join(tmp, "fa")
    assert [r["step"] for r in MetricsLogger(fa).read()] == [1, 2, 3]
    assert sorted(os.listdir(fa)) == ["metrics.jsonl", "state_3.pt"]
    _, single = _fit(synth_root, os.path.join(tmp, "fs"), 3)
    for g, s in zip(logs, single):
        for k in s:
            if k not in ("frames_per_sec", "ts"):
                np.testing.assert_allclose(g[k], s[k], err_msg=k,
                                           **METRIC_TOL)
    # the 3-step runs' schedule (train.steps) differs from a 5-step run's:
    # both resume from a 3-step run's checkpoint
    whole, _ = _fit(synth_root, os.path.join(tmp, "fs"), 5)
    resumed, _ = _fit(synth_root, fa, 5)
    assert resumed.step == 5
    for k, v in whole.params.items():
        np.testing.assert_allclose(resumed.params[k].numpy(), v.numpy(),
                                   err_msg=k, **PARAM_TOL)
    np.testing.assert_allclose(resumed.bank.numpy(), whole.bank.numpy(),
                               **PARAM_TOL)
    # ... and a single-device checkpoint resumes under the mesh
    back = outs[0]["fit_resume"]
    assert back["step"] == 5
    for k, v in whole.params.items():
        np.testing.assert_allclose(back["params"][k], v.numpy(), err_msg=k,
                                   **PARAM_TOL)
    np.testing.assert_allclose(back["centers"], whole.centers.numpy(),
                               **PARAM_TOL)


def check_cached_fit(outs, root, tmp, extra, ptol):
    """The cached fit of the world's case "fit_cache" against the
    single-device cached fit: rank 0 alone logs, at steps 3 and 6, rows
    within METRIC_TOL; params and centers within ptol; the checkpoint's
    bank (gathered from every rank's shard) within ptol."""
    got = outs[0]["fit_cache"]
    assert all(o["fit_cache"]["logs"] == [] for o in outs[1:])
    assert got["step"] == CACHE_STEPS
    whole, logs = _fit(root, os.path.join(tmp, "fc_single"), CACHE_STEPS,
                       CACHE_OV + list(extra))
    assert [m["step"] for m in got["logs"]] == [m["step"] for m in logs] \
        == [3, 6]
    for g, s in zip(got["logs"], logs):
        assert set(g) == set(s)
        for k in s:
            if k not in ("frames_per_sec", "frames_per_sec_avg", "ts"):
                np.testing.assert_allclose(g[k], s[k], err_msg=k,
                                           **METRIC_TOL)
    for k, v in whole.params.items():
        np.testing.assert_allclose(got["params"][k], v.numpy(), err_msg=k,
                                   **ptol)
    np.testing.assert_allclose(got["centers"], whole.centers.numpy(), **ptol)
    saved = torch.load(os.path.join(tmp, "fc", f"state_{CACHE_STEPS}.pt"),
                       weights_only=True)
    np.testing.assert_allclose(saved["bank"].numpy(), whole.bank.numpy(),
                               **ptol)


def test_dp_cached_fit_matches_single_device(world2, synth_root):
    """train.device_cache on 2 ranks: each gathers its rows of every
    global index batch from its own cache; the run is the single
    device's."""
    outs, _, tmp = world2
    check_cached_fit(outs, synth_root, tmp, [], PARAM_TOL)


def test_dp_eval_matches_single_device(world2, synth_root):
    """Eval at batch 5 (12 val segments: 5 + 5 + 2, each padded to 6) on
    2 ranks gives the single device's dict exactly, on every rank."""
    from nafae_torch.evaluate import evaluate_config
    outs, _, _ = world2
    params = {k: torch.from_numpy(v) for k, v in _oracle().items()}
    want = evaluate_config(_eval_cfg(synth_root), params=params,
                           device="cpu")
    assert want["num_annotations"] > 0 and want["box_acc_micro"] > 0
    assert outs[0]["eval"] == outs[1]["eval"] == want


def test_dp_collectives_stay_small(world2):
    """The port's form of tests/test_train.py's audit, at D = 2048 (each
    rank's feats 1.5 MB): besides the one all-reduce of the gradient
    buffer (every parameter, 262 KB of them w_v), no collective of the
    step moves more than 128 KB, so region features never cross."""
    outs, _, _ = world2
    (records,) = outs[0]["audit"]["collectives"]
    params = outs[0]["audit"]["params"]
    grad_bytes = sum(v.size * 4 for v in params.values())
    big = [r for r in records if r[3] > 128 * 1024]
    assert big == [("all_reduce", (grad_bytes // 4,), "float32",
                    grad_bytes)]
    assert len(records) >= 5
    ops = {r[0] for r in records}
    assert ops == {"all_gather", "all_reduce"}


def test_dp_refusals(world2):
    outs, _, _ = world2
    for rank, o in enumerate(outs):
        err = o["errors"]
        assert "does not divide" in err["fit"]
        assert "needs 3 ranks, have 2" in err["mesh"]
        assert any("uses 1 of 2 ranks" in w for w in err["warning"])
        assert (err["sub_coordinate"] is None) == (rank == 1)


def test_frame_axis_and_multihost_on_a_world_of_one(synth_root, tmp_path,
                                                   capsys, monkeypatch):
    """The refusals of frame parallelism and --multihost are gone: on a
    world of one a frame axis of 2 is refused for its size alone, as the
    reference's make_mesh refuses it, and `--multihost` with no launch
    configured warns and trains as one process, exactly as the run
    without it (frame-parallel runs: tests/test_torch_sp.py; runs across
    hosts: tests/test_torch_multihost.py)."""
    from nafae_torch.parallel.mesh import make_mesh, shutdown
    try:
        with pytest.raises(ValueError, match="not divisible by "
                           "frame_axis=2"):
            make_mesh(frame_axis=2, device="cpu")
    finally:
        shutdown()
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "SLURM_PROCID", "OMPI_COMM_WORLD_RANK"):
        monkeypatch.delenv(k, raising=False)
    outs = {}
    for flag in ([], ["--multihost"]):
        ck = tmp_path / ("m" if flag else "p")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            TT.main(["--preset", "config4", "--device", "cpu", *flag,
                     "--override", *OV, f"data.root={synth_root}",
                     f"train.ckpt_dir={ck}", "train.steps=2",
                     "train.log_every=1"])
        assert any("SINGLE" in str(w.message) for w in caught) == bool(flag)
        outs[bool(flag)] = [" ".join(w for w in ln.split()
                                     if not w.startswith("frames_per_sec"))
                            for ln in capsys.readouterr().out.splitlines()]
    assert outs[True] == outs[False] and len(outs[True]) == 2
    assert not torch.distributed.is_initialized()


def test_cli_mesh_on_a_world_of_one(synth_root, tmp_path, capsys):
    """--mesh without torchrun: a gloo world of one, whose runs equal the
    runs without the flag, for the train and eval CLIs."""
    from nafae_torch import evaluate as TE
    outs = {}
    for flag in ([], ["--mesh"]):
        ck = tmp_path / ("m" if flag else "p")
        TT.main(["--preset", "config4", "--device", "cpu", *flag,
                 "--override", *OV, f"data.root={synth_root}",
                 f"train.ckpt_dir={ck}", "train.steps=2",
                 "train.log_every=1"])
        TE.main(["--preset", "config1", "--device", "cpu", *flag,
                 "--checkpoint", str(ck), "--override", "data.feat_dim=64",
                 "model.feat_dim=64", "model.embed_dim=32",
                 f"data.root={synth_root}"])
        lines = capsys.readouterr().out.splitlines()
        outs[bool(flag)] = [" ".join(w for w in ln.split()
                                     if not w.startswith("frames_per_sec"))
                            for ln in lines]
    assert outs[True] == outs[False] and len(outs[True]) == 3
    assert not torch.distributed.is_initialized()


def test_torchrun_trains_on_two_ranks(synth_root, tmp_path):
    """`torchrun --nproc_per_node 2 -m nafae_torch.train --mesh --device
    cpu`: one rank prints, and its metrics are the single device's."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    ov = OV + [f"data.root={synth_root}", f"train.ckpt_dir={tmp_path}/m",
               "train.steps=2", "train.log_every=1"]
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "nafae_torch.train", "--mesh",
         "--device", "cpu", "--preset", "config4", "--override", *ov],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if "step=" in ln]
    assert len(lines) == 2
    _, single = _fit(synth_root, tmp_path / "s", 2)
    got = dict(w.split("=") for w in lines[-1].split())
    for k in ("loss", "l_rank", "l_ctx", "l_clu", "grad_norm"):
        np.testing.assert_allclose(float(got[k]), single[-1][k], rtol=1e-3,
                                   err_msg=k)
