"""The port's training step (nafae_torch.train) against the JAX package's,
on the CPU, at test_train.py's small shapes (OV).

Both start from one point: the JAX TrainState, converted with
`state_from_jax`, and see the same numpy batches. Held: one step's metrics
(rtol 1e-5) and gradients (rtol 1e-4 / atol 1e-6) for config2/3/4, and
params and centers after 5 steps with k-means refreshes at steps 0, 2 and
4, from this step's selections or from the selection bank (rtol 1e-4 /
atol 1e-5; a one-step params check proves nothing, the
first update has lr 0). Each with `train.kernels` auto and, in the cases
with a `-pallas` id, the fused route (the port's plain versions of the
cross-MIL and diag-epilogue kernels against the JAX package's Pallas
kernels in interpret mode). The JAX CPU backend cannot execute bf16 dots
(test_sp.py's bf16 step only compiles), so the port's bf16 step is held
against JAX's f32 step at the 2e-2 of the JAX package's bf16-vs-f32 tests,
gradients relative to each leaf's largest entry. Also: fit lowers the
loss, a resumed run equals an uninterrupted one, and the CLI trains with
--device cpu.
"""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

import nafae_tpu.config as jcfg
import nafae_torch.config as tcfg
from nafae_tpu import train as JT
from nafae_tpu.data import BatchLoader, SegmentDataset
from nafae_torch import train as TT
from nafae_torch.models.grounding import state_from_jax

OV = ["data.feat_dim=64", "model.feat_dim=64", "model.embed_dim=32",
      "data.batch_size=8", "data.max_frames=8", "data.num_regions=6",
      "data.max_words=3", "loss.num_clusters=8", "loss.kmeans_interval=5",
      "train.warmup_steps=5", "train.log_every=1000", "train.ckpt_every=1000000",
      "train.eval_every=1000000"]


def _cfgs(synth_root, preset, extra=(), kernels="auto"):
    ov = OV + [f"data.root={synth_root}", f"train.kernels={kernels}"] \
        + list(extra)
    return (jcfg.load_config(preset_name=preset, overrides=ov),
            tcfg.load_config(preset_name=preset, overrides=ov))


def _batches(synth_root, cfg, n):
    ds = SegmentDataset(synth_root, "train", cfg.data.max_frames,
                        cfg.data.num_regions, cfg.data.feat_dim,
                        cfg.data.max_words)
    it = BatchLoader(ds, cfg.data.batch_size, shuffle=True,
                     seed=0).steps(n)
    return [b for _, b in it]


def _start(jc):
    """The JAX initial state as numpy, and the port's copy of it."""
    js = jax.tree.map(np.asarray, JT.TrainState.create(
        jax.random.PRNGKey(0), jc))
    return js, state_from_jax(js, "cpu")


def _jax_grads(js, batch, jc):
    g = jax.jit(jax.grad(lambda p: JT.compute_losses(
        p, js.centers, batch, jc, 0,
        kernels=jc.train.resolved_kernels())[0]))(js.params)
    return {k: np.asarray(v) for k, v in g.items()}


def _torch_grads(ts, tb, tc):
    params = {k: v.detach().requires_grad_() for k, v in ts.params.items()}
    total, _ = TT.compute_losses(params, ts.centers, tb, tc,
                                 tc.train.resolved_kernels())
    names = sorted(params)
    gs = torch.autograd.grad(total, [params[k] for k in names],
                             allow_unused=True)
    return {k: np.zeros(params[k].shape, np.float32) if g is None
            else g.numpy() for k, g in zip(names, gs)}


@pytest.mark.parametrize("preset,dtype,kernels", [
    pytest.param(p, d, k, id=f"{p}-{d}" + ("-pallas" if k == "pallas" else ""))
    for k in ("auto", "pallas")
    for p, d in (("config2", "float32"), ("config3", "float32"),
                 ("config4", "float32"), ("config4", "bfloat16"))])
def test_one_step_matches_jax(synth_root, preset, dtype, kernels):
    jc, _ = _cfgs(synth_root, preset, kernels=kernels)
    _, tc = _cfgs(synth_root, preset, [f"model.dtype={dtype}"], kernels)
    batch = _batches(synth_root, jc, 1)[0]
    js, ts = _start(jc)
    tb = TT.batch_to_device(batch, torch.device("cpu"))
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    gtol = (dict(rtol=1e-4, atol=1e-6) if dtype == "float32"
            else dict(rtol=2e-2, atol=2e-2))
    gj, gt = _jax_grads(js, batch, jc), _torch_grads(ts, tb, tc)
    assert set(gj) == set(gt)
    for k in gj:
        if dtype == "float32":
            np.testing.assert_allclose(gt[k], gj[k], err_msg=k, **gtol)
        else:   # bf16: the gradient's direction, relative to its scale
            scale = np.abs(gj[k]).max()
            np.testing.assert_allclose(gt[k] / scale, gj[k] / scale,
                                       err_msg=k, **gtol)
    _, mj = JT.build_train_fn(jc, None)(
        jax.tree.map(jax.numpy.asarray, js), batch)
    _, mt = TT.train_step(ts, tb, tc)
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), err_msg=k,
                                   **tol)


@pytest.mark.parametrize("preset,source,kernels", [
    pytest.param("config2", "batch", "auto", id="config2-batch"),
    pytest.param("config3", "batch", "auto", id="config3-batch"),
    pytest.param("config4", "batch", "auto", id="config4-batch"),
    pytest.param("config4", "bank", "auto", id="config4-bank"),
    pytest.param("config4", "batch", "pallas", id="config4-batch-pallas")])
def test_five_steps_match_jax(synth_root, preset, source, kernels):
    jc, tc = _cfgs(synth_root, preset, ["loss.kmeans_interval=2",
                                        f"loss.kmeans_source={source}",
                                        "loss.bank_steps=3"], kernels)
    batches = _batches(synth_root, jc, 5)
    js, ts = _start(jc)
    step = JT.build_train_fn(jc, None)
    jstate = jax.tree.map(jax.numpy.asarray, js)
    tx = TT.make_optimizer(tc)
    for batch in batches:
        jstate, _ = step(jstate, batch)
        ts, _ = TT.train_step(ts, TT.batch_to_device(batch, ts.device), tc,
                              tx)
    assert ts.step == int(jstate.step) == 5
    assert ts.opt_state["count"] == 5
    for k, v in jstate.params.items():
        np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(ts.centers.numpy(), np.asarray(jstate.centers),
                               rtol=1e-4, atol=1e-5)
    if source == "bank" and preset == "config4":
        np.testing.assert_allclose(ts.bank.numpy(), np.asarray(jstate.bank),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(ts.bank_valid.numpy(),
                                      np.asarray(jstate.bank_valid))
    # config4's refreshes moved the centers away from their random start
    moved = not np.allclose(ts.centers.numpy(), js.centers, atol=1e-3)
    assert moved == (preset == "config4")


def test_fit_lowers_the_loss(synth_root, tmp_path):
    _, tc = _cfgs(synth_root, "config4", [f"train.ckpt_dir={tmp_path}/ck",
                                          "train.steps=30", "train.lr=0.003",
                                          "train.log_every=5"])
    logs = []
    state, _ = TT.fit(tc, device="cpu", log_fn=logs.append)
    assert state.step == 30 and len(logs) == 6
    assert logs[-1]["loss"] < logs[0]["loss"], [m["loss"] for m in logs]
    from nafae_torch.utils.metrics_log import MetricsLogger
    assert [m["step"] for m in MetricsLogger(str(tmp_path / "ck")).read()] \
        == [5, 10, 15, 20, 25, 30]


def test_resume_equals_an_uninterrupted_run(synth_root, tmp_path):
    def run(ckpt_dir, steps):
        _, tc = _cfgs(synth_root, "config4", [f"train.ckpt_dir={ckpt_dir}",
                                              f"train.steps={steps}",
                                              "loss.kmeans_interval=3"])
        return TT.fit(tc, device="cpu")[0]

    whole = run(tmp_path / "a", 7)
    part = run(tmp_path / "b", 4)
    assert part.step == 4
    resumed = run(tmp_path / "b", 7)
    assert resumed.step == 7
    for k in whole.params:
        torch.testing.assert_close(resumed.params[k], whole.params[k],
                                   rtol=0, atol=0)
    torch.testing.assert_close(resumed.centers, whole.centers, rtol=0, atol=0)
    for k in whole.opt_state["mu"]:
        torch.testing.assert_close(resumed.opt_state["nu"][k],
                                   whole.opt_state["nu"][k], rtol=0, atol=0)


def test_cli_trains_on_the_cpu(synth_root, tmp_path, capsys):
    TT.main(["--preset", "config4", "--device", "cpu", "--override",
             *OV, f"data.root={synth_root}", f"train.ckpt_dir={tmp_path}",
             "train.steps=2", "train.log_every=1"])
    out = capsys.readouterr().out
    assert "step=2" in out and "l_clu=" in out
    assert sorted(p.name for p in tmp_path.glob("state_*.pt")) == \
        ["state_2.pt"]


def test_tensorboard_dir_raises(synth_root, tmp_path):
    """The TensorBoard mirror is not ported: asking for it raises before
    any step, instead of training without the event files."""
    _, tc = _cfgs(synth_root, "config4", [f"train.ckpt_dir={tmp_path}/ck",
                                          f"train.tensorboard_dir={tmp_path}"
                                          "/tb", "train.steps=1"])
    with pytest.raises(NotImplementedError, match="tensorboard_dir"):
        TT.fit(tc, device="cpu")
    assert not (tmp_path / "ck").exists()


def test_cli_evaluates_every_eval_every(synth_root, tmp_path, capsys):
    """With a val split, the CLI prints one `eval ... step=n` line each
    eval_every steps, at the steps where the reference's fit calls its
    eval_fn, and the last line's numbers are evaluate_config's on the
    final checkpoint; without a val split it prints none. It no longer
    writes to stderr."""
    import os
    import shutil

    from nafae_torch.evaluate import evaluate_config

    extra = ["train.steps=4", "train.eval_every=2", "train.log_every=1"]
    jc, tc = _cfgs(synth_root, "config4",
                   extra + [f"train.ckpt_dir={tmp_path}/j"])
    ref_steps = []
    JT.fit(jc, None, eval_fn=lambda st: ref_steps.append(int(st.step)))
    assert ref_steps == [2, 4]
    capsys.readouterr()

    args = ["--preset", "config4", "--device", "cpu", "--override", *OV,
            f"data.root={synth_root}", *extra]
    TT.main(args + [f"train.ckpt_dir={tmp_path}/a"])
    out, err = capsys.readouterr()
    evals = [ln for ln in out.splitlines() if ln.startswith("eval ")]
    assert [ln.split("step=")[1] for ln in evals] == \
        [str(s) for s in ref_steps]
    assert "step=4" in out and err == ""
    fields = dict(kv.split("=") for kv in evals[-1].split()[1:])
    r = evaluate_config(replace(tc, train=replace(
        tc.train, ckpt_dir=f"{tmp_path}/a")), require_checkpoint=True,
        device="cpu")
    assert float(fields["box_acc_micro"]) == r["box_acc_micro"]
    assert float(fields["box_acc_macro"]) == r["box_acc_macro"]
    assert int(fields["num_annotations"]) == r["num_annotations"] == 77

    no_val = tmp_path / "no_val"
    shutil.copytree(os.path.join(synth_root, "train"), no_val / "train")
    TT.main(["--preset", "config4", "--device", "cpu", "--override", *OV,
             f"data.root={no_val}", *extra, f"train.ckpt_dir={tmp_path}/b"])
    out, err = capsys.readouterr()
    assert "step=4" in out and "eval " not in out and err == ""


def test_loader_gives_the_jax_packages_batches(synth_root):
    """SegmentDataset + BatchLoader of the port yield the JAX package's
    batches, in the same seeded order, with frame buckets too."""
    from nafae_torch.data.loader import BatchLoader as TLoader
    from nafae_torch.data.youcook2 import SegmentDataset as TDataset

    for buckets in ((), (4, 8)):
        args = (synth_root, "train", 8, 6, 64, 3)
        jl = BatchLoader(SegmentDataset(*args, frame_buckets=buckets), 4,
                         seed=3)
        tl = TLoader(TDataset(*args, frame_buckets=buckets), 4, seed=3)
        assert tl.batches_per_epoch() == jl.batches_per_epoch()
        got = [b for _, b in tl.steps(10, start_epoch=1, skip=2)]
        want = [b for _, b in jl.steps(10, start_epoch=1, skip=2)]
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_checkpoints_keep_the_newest(tmp_path):
    """keep=N drops older checkpoints; the newest restores the whole state
    and serves its params (load_eval_params on the directory)."""
    from nafae_torch.utils.checkpoint import (CheckpointManager,
                                              load_eval_params)

    _, tc = _cfgs(str(tmp_path), "config4")
    state = TT.TrainState.create(tc, device="cpu")
    ckpt = CheckpointManager(str(tmp_path / "ck"), keep=2)
    assert ckpt.restore_latest(state) is None
    for step in (1, 2, 3):
        ckpt.save(replace(state, step=step))
    assert ckpt.steps() == [2, 3]
    back = ckpt.restore_latest(state)
    assert back.step == 3 and back.opt_state["count"] == 0
    served = load_eval_params(tc, str(tmp_path / "ck"), device="cpu")
    for k in state.params:
        assert torch.equal(back.params[k], state.params[k])
        assert torch.equal(served[k], state.params[k])


def _glove(path, e, words, seed=0, width=None):
    """A GloVe-style text file over `words` (some multi-word classes only by
    their tokens), with one line of the wrong width."""
    rng = np.random.RandomState(seed)
    lines = [" ".join([w] + [f"{x:.6f}" for x in rng.randn(width or e)])
             for w in words]
    lines.insert(2, "stray " + " ".join(["0.5"] * (e + 3)))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("kind", ["text", "npz", "wrong-width"])
def test_load_word_vectors_matches_jax(tmp_path, kind):
    from nafae_tpu.data.vocab import Vocab as JVocab
    from nafae_tpu.models.grounding import load_word_vectors as j_load
    from nafae_torch.data.vocab import Vocab as TVocab
    from nafae_torch.models.grounding import load_word_vectors as t_load

    e = 12
    vocab = JVocab()
    words = [c for c in vocab.classes[::2] if "_" not in c and " " not in c]
    multi = [c for c in vocab.classes if "_" in c or " " in c]
    import re
    words += [t for c in multi[:2] for t in re.split(r"[\s_]+", c)]
    if kind == "npz":
        rng = np.random.RandomState(1)
        path = str(tmp_path / "vec.npz")
        np.savez(path, **{w: rng.randn(e).astype(np.float32) for w in words})
    else:
        path = _glove(tmp_path / "vec.txt", e, words,
                      width=e + 5 if kind == "wrong-width" else None)
    if kind == "wrong-width":
        with pytest.raises(ValueError) as want:
            j_load(path, vocab, e)
        with pytest.raises(ValueError) as got:
            t_load(path, TVocab(), e)
        assert str(got.value) == str(want.value)
        assert "refusing to truncate" in str(got.value)
        return
    vj, hj = j_load(path, vocab, e)
    vt, ht = t_load(path, TVocab(), e)
    assert ht == hj > len(multi[:2])
    assert vt.dtype == vj.dtype
    np.testing.assert_array_equal(vt, vj)


def _jax_gumbels(seed, k, n):
    """The Gumbel draws of nafae_tpu.ops.kmeans.kmeans_plusplus_init from
    PRNGKey(seed): k0 for the first center, then one split per center."""
    key = jax.random.PRNGKey(seed)
    k0, key = jax.random.split(key)
    rows = [jax.random.gumbel(k0, (n,))]
    for _ in range(1, k):
        key, kd = jax.random.split(key)
        rows.append(jax.random.gumbel(kd, (n,)))
    return np.stack([np.asarray(r) for r in rows])


def _seed_rows(shape, max_rows):
    """Candidate rows after the reference's dim-0 stride subsample."""
    rows = int(np.prod(shape[:-1]))
    if max_rows and rows > max_rows:
        per_slot = rows // shape[0]
        stride = -(-shape[0] // max(1, max_rows // max(per_slot, 1)))
        return len(range(0, shape[0], stride)) * per_slot
    return rows


@pytest.mark.parametrize("case", ["batch", "bank", "bank-capped",
                                  "bank-past-max-seed-rows"])
def test_kmeans_plusplus_matches_jax(case):
    from nafae_tpu.ops.kmeans import MAX_SEED_ROWS
    from nafae_tpu.ops.kmeans import kmeans_plusplus_init as j_pp
    from nafae_torch.ops.kmeans import kmeans_plusplus_init as t_pp

    rng = np.random.RandomState(4)
    kc, max_rows = 8, MAX_SEED_ROWS
    if case == "batch":
        shape = (4, 5, 3, 16)                          # [B,T,K,E] selections
    elif case == "bank":
        shape = (3, 4, 5, 3, 16)                       # [W,B,T,K,E] ring
    elif case == "bank-capped":
        shape, max_rows = (8, 4, 5, 3, 16), 100
    else:
        shape, kc = (32, 16, 20, 8, 8), 67             # config4's ring
    f = rng.randn(*shape).astype(np.float32)
    valid = (rng.rand(*shape[:-1]) > 0.3).astype(np.float32)
    if case != "batch":                                # step 0: slot 0 only
        f[1:], valid[1:] = 0.0, 0.0
        if case == "bank-past-max-seed-rows":
            f[6], valid[6] = f[0], valid[0]            # a kept slot
    n = _seed_rows(shape, max_rows)
    assert (n < int(np.prod(shape[:-1]))) == case.startswith("bank-")
    g = _jax_gumbels(5, kc, n)
    want = np.asarray(j_pp(jax.random.PRNGKey(5), jax.numpy.asarray(f),
                           jax.numpy.asarray(valid), kc, max_rows=max_rows))
    got = t_pp(torch.from_numpy(f), torch.from_numpy(valid), kc,
               gumbels=torch.from_numpy(g), max_rows=max_rows).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    rows = f.reshape(-1, shape[-1])
    rows = rows / np.maximum(np.linalg.norm(rows, axis=-1, keepdims=True),
                             1e-12)
    np.testing.assert_array_equal(np.argmax(got @ rows.T, -1),
                                  np.argmax(want @ rows.T, -1))
    with pytest.raises(NotImplementedError, match="mesh"):
        t_pp(torch.from_numpy(f), torch.from_numpy(valid), kc,
             axis_names=("data",), gather_dims=(0,))
    # without gumbels the noise comes from the generator: seeded, repeatable
    a = t_pp(torch.from_numpy(f), torch.from_numpy(valid), kc,
             generator=torch.Generator().manual_seed(0), max_rows=max_rows)
    b = t_pp(torch.from_numpy(f), torch.from_numpy(valid), kc,
             generator=torch.Generator().manual_seed(0), max_rows=max_rows)
    assert torch.equal(a, b)


def _fit_both(synth_root, tmp_path, monkeypatch, extra):
    """One fit step of each package from JAX's initial state (the port's
    TrainState.create returns its copy); returns both logged metrics and
    final states."""
    jc, tc = _cfgs(synth_root, "config4", extra + [
        "train.steps=1", "train.log_every=1"])
    jc = replace(jc, train=replace(jc.train, ckpt_dir=str(tmp_path / "j")))
    tc = replace(tc, train=replace(tc.train, ckpt_dir=str(tmp_path / "t")))
    js, ts = _start(jc)
    monkeypatch.setattr(TT.TrainState, "create",
                        classmethod(lambda cls, cfg, device=None, seed=None:
                                    state_from_jax(js, "cpu")))
    jlog, tlog = [], []
    jstate, _ = JT.fit(jc, None, log_fn=jlog.append)
    tstate, _ = TT.fit(tc, device="cpu", log_fn=tlog.append)
    assert len(jlog) == len(tlog) == 1
    for k in jlog[0]:
        if k in ("frames_per_sec",):
            continue
        np.testing.assert_allclose(tlog[0][k], jlog[0][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    return jc, tc, jstate, tstate


def test_fit_with_word_vectors_matches_jax(synth_root, tmp_path,
                                           monkeypatch):
    from nafae_torch.data.vocab import Vocab
    vocab = Vocab()
    path = _glove(tmp_path / "glove.txt", 32, vocab.classes[:40], seed=3)
    jc, tc, jstate, tstate = _fit_both(synth_root, tmp_path, monkeypatch,
                                       [f"model.word_vectors={path}"])
    want = np.asarray(jstate.params["word_emb"])
    # the first update has lr 0: word_emb is still the loaded vectors
    np.testing.assert_array_equal(tstate.params["word_emb"].numpy(), want)
    line = next(ln for ln in open(path).read().splitlines()
                if ln.split()[0] == vocab.classes[5])
    np.testing.assert_array_equal(want[5], np.float32(line.split()[1:]))
    with pytest.raises(ValueError, match="vocab_size"):
        TT.fit(replace(tc, model=replace(tc.model, vocab_size=66)),
               device="cpu")


def test_fit_with_kmeans_plusplus_matches_jax(synth_root, tmp_path,
                                              monkeypatch):
    """Step 0 seeds the centers by k-means++ from its selections before
    the Lloyd refresh; with JAX's Gumbel draws fed in, the centers after
    one step equal the reference's."""
    real = TT.kmeans_plusplus_init

    def with_jax_noise(f, valid, k, generator=None, **kw):
        n = _seed_rows(tuple(f.shape), 16384)
        return real(f, valid, k, gumbels=torch.from_numpy(
            _jax_gumbels(0, k, n)), **kw)

    monkeypatch.setattr(TT, "kmeans_plusplus_init", with_jax_noise)
    jc, tc, jstate, tstate = _fit_both(
        synth_root, tmp_path, monkeypatch,
        ["loss.kmeans_init=plusplus", "loss.kmeans_interval=1"])
    js0 = JT.TrainState.create(jax.random.PRNGKey(0), jc)
    assert not np.allclose(np.asarray(jstate.centers),
                           np.asarray(js0.centers), atol=1e-3)
    np.testing.assert_allclose(tstate.centers.numpy(),
                               np.asarray(jstate.centers), rtol=1e-5,
                               atol=1e-6)
