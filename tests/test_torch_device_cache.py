"""The port's device-resident dataset (`train.device_cache`,
nafae_torch.train.fit_device_cached) against the JAX package's cached
`fit`, on the CPU, at test_torch_train.py's small shapes (OV).

Both packages start from JAX's initial state (the port's
TrainState.create returns its copy, `state_from_jax`) and draw the same
index stream (RandomState(train.seed), one permutation an epoch). Held:
every metrics.jsonl row's step and values (rtol 1e-5 / atol 1e-6; the
rates aside) and the final params (rtol 1e-5 / atol 1e-5) with
steps_per_call 1, 2 and 3 over 7 steps (calls of spc steps, the last one
shrunk to the steps left; logged where step % max(every, spc) < spc);
the k-means bank source; the exact step target and a rerun that trains
nothing; a resumed run equal to the uninterrupted one; the two refusals.
Under a mesh the cached run is held in tests/test_torch_dp.py and
tests/test_torch_sp.py.
"""

from dataclasses import replace

import numpy as np
import pytest

from nafae_tpu import train as JT
from nafae_torch import train as TT
from nafae_torch.models.grounding import state_from_jax
from nafae_torch.utils.metrics_log import MetricsLogger
from tests.test_torch_train import _cfgs, _start

TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
RATES = ("frames_per_sec", "frames_per_sec_avg", "ts")


def _both(synth_root, tmp_path, monkeypatch, extra, steps=7):
    """The cached fit of each package from JAX's initial state; returns
    (jax state, port state, jax rows, port rows)."""
    jc, tc = _cfgs(synth_root, "config4", ["train.device_cache=true",
                                           f"train.steps={steps}",
                                           "train.log_every=1", *extra])
    jc = replace(jc, train=replace(jc.train, ckpt_dir=str(tmp_path / "j")))
    tc = replace(tc, train=replace(tc.train, ckpt_dir=str(tmp_path / "t")))
    js, _ = _start(jc)
    monkeypatch.setattr(TT.TrainState, "create",
                        classmethod(lambda cls, cfg, device=None, seed=None:
                                    state_from_jax(js, "cpu")))
    jstate, _ = JT.fit(jc, None)
    tstate, _ = TT.fit(tc, device="cpu")
    return (jstate, tstate, MetricsLogger(str(tmp_path / "j")).read(),
            MetricsLogger(str(tmp_path / "t")).read())


def _same_rows(jrows, trows):
    assert [r["step"] for r in trows] == [r["step"] for r in jrows]
    for j, t in zip(jrows, trows):
        assert set(t) == set(j)
        for k in j:
            if k not in RATES:
                np.testing.assert_allclose(t[k], j[k], err_msg=k, **TOL)


def _same_params(jstate, tstate):
    for k, v in jstate.params.items():
        np.testing.assert_allclose(tstate.params[k].numpy(), np.asarray(v),
                                   err_msg=k, **PARAM_TOL)
    np.testing.assert_allclose(tstate.centers.numpy(),
                               np.asarray(jstate.centers), **PARAM_TOL)


@pytest.mark.parametrize("spc,logged", [(1, list(range(1, 8))),
                                        (2, [2, 4, 6, 7]), (3, [3, 6, 7])])
def test_cached_fit_matches_jax(synth_root, tmp_path, monkeypatch, spc,
                                logged):
    jstate, tstate, jrows, trows = _both(
        synth_root, tmp_path, monkeypatch,
        [f"train.steps_per_call={spc}", "loss.kmeans_interval=2"])
    assert tstate.step == int(jstate.step) == 7
    assert [r["step"] for r in trows] == logged
    _same_rows(jrows, trows)
    _same_params(jstate, tstate)


def test_cached_fit_with_the_bank_matches_jax(synth_root, tmp_path,
                                              monkeypatch):
    jstate, tstate, jrows, trows = _both(
        synth_root, tmp_path, monkeypatch,
        ["train.steps_per_call=2", "loss.kmeans_source=bank",
         "loss.bank_steps=3", "loss.kmeans_interval=2"], steps=5)
    _same_rows(jrows, trows)
    _same_params(jstate, tstate)
    np.testing.assert_allclose(tstate.bank.numpy(), np.asarray(jstate.bank),
                               **PARAM_TOL)
    np.testing.assert_array_equal(tstate.bank_valid.numpy(),
                                  np.asarray(jstate.bank_valid))


def test_cached_fit_stops_at_the_step_target(synth_root, tmp_path):
    """steps=7 at spc=3: the last call takes one step, and a rerun on the
    completed directory trains none and logs nothing more."""
    _, tc = _cfgs(synth_root, "config4", [
        "train.device_cache=true", "train.steps=7", "train.steps_per_call=3",
        "train.log_every=1", f"train.ckpt_dir={tmp_path}/dt"])
    state, _ = TT.fit(tc, device="cpu")
    assert state.step == 7 and state.opt_state["count"] == 7
    again, _ = TT.fit(tc, device="cpu")
    assert again.step == 7 and again.opt_state["count"] == 7
    assert [r["step"] for r in MetricsLogger(f"{tmp_path}/dt").read()] == \
        [3, 6, 7]


def test_cached_resume_equals_an_uninterrupted_run(synth_root, tmp_path):
    """A run stopped at step 4 and resumed to 8 skips the consumed index
    positions and ends where the uninterrupted run ends, bit for bit."""
    def run(ckpt, steps):
        _, tc = _cfgs(synth_root, "config4", [
            "train.device_cache=true", "train.steps_per_call=2",
            "train.ckpt_every=4", f"train.steps={steps}",
            "loss.kmeans_interval=3", f"train.ckpt_dir={tmp_path}/{ckpt}"])
        return TT.fit(tc, device="cpu")[0]

    whole = run("f", 8)
    assert run("h", 4).step == 4
    resumed = run("h", 8)
    assert resumed.step == 8
    for k, v in whole.params.items():
        np.testing.assert_array_equal(resumed.params[k].numpy(), v.numpy(),
                                      err_msg=k)
    np.testing.assert_array_equal(resumed.centers.numpy(),
                                  whole.centers.numpy())


def test_cached_fit_refusals(synth_root, tmp_path):
    """The reference's two refusals, with its messages, before any step:
    raw frames, and more than one frame bucket."""
    _, tc = _cfgs(synth_root, "config4", [
        "train.device_cache=true", f"train.ckpt_dir={tmp_path}/r",
        "data.frame_buckets=[4,8]"])
    with pytest.raises(ValueError,
                       match="^device_cache requires a single frame bucket$"):
        TT.fit(tc, device="cpu")
    jc, _ = _cfgs(synth_root, "config4", [
        "train.device_cache=true", f"train.ckpt_dir={tmp_path}/rj",
        "data.frame_buckets=[4,8]"])
    with pytest.raises(ValueError,
                       match="^device_cache requires a single frame bucket$"):
        JT.fit(jc)
    video = replace(tc, data=replace(tc.data, from_videos=True,
                                     annotations=str(tmp_path / "a.jsonl")))
    with pytest.raises(ValueError, match="^device_cache caches features, "
                       "not raw frames; extract first or disable one of "
                       "the two$"):
        TT.fit(video, device="cpu")
    assert not (tmp_path / "r").exists() or not list(
        (tmp_path / "r").glob("state_*.pt"))


def test_cli_trains_cached_on_the_cpu(synth_root, tmp_path, capsys):
    from tests.test_torch_train import OV

    TT.main(["--preset", "config4", "--device", "cpu", "--override", *OV,
             f"data.root={synth_root}", f"train.ckpt_dir={tmp_path}",
             "train.steps=4", "train.log_every=1", "train.device_cache=true",
             "train.steps_per_call=2"])
    out = capsys.readouterr().out
    assert "step=2" in out and "step=4" in out and "step=3" not in out
    assert "frames_per_sec_avg=" in out
    assert sorted(p.name for p in tmp_path.glob("state_*.pt")) == \
        ["state_4.pt"]
