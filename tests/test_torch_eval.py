"""The port's evaluation (nafae_torch.evaluate) against the JAX package's.

The same numpy params and the same synthetic val split (tests/conftest.py's
`synth_root`: 12 segments, 77 annotated (word, frame) pairs) go to
`nafae_tpu.evaluate` and to `nafae_torch.evaluate` on the CPU: the
result dicts must agree, counts exactly (num_annotations, num_classes_seen,
the classes seen) and the accuracies to 1e-12, with a batch size that
divides the split and one that leaves a ragged final batch. Also: the
oracle params reach the golden 69/77 through `evaluate_config`, a config-4
checkpoint of the port (a 2-step `fit`) evaluates under the config1 preset,
`require_checkpoint` raises without a checkpoint, the int8 forms
(model.quantize=int8 / int8pre) give the JAX package's dict, and the CLI
prints the reference's JSON.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

import nafae_tpu.config as jcfg
import nafae_torch.config as tcfg
from nafae_tpu import evaluate as JE
from nafae_tpu.data import SegmentDataset as JDataset
from nafae_tpu.data.synthetic import _class_directions
from nafae_torch import evaluate as TE
from nafae_torch import train as TT
from nafae_torch.data.youcook2 import SegmentDataset as TDataset

GOLDEN_ACC = 0.8961038961038961   # tests/test_e2e.py: oracle params, 69/77
SMALL = ["data.feat_dim=64", "model.feat_dim=64", "model.embed_dim=32"]
ACC_TOL = 1e-12


def _cfgs(root, preset="config1", extra=()):
    ov = SMALL + [f"data.root={root}"] + list(extra)
    return (jcfg.load_config(preset_name=preset, overrides=ov),
            tcfg.load_config(preset_name=preset, overrides=ov))


def _params(seed=0, v=67, d=64, e=32):
    rng = np.random.RandomState(seed)
    return {"word_emb": rng.randn(v, e).astype(np.float32),
            "w_v": (rng.randn(d, e) / 8).astype(np.float32),
            "b_v": (rng.randn(e) * 0.1).astype(np.float32)}


def _oracle(v=67, d=64, e=32):
    dirs = _class_directions(v, d)
    w = dirs.T[:, :e].astype(np.float32)
    return {"word_emb": (dirs @ w).astype(np.float32), "w_v": w,
            "b_v": np.zeros(e, np.float32)}


def _assert_same_result(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    assert got["num_annotations"] == want["num_annotations"]
    assert got["num_classes_seen"] == want["num_classes_seen"]
    for k in ("box_acc_micro", "box_acc_macro"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ACC_TOL,
                                   err_msg=k)
    if "per_class_acc" in want:
        assert sorted(got["per_class_acc"]) == sorted(want["per_class_acc"])
        for c, acc in want["per_class_acc"].items():
            np.testing.assert_allclose(got["per_class_acc"][c], acc, rtol=0,
                                       atol=ACC_TOL, err_msg=str(c))


@pytest.mark.parametrize("batch_size", [4, 5])     # 12 = 3x4; 5 + 5 + 2
@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_matches_the_jax_package(synth_root, batch_size, seed):
    args = (synth_root, "val", 8, 6, 64, 3)
    params = _params(seed)
    got = TE.evaluate(params, TDataset(*args, with_gt=True), batch_size, 67,
                      device="cpu")
    want = JE.evaluate({k: jnp.asarray(v) for k, v in params.items()},
                       JDataset(*args, with_gt=True), batch_size, 67)
    _assert_same_result(got, want)
    assert got["num_annotations"] == 77


def test_golden_accuracy_through_evaluate_config(synth_root):
    jc, tc = _cfgs(synth_root)
    got = TE.evaluate_config(tc, params=_oracle(), device="cpu")
    np.testing.assert_allclose(got["box_acc_micro"], GOLDEN_ACC, rtol=0,
                               atol=1e-9)
    assert got["num_annotations"] == 77
    want = JE.evaluate_config(jc, params={k: jnp.asarray(v)
                                          for k, v in _oracle().items()})
    _assert_same_result(got, want)


def test_config4_checkpoint_evaluates_under_config1(synth_root, tmp_path):
    """A config-4 training state (2 steps of the port's fit, checkpointed)
    evaluates under the config1 preset from its directory, params only,
    and equals both packages' evaluate on the state's params."""
    from tests.test_torch_train import OV

    ck = str(tmp_path / "ck")
    tc4 = tcfg.load_config(preset_name="config4", overrides=OV + [
        f"data.root={synth_root}", f"train.ckpt_dir={ck}", "train.steps=2"])
    state, _ = TT.fit(tc4, device="cpu")
    jc, tc = _cfgs(synth_root, extra=[f"train.ckpt_dir={ck}"])
    got = TE.evaluate_config(tc, require_checkpoint=True, device="cpu")
    params = {k: v.numpy() for k, v in state.params.items()}
    assert got == TE.evaluate(params, TDataset(synth_root, "val", 8, 6, 64, 3,
                                               with_gt=True),
                              tc.data.batch_size, 67, device="cpu")
    want = JE.evaluate_config(jc, params={k: jnp.asarray(v)
                                          for k, v in params.items()})
    _assert_same_result(got, want)


def test_require_checkpoint_raises_without_one(synth_root, tmp_path):
    _, tc = _cfgs(synth_root, extra=[f"train.ckpt_dir={tmp_path}/none"])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        TE.evaluate_config(tc, require_checkpoint=True, device="cpu")
    r = TE.evaluate_config(tc, device="cpu")          # the random init
    assert r["num_annotations"] == 77
    assert 0.0 <= r["box_acc_micro"] <= 1.0


@pytest.mark.parametrize("quantize", ["int8", "int8pre"])
def test_int8_raises(synth_root, tmp_path, quantize):
    """model.quantize=int8 / int8pre, which the first slices of the port
    refused, evaluate as the JAX package does: the same dict, so the same
    counts as tests/test_e2e.py's int8 goldens (70 of 77 hits with the
    oracle params, against 69 in f32; that test allows 2 points). int8pre
    reads int8 feature files; on float files it raises the reference's
    error."""
    from tests.test_torch_int8 import _int8_root

    root = synth_root
    if quantize == "int8pre":
        _, tc = _cfgs(synth_root, extra=[f"model.quantize={quantize}"])
        with pytest.raises(ValueError, match="needs int8 feature files"):
            TE.evaluate_config(tc, params=_oracle(), device="cpu")
        root = _int8_root(synth_root, tmp_path)
    jc, tc = _cfgs(root, extra=[f"model.quantize={quantize}"])
    got = TE.evaluate_config(tc, params=_oracle(), device="cpu")
    want = JE.evaluate_config(jc, params={k: jnp.asarray(v)
                                          for k, v in _oracle().items()})
    _assert_same_result(got, want)
    assert got["num_annotations"] == 77
    assert round(got["box_acc_micro"] * 77) == 70
    # random params: the int8 argmax moves against f32, the same way in
    # both packages
    got = TE.evaluate_config(tc, params=_params(3), device="cpu")
    want = JE.evaluate_config(jc, params={k: jnp.asarray(v)
                                          for k, v in _params(3).items()})
    _assert_same_result(got, want)


@pytest.mark.parametrize("per_class", [False, True])
def test_cli_prints_the_reference_json(synth_root, tmp_path, capsys,
                                       per_class):
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **_params(2))
    args = ["--preset", "config1", "--override", *SMALL,
            f"data.root={synth_root}", "--checkpoint", npz]
    if per_class:
        args.append("--per-class")
    JE.main(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    TE.main(args + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ("per_class_acc" in got) == per_class
    _assert_same_result(got, want)
