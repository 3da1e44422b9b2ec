"""Parameters across the two packages: params_from_jax, GroundingModel,
init_params and load_eval_params (the converted .npz form, and the JAX
package's orbax checkpoint directory)."""

import hashlib
import json
import pathlib
import shutil

import jax
import numpy as np
import pytest
import torch

from nafae_tpu.models.grounding import init_params as jax_init_params
from nafae_torch.config import load_config
from nafae_torch.models.grounding import (GroundingModel, init_params,
                                          param_shapes, params_from_jax)
from nafae_torch.ops.grounding import ground_forward
from nafae_torch.utils.checkpoint import load_eval_params

OVER = ["data.feat_dim=16", "model.feat_dim=16", "model.embed_dim=8"]


def _cfg(*extra):
    return load_config(preset_name="config4", overrides=OVER + list(extra))


@pytest.mark.parametrize("extra", [[], ["model.frame_pool=learned",
                                        "model.similarity=bilinear"]])
def test_params_from_jax_round_trip(extra):
    """The JAX param dict carries across in its own layout (w_v stays
    [D,E]) and comes back bit for bit."""
    import nafae_tpu.config as jcfg
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg.load_config(
        preset_name="config4", overrides=OVER + extra).model)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    assert set(tp) == set(jp) == set(param_shapes(_cfg(*extra).model))
    for k in jp:
        assert tuple(tp[k].shape) == param_shapes(_cfg(*extra).model)[k]
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    assert tuple(tp["w_v"].shape) == (16, 8)


def test_init_params_and_model_forward():
    cfg = _cfg()
    p1 = init_params(cfg.model, torch.Generator().manual_seed(3), "cpu")
    p2 = init_params(cfg.model, torch.Generator().manual_seed(3), "cpu")
    if not torch.cuda.is_available():       # the default device is cuda
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_params(cfg.model, torch.Generator().manual_seed(3))
    assert {k: tuple(v.shape) for k, v in p1.items()} == \
        param_shapes(cfg.model)
    for k in p1:
        assert torch.equal(p1[k], p2[k])
    model = GroundingModel.from_config(cfg, p1)
    assert model.ctx_window == cfg.loss.ctx_window
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(2, 5, 4, 16).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 67, (2, 3)).astype(np.int32))
    fm, wm = torch.ones(2, 5), torch.ones(2, 3)
    got = model(feats, ids, fm, wm)
    want = ground_forward(p1, feats, ids, fm, wm, pool="context",
                          ctx_window=cfg.loss.ctx_window,
                          ctx_temp=cfg.loss.ctx_temp)
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k])
    with pytest.raises(KeyError, match="m_sim"):
        GroundingModel(_cfg("model.similarity=bilinear").model, p1)


def test_load_eval_params(tmp_path):
    cfg = _cfg()
    rng = np.random.RandomState(1)
    stored = {k: rng.randn(*s).astype(np.float32)
              for k, s in param_shapes(cfg.model).items()}
    path = str(tmp_path / "params.npz")
    np.savez(path, **stored)
    got = load_eval_params(cfg, path, device="cpu")
    for k, v in stored.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    wrong = dict(stored, w_v=np.zeros((17, 8), np.float32))
    np.savez(str(tmp_path / "wrong.npz"), **wrong)
    with pytest.raises(ValueError, match="'w_v' has shape"):
        load_eval_params(cfg, str(tmp_path / "wrong.npz"), device="cpu")
    assert load_eval_params(cfg, str(tmp_path / "missing"),
                            device="cpu") is None
    (tmp_path / "orbax" / "4").mkdir(parents=True)   # an orbax step dir
    with pytest.raises(ValueError, match="4/default/_METADATA is missing"):
        load_eval_params(cfg, str(tmp_path / "orbax"), device="cpu")
    # the JAX package's orbax checkpoint of config 4 loads (its params)
    fixture = pathlib.Path(__file__).parent / "data" / "orbax_config4"
    ck = shutil.copytree(fixture, tmp_path / "ck")
    got = load_eval_params(load_config(preset_name="config4"), str(ck),
                           device="cpu")
    leaves = json.loads((fixture / "expected.json").read_text())["leaves"]
    assert set(got) == {"b_v", "w_v", "word_emb"}
    for k, v in got.items():
        want = leaves[f"params.{k}"]
        assert [str(v.dtype).removeprefix("torch."), list(v.shape)] == [
            want["dtype"], want["shape"]], k
        assert hashlib.sha256(v.numpy().tobytes()).hexdigest() == \
            want["sha256"], k
