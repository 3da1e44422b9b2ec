"""The port's exported serving artifact (nafae_torch.serve.export_grounding
/ load_exported / `--export`), on the CPU.

The round trip must equal the live GroundingServer bit for bit, for an f32
artifact, one stored int8 (against a live server on the dequantized
params), one with int8 compute and one with int8pre's calling convention.
The program holds the context mix as the custom op nafae::ctx_mix_fwd (K1f
on a card). Wrong shapes, dtypes and signatures raise; an artifact
exported on a card raises without one. `params.npz` is the one part the
two packages share: the storage quantization and its inverse equal the
JAX package's bit for bit.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nafae_torch.config as tcfg
from nafae_tpu import serve as JS
from nafae_torch import serve as TS
from nafae_torch.ops.kernels import ctx_mix as K

OVER = ["data.feat_dim=16", "model.feat_dim=16", "model.embed_dim=8",
        "data.max_frames=6", "data.num_regions=4", "data.max_words=3",
        "data.batch_size=4", "model.frame_pool=context", "loss.ctx_window=2"]
# artifact kind -> (model.quantize, export's storage quantize)
KINDS = {"f32": ("", None), "storage_int8": ("", "int8"),
         "int8": ("int8", None), "int8pre": ("int8pre", None)}


def _cfg(quantize=""):
    return tcfg.load_config(preset_name="config4",
                            overrides=OVER + [f"model.quantize={quantize}"])


def _params(seed=0, d=16, e=8, v=67):
    rng = np.random.RandomState(seed)
    return {"word_emb": rng.randn(v, e).astype(np.float32),
            "w_v": (rng.randn(d, e) / 4).astype(np.float32),
            "b_v": (rng.randn(e) * 0.1).astype(np.float32)}


def _batch(srv, seed=0):
    """One full padded batch of the server's bucket (a pre-quantized
    segment among f32 ones)."""
    rng = np.random.default_rng(seed)
    segs = [{"feats": rng.normal(size=(t, 4, 16)).astype(np.float32),
             "boxes": rng.uniform(0, 99, (t, 4, 4)).astype(np.float32),
             "word_ids": [int(x) for x in rng.choice(67, 2, replace=False)]}
            for t in (6, 3, 5, 1)]
    samples = [srv._pad_segment(s) for s in segs]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _args(batch):
    return [batch[k] for k in ("feats", "boxes", "word_ids", "frame_mask",
                               "word_mask", "region_mask")] \
        + ([batch["feats_scale"]] if "feats_scale" in batch else [])


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    out = {}
    for kind, (quantize, storage) in KINDS.items():
        d = str(tmp_path_factory.mktemp(kind))
        TS.export_grounding(_cfg(quantize), _params(), d, quantize=storage,
                            device="cpu")
        out[kind] = d
    return out


@pytest.mark.parametrize("kind", list(KINDS))
def test_round_trip_equals_the_live_server(artifacts, kind):
    quantize, storage = KINDS[kind]
    call, manifest = TS.load_exported(artifacts[kind])
    params = _params()
    if storage == "int8":
        params = TS.dequantize_params(TS.quantize_params(params))
    srv = TS.GroundingServer(_cfg(quantize), params, device="cpu")
    batch = _batch(srv)
    live = srv.run_batch(batch)
    got = call(*_args(batch))
    assert set(got) == set(live)
    for k in live:
        np.testing.assert_array_equal(got[k].numpy(), live[k], err_msg=k)
    assert manifest["quantize"] == storage
    assert manifest["model"]["compute_quantize"] == quantize
    assert manifest["device"] == "cpu"
    assert manifest["torch_version"] == torch.__version__
    assert (manifest["batch_size"], manifest["max_frames"],
            manifest["num_regions"], manifest["feat_dim"],
            manifest["max_words"]) == (4, 6, 4, 16, 3)
    assert call.manifest == manifest
    assert set(call.params) == set(srv.params)
    # the context mix is in the program as the custom op (K1f on a card),
    # not as the plain version's products
    targets = [str(n.target) for n in call.exported.graph.nodes
               if n.op == "call_function"]
    assert targets.count("nafae.ctx_mix_fwd.default") == 1
    with open(os.path.join(artifacts[kind], TS.PARAMS_NPZ), "rb") as f:
        stored = dict(np.load(f))
    if storage == "int8":
        assert stored["word_emb.q"].dtype == np.int8
    if quantize:
        assert stored["w_v.q8"].dtype == np.int8 and "w_v" not in stored


def test_wrong_arguments_raise(artifacts):
    call, _ = TS.load_exported(artifacts["f32"])
    srv = TS.GroundingServer(_cfg(), _params(), device="cpu")
    args = _args(_batch(srv))
    with pytest.raises(ValueError, match=r"feats must be \(4, 6, 4, 16\)"):
        call(args[0][:3], *args[1:])
    with pytest.raises(TypeError, match="word_ids must be torch.int32"):
        call(*args[:2], args[2].astype(np.int64), *args[3:])
    with pytest.raises(ValueError, match="exported signature"):
        call(*args, args[-1])
    pre, _ = TS.load_exported(artifacts["int8pre"])
    with pytest.raises(ValueError, match="takes feats_scale"):
        pre(*args)


def test_cuda_artifact_needs_a_card(artifacts, tmp_path, monkeypatch):
    import shutil

    d = str(tmp_path / "cuda_art")
    shutil.copytree(artifacts["f32"], d)
    path = os.path.join(d, TS.MANIFEST)
    with open(path) as f:
        manifest = json.load(f)
    manifest["device"] = "cuda"
    with open(path, "w") as f:
        json.dump(manifest, f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="exported on a CUDA device"):
        TS.load_exported(d)


@pytest.mark.parametrize("seed", [0, 1])
def test_storage_quantization_is_jax_bit_for_bit(seed):
    """quantize_params equals the JAX package's; dequantize_params of the
    JAX package's quantize_params output equals its own, bit for bit
    (the int8 compute pair passes through)."""
    params = _params(seed)
    params["m_sim"] = np.eye(8, dtype=np.float32)
    params["w_v.q8"] = np.arange(-8, 8, dtype=np.int8).reshape(4, 4)
    params["w_v.scale8"] = np.full((1, 4), 0.5, np.float32)
    want = JS.quantize_params({k: jnp.asarray(v) for k, v in params.items()})
    got = TS.quantize_params(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        assert got[k].dtype == np.asarray(want[k]).dtype
    got = TS.dequantize_params({k: np.asarray(v) for k, v in want.items()})
    ref = JS.dequantize_params({k: np.asarray(v) for k, v in want.items()})
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_cli_export(tmp_path, capsys):
    npz = str(tmp_path / "params.npz")
    p = _params()
    np.savez(npz, **p)
    out = str(tmp_path / "art")
    rc = TS.main(["--preset", "config4", "--override", *OVER,
                  "model.quantize=int8pre",
                  "--checkpoint", npz, "--export", out, "--quantize", "int8",
                  "--device", "cpu"])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == {"exported": out, "quantize": "int8"}
    assert sorted(os.listdir(out)) == sorted([TS.MANIFEST, TS.PARAMS_NPZ,
                                              TS.PROGRAM])
    call, manifest = TS.load_exported(out)
    assert manifest["model"]["compute_quantize"] == "int8pre"
    assert manifest["quantize"] == "int8"
    srv = TS.GroundingServer(_cfg("int8pre"), p, device="cpu")
    batch = _batch(srv, seed=2)
    got = call(*_args(batch))
    # w_v is compute-quantized first, then stored as it is; word_emb is
    # stored int8 and dequantized: compare with a server on those params
    from nafae_torch.models.grounding import inference_params
    srv2 = TS.GroundingServer(_cfg("int8pre"), TS.dequantize_params(
        TS.quantize_params(inference_params(_cfg("int8pre"), p))),
        device="cpu")
    live = srv2.run_batch(batch)
    for k in live:
        np.testing.assert_array_equal(got[k].numpy(), live[k], err_msg=k)
    K.launches["ctx_mix_fwd"] = 0          # the CPU never launches K1f
    call(*_args(batch))
    assert K.launches["ctx_mix_fwd"] == 0
