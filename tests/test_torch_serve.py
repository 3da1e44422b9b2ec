"""The port's GroundingServer against the JAX server, on the CPU.

The same segments and weights go to `nafae_tpu.serve.GroundingServer` and
to `nafae_torch.serve.GroundingServer(device="cpu")`: the responses must
have the same structure, equal regions and boxes, and scores and frame
weights within 1e-5 (f32). Also: the same 400 errors, an HTTP round trip,
and the golden config-1 accuracy over the served boxes.
"""

import concurrent.futures
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nafae_tpu.config as jcfg
import nafae_torch.config as tcfg
from nafae_tpu.serve import GroundingServer as JaxServer
from nafae_torch.serve import GroundingServer

GOLDEN_ACC = 0.8961038961038961   # tests/test_e2e.py: oracle params, 69/77


def _cfgs(pool):
    over = ["data.feat_dim=16", "model.feat_dim=16", "model.embed_dim=8",
            "data.max_frames=6", "data.num_regions=4", "data.max_words=3",
            "data.batch_size=4", f"model.frame_pool={pool}",
            "loss.ctx_window=2"]
    return (jcfg.load_config(preset_name="config4", overrides=over),
            tcfg.load_config(preset_name="config4", overrides=over))


def _params(seed=0, d=16, e=8, v=67):
    rng = np.random.RandomState(seed)
    return {"word_emb": rng.randn(v, e).astype(np.float32),
            "w_v": (rng.randn(d, e) / 4).astype(np.float32),
            "b_v": (rng.randn(e) * 0.1).astype(np.float32)}


def _segments(n, seed=0, d=16, t_max=6, r=4, k_max=3):
    rng = np.random.default_rng(seed)
    segs = []
    for i in range(n):
        t = int(rng.integers(1, t_max + 1))
        seg = {"feats": rng.normal(size=(t, r, d)).astype(np.float32),
               "boxes": rng.uniform(0, 100, size=(t, r, 4)).astype(np.float32),
               "word_ids": [int(x) for x in rng.choice(
                   67, int(rng.integers(1, k_max + 1)), replace=False)]}
        if i % 3 == 1:
            rm = (rng.random((t, r)) > 0.3).astype(np.float32)
            rm[0] = 0.0               # a frame with no valid region
            seg["region_mask"] = rm
        segs.append(seg)
    return segs


def _assert_same_response(got, want, tol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert [x["word_id"] for x in g["words"]] == \
            [x["word_id"] for x in w["words"]]
        assert [x["word"] for x in g["words"]] == [x["word"] for x in w["words"]]
        for gw, ww in zip(g["words"], w["words"]):
            assert [f["frame"] for f in gw["frames"]] == \
                [f["frame"] for f in ww["frames"]]
            assert [f["region"] for f in gw["frames"]] == \
                [f["region"] for f in ww["frames"]]
            assert [f["box"] for f in gw["frames"]] == \
                [f["box"] for f in ww["frames"]]
            np.testing.assert_allclose([f["score"] for f in gw["frames"]],
                                       [f["score"] for f in ww["frames"]],
                                       rtol=tol, atol=tol)
        np.testing.assert_allclose(g["frame_weights"], w["frame_weights"],
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(g["video_score"], w["video_score"],
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("pool", ["context", "attention"])
def test_server_matches_jax_server(pool):
    """10 segments at batch 4: two full batches and a ragged one."""
    cj, ct = _cfgs(pool)
    params = _params()
    segs = _segments(10)
    want = JaxServer(cj, {k: jnp.asarray(v) for k, v in params.items()}
                     ).ground_segments(segs)
    got = GroundingServer(ct, params, device="cpu").ground_segments(segs)
    _assert_same_response(got, want)


def test_server_validation_errors_match_jax():
    cj, ct = _cfgs("context")
    params = _params()
    js = JaxServer(cj, {k: jnp.asarray(v) for k, v in params.items()})
    ts = GroundingServer(ct, params, device="cpu")
    f = np.zeros((2, 4, 16), np.float32)
    bad = [{"feats": np.zeros((7, 4, 16), np.float32), "word_ids": [1]},
           {"feats": f, "words": ["onion", "spaceship"]},
           {"feats": f, "word_ids": [1, 2, 3, 4]},
           {"feats": np.zeros((2, 4, 5), np.float32), "word_ids": [1]},
           {"feats": f},
           {"feats": f, "sentence": "nothing to see"}]
    for seg in bad:
        with pytest.raises(ValueError) as ej:
            js._pad_segment(seg)
        with pytest.raises(ValueError) as et:
            ts._pad_segment(seg)
        assert str(et.value) == str(ej.value)


def test_server_dequantizes_int8_requests_at_ingest():
    cj, ct = _cfgs("context")
    params = _params()
    rng = np.random.default_rng(1)
    seg = {"feats": rng.integers(-127, 128, (3, 4, 16)).astype(np.int8),
           "feats_scale": rng.uniform(0.01, 0.1, (3, 4)).astype(np.float32),
           "words": ["onion", "garlic"]}
    want = JaxServer(cj, {k: jnp.asarray(v) for k, v in params.items()}
                     ).ground_segments([seg])
    got = GroundingServer(ct, params, device="cpu").ground_segments([seg])
    _assert_same_response(got, want)


def _quant_cfgs(pool, quantize):
    cj, ct = _cfgs(pool)
    cj.model.quantize = ct.model.quantize = quantize
    return cj, ct


def _prequantized(segs):
    """The same segments in the extract --quantize int8 wire format."""
    from nafae_torch.extract import quantize_feats_np

    out = []
    for seg in segs:
        q, sf = quantize_feats_np(seg["feats"])
        out.append({**seg, "feats": q, "feats_scale": sf})
    return out


def test_server_refuses_later_slices():
    """model.quantize=int8pre, which the first slices of the port refused,
    now serves as the JAX server does: f32 requests quantized at ingest
    and pre-quantized ones passed through give the same answers, and the
    weights are quantized once, at init."""
    cj, ct = _quant_cfgs("context", "int8pre")
    params = _params()
    segs = _segments(6, seed=3)
    js = JaxServer(cj, {k: jnp.asarray(v) for k, v in params.items()})
    ts = GroundingServer(ct, params, device="cpu")
    assert set(ts.params) == {"word_emb", "b_v", "w_v.q8", "w_v.scale8"}
    assert ts.params["w_v.q8"].dtype == torch.int8
    want = js.ground_segments(segs)
    _assert_same_response(ts.ground_segments(segs), want)
    _assert_same_response(ts.ground_segments(_prequantized(segs)), want)
    sample = ts._pad_segment(segs[0])
    assert sample["feats"].dtype == np.int8
    assert sample["feats_scale"].shape == (6, 4)


@pytest.mark.parametrize("quantize", ["int8", "int8pre"])
@pytest.mark.parametrize("pool", ["context", "attention"])
def test_int8_servers_match_jax_server(pool, quantize):
    """10 segments at batch 4 (a ragged last batch), f32 requests and, for
    int8pre, pre-quantized ones; a float server dequantizes the latter."""
    cj, ct = _quant_cfgs(pool, quantize)
    params = _params(1)
    segs = _segments(10, seed=4)
    if quantize == "int8pre":
        segs = segs[:5] + _prequantized(segs[5:])
    want = JaxServer(cj, {k: jnp.asarray(v) for k, v in params.items()}
                     ).ground_segments(segs)
    got = GroundingServer(ct, params, device="cpu").ground_segments(segs)
    _assert_same_response(got, want)


def _start_http(srv):
    box, ready = {}, threading.Event()
    th = threading.Thread(
        target=srv.serve_http,
        kwargs=dict(host="127.0.0.1", port=0, max_segments=4,
                    ready_cb=lambda h: (box.update(h=h), ready.set())),
        daemon=True)
    th.start()
    assert ready.wait(30)
    return box["h"], th, f"http://127.0.0.1:{box['h'].server_address[1]}"


def _post(base, payload):
    req = urllib.request.Request(base + "/ground",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_http_round_trip():
    """Concurrent requests coalesce and equal the in-process answers;
    /healthz names the torch device; bad requests get 400 with the JAX
    server's message."""
    _, ct = _cfgs("context")
    srv = GroundingServer(ct, _params(), device="cpu")
    segs = _segments(6, seed=2)
    wire = [{k: v.tolist() if isinstance(v, np.ndarray) else v
             for k, v in s.items()} for s in segs]
    want = srv.ground_segments(segs)
    httpd, th, base = _start_http(srv)
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["backend"] == "cpu"
        assert health["batch_size"] == 4
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            outs = list(ex.map(lambda i: _post(
                base, {"segments": wire[2 * i:2 * i + 2]}), range(3)))
        # equal up to the last bits: a segment may sit at another row of
        # its batch over HTTP, and CPU matmuls round by row position
        _assert_same_response([r for o in outs for r in o["results"]], want)
        for payload, match in (
                ({"segments": wire[:1] * 5}, "max_segments"),
                ({"segments": [{"feats": wire[0]["feats"],
                                "words": ["nope"]}]}, "unknown object words"),
                ({"nothing": 1}, "segments")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base, payload)
            assert ei.value.code == 400
            assert match in json.loads(ei.value.read())["error"]
    finally:
        httpd.shutdown()
        th.join(30)
    assert not th.is_alive()


def test_int8pre_http_round_trip():
    """int8pre over HTTP with pre-quantized requests (int8 feats and scales
    as JSON lists): the in-process answers."""
    _, ct = _quant_cfgs("context", "int8pre")
    srv = GroundingServer(ct, _params(), device="cpu")
    segs = _prequantized(_segments(4, seed=5))
    wire = [{k: v.tolist() if isinstance(v, np.ndarray) else v
             for k, v in s.items()} for s in segs]
    want = srv.ground_segments(segs)
    httpd, th, base = _start_http(srv)
    try:
        got = _post(base, {"segments": wire})["results"]
    finally:
        httpd.shutdown()
        th.join(30)
    _assert_same_response(got, want)


def test_golden_accuracy_over_served_boxes(synth_root):
    """Serve the val fixture with the tests/test_e2e.py oracle params and
    score the served boxes with the port's grounding_hits: exactly the
    JAX package's golden accuracy (69/77)."""
    from nafae_torch.data.synthetic import _class_directions
    from nafae_torch.ops.iou import grounding_hits

    cfg = tcfg.load_config(preset_name="config1", overrides=[
        "data.feat_dim=64", "model.feat_dim=64", "model.embed_dim=32",
        f"data.root={synth_root}"])
    dirs = _class_directions(67, 64)
    w = dirs.T[:, :32].astype(np.float32)
    srv = GroundingServer(cfg, {"word_emb": dirs @ w, "w_v": w,
                                "b_v": np.zeros(32, np.float32)},
                          device="cpu")
    with open(f"{synth_root}/val/index.jsonl") as f:
        metas = [json.loads(ln) for ln in f if ln.strip()]
    files = [np.load(f"{synth_root}/val/{m['file']}") for m in metas]
    segs = [{"feats": z["feats"].astype(np.float32), "boxes": z["boxes"],
             "word_ids": z["word_ids"].tolist()} for z in files]
    results = srv.ground_segments(segs)
    hits = total = 0.0
    for z, res in zip(files, results):
        region = np.array([[fr["region"] for fr in w_["frames"]]
                           for w_ in res["words"]])            # [K,T]
        r = z["boxes"].shape[1]
        s = torch.from_numpy(np.eye(r, dtype=np.float32)[region][None])
        c, m = grounding_hits(s, torch.from_numpy(z["boxes"][None]),
                              torch.from_numpy(z["gt_boxes"][None]),
                              torch.from_numpy(z["gt_mask"][None]))
        hits += c.sum().item()
        total += m.sum().item()
    assert (hits, total) == (69, 77)
    np.testing.assert_allclose(hits / total, GOLDEN_ACC, atol=1e-9)
