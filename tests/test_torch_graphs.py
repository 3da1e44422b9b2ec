"""The port's inference programs and the config-5 step as device programs
(nafae_torch.utils.cuda_graph.Graphed under serving, eval and feature
extraction; config 5's step in nafae_torch.train.TrainFn), on the CPU.

On the card each program replays a CUDA graph of its eager body; on the
CPU the body runs eagerly, and here also through a stand-in capture that
keeps the card's bookkeeping (static input buffers, warm-up calls, the
outputs of one capture rewritten by each replay) and replays the body
eagerly. Held: `Graphed`'s graph a key (shapes and static arguments),
its warm-up calls and their launches counted apart, a capture's launches
added once a replay; threads calling `ground_segments` at once get the
serial answers (the server's lock over copy, replay and read-back);
`evaluate` twice with different params against the JAX package's jitted
`_eval_batch`, counts exact, each call scoring its own params;
`make_extract_fn` against JAX's jitted `make_extract_fn` within the
detector's tolerance (1e-4 of each tensor's largest entry); the port's
config-5 `build_train_fn` against JAX's `build_train_fn(cfg,
extractor=...)` with `make_multi_step` at spc 2 on 128x128 frames,
params within 1e-5. On a card only (marked `cuda`): each graph bit for
bit its eager body.
"""

import contextlib
import functools
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

import nafae_tpu.config as jcfg
import nafae_torch.config as tcfg
from nafae_tpu import evaluate as JE
from nafae_tpu import extract as JX
from nafae_tpu import train as JT
from nafae_tpu.data import SegmentDataset as JDataset
from nafae_tpu.models.detector.faster_rcnn import init_detector as j_init
from nafae_torch import evaluate as TE
from nafae_torch import train as TT
from nafae_torch.data.youcook2 import SegmentDataset as TDataset
from nafae_torch.models.detector.faster_rcnn import (
    FasterRCNNExtractor, detector_params_from_jax)
from nafae_torch.models.grounding import state_from_jax
from nafae_torch.serve import GroundingServer
from nafae_torch.utils import cuda_graph as CG
from tests.test_torch_build_train_fn import _StandInCapture
from tests.test_torch_serve import _cfgs as _serve_cfgs
from tests.test_torch_serve import _params as _serve_params
from tests.test_torch_serve import _segments

CPU = torch.device("cpu")
# the inline config-5 shapes of tests/test_torch_inline.py at 128x128
C5 = ["model.feat_dim=2048", "model.embed_dim=32", "data.batch_size=2",
      "data.max_frames=3", "data.num_regions=4", "data.max_words=3",
      "loss.num_clusters=4", "loss.ctx_window=2", "loss.kmeans_interval=1",
      "detector.image_size=128", "detector.num_proposals=4",
      "detector.rpn_pre_nms_topk=16", "detector.anchor_scales=[16,32]",
      "train.donate=false", "train.warmup_steps=0"]


class _StandInGraph:
    """Replays a recorded body eagerly and writes what it returns into the
    outputs of the capture (its launches set apart: a replay counts
    through the accounting)."""

    def __init__(self, body, out):
        self.body, self.out = body, out

    def replay(self):
        with CG.set_apart({}):
            new = self.body()
        with torch.inference_mode():     # the outputs may be inference tensors
            for o, n in zip(pytree.tree_leaves(self.out[0]),
                            pytree.tree_leaves(new)):
                o.copy_(n)


class _StandInGraphed(CG.Graphed):
    """Graphed with a stand-in capture on the CPU: static buffers,
    warm-up calls and launch accounting as on the card."""

    def __init__(self, fn, device):
        super().__init__(fn, device)
        self.graphed = True

    def _side(self):
        return contextlib.nullcontext()

    def _record(self, body):
        out = []
        step = CG.capture(lambda: out.append(body()),
                          _StandInGraph(body, out), contextlib.nullcontext())
        return step, out[0]


@pytest.fixture(params=["eager", "stand-in graph"])
def programs(request, monkeypatch):
    """The CPU's eager programs, or programs through the stand-in capture
    (eval's kept programs emptied for the test)."""
    monkeypatch.setattr(TE, "_PROGRAMS", {})
    if request.param == "stand-in graph":
        monkeypatch.setattr(CG, "Graphed", _StandInGraphed)
    return request.param


def test_graphed_keeps_a_graph_a_key(monkeypatch):
    """A capture for each key of shapes and static arguments, none more
    for a key seen before; WARMUP_STEPS warm-up calls a capture with their
    launches set apart; a capture's launches added once a replay; each
    call's outputs those of the eager fn on its args, in the same
    buffers."""
    from nafae_torch.ops.kernels import ctx_mix

    monkeypatch.setattr(ctx_mix, "launches", dict(ctx_mix.launches))
    was = ctx_mix.launches["ctx_mix_fwd"]
    calls = []

    def body(x, extra, scale):
        y = x * scale + extra["b"]
        return {"y": y, "n": y.sum() if extra["m"] is None
                else (y * extra["m"]).sum()}

    def fn(x, extra, scale=1.0):
        calls.append(tuple(x.shape))
        ctx_mix.launches["ctx_mix_fwd"] += 1      # as a kernel wrapper counts
        return body(x, extra, scale)

    prog = _StandInGraphed(fn, CPU)
    rng = np.random.RandomState(0)
    seen = []
    for shape, scale, mask in [((2, 3), 2.0, False), ((2, 3), 2.0, False),
                               ((2, 3), 3.0, False), ((4, 3), 2.0, False),
                               ((2, 3), 2.0, True), ((2, 3), 2.0, False)]:
        x = rng.randn(*shape).astype(np.float32)
        b = torch.from_numpy(rng.randn(3).astype(np.float32))
        m = (rng.rand(*shape) > 0.5).astype(np.float32) if mask else None
        out = prog(x, {"b": b, "m": m}, scale=scale)
        want = body(torch.from_numpy(x), {"b": b, "m": None if m is None
                                          else torch.from_numpy(m)}, scale)
        assert torch.equal(out["y"], want["y"]) and \
            torch.equal(out["n"], want["n"])
        seen.append(out)
    assert prog.stats["graphs"] == 4 and prog.stats["replays"] == 6
    assert prog.stats["warmup_calls"] == 4 * CG.WARMUP_STEPS
    assert prog.stats["warmup_launches"] == {
        "ctx_mix_fwd": 4 * CG.WARMUP_STEPS}
    assert ctx_mix.launches["ctx_mix_fwd"] == was + 6
    assert seen[0] is seen[1] is seen[5]        # one key, one set of outputs
    assert seen[2] is not seen[0] and seen[4] is not seen[0]
    # per capture: the warm-up calls, the captured call; then a call a
    # replay of the stand-in
    assert len(calls) == 4 * (CG.WARMUP_STEPS + 1) + 6


def test_graphed_runs_eagerly_off_the_card():
    prog = CG.Graphed(lambda x, y: x + (0 if y is None else y), CPU)
    assert not prog.graphed
    assert torch.equal(prog(np.ones(3, np.float32), None), torch.ones(3))
    assert prog.stats["graphs"] == 0 and prog.stats["replays"] == 0


def test_server_threads_get_the_serial_answers(programs):
    """8 threads call ground_segments at once,
    each over its own segments, with a short switch interval: each gets
    the answers that a serial call gives. Under the stand-in capture the
    batch passes through shared static buffers, which the server's lock
    guards."""
    _, tc = _serve_cfgs("context")
    srv = GroundingServer(tc, _serve_params(), device="cpu")
    groups = [_segments(5, seed=s) for s in range(8)]
    serial = [srv.ground_segments(g) for g in groups]
    got = [[] for _ in groups]

    def worker(i):
        for _ in range(3):
            got[i].append(srv.ground_segments(groups[i]))

    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(groups))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(was)
    assert not any(t.is_alive() for t in threads)
    assert got == [[want] * 3 for want in serial]
    if programs == "stand-in graph":
        assert srv._program.stats["graphs"] == 1


def _eval_params(seed, v=67, d=64, e=32):
    rng = np.random.RandomState(seed)
    return {"word_emb": rng.randn(v, e).astype(np.float32),
            "w_v": (rng.randn(d, e) / 8).astype(np.float32),
            "b_v": (rng.randn(e) * 0.1).astype(np.float32)}


def test_evaluate_twice_scores_each_params(synth_root, programs):
    """Two evaluate calls with different params, each against the JAX
    package's evaluate (its jitted _eval_batch) on the same numpy inputs:
    counts and accuracies exact, so the second call scores its own
    params, not those an earlier capture saw."""
    args = (synth_root, "val", 8, 6, 64, 3)
    results = []
    for seed in (0, 1):
        params = _eval_params(seed)
        got = TE.evaluate(params, TDataset(*args, with_gt=True), 5, 67,
                          device="cpu")
        want = JE.evaluate({k: jnp.asarray(v) for k, v in params.items()},
                           JDataset(*args, with_gt=True), 5, 67)
        assert got == want
        results.append(got)
    assert results[0] != results[1]
    if programs == "stand-in graph":
        (prog,) = TE._PROGRAMS.values()
        assert prog.stats["graphs"] == 1 and prog.stats["replays"] == 6


@pytest.fixture(scope="module")
def detector():
    ov = [o for o in C5 if not o.startswith("detector.image_size")] + [
        "detector.image_size=64"]
    jc = jcfg.load_config(preset_name="config5", overrides=ov)
    tc = tcfg.load_config(preset_name="config5", overrides=ov)
    model, params = j_init(jax.random.PRNGKey(1), jc.detector)
    tdet = FasterRCNNExtractor(tc.detector).eval()
    tdet.load_state_dict(detector_params_from_jax(
        jax.tree.map(np.asarray, params)))
    frames = np.random.RandomState(2).rand(4, 64, 64, 3).astype(np.float32)
    return jc, tc, params, tdet, frames


def _clear_of_ties(scores, valid, gap=1e-5):
    return np.asarray([np.sum(v > 0) < 2 or np.diff(np.sort(s[v > 0])).min()
                       > gap for s, v in zip(scores, valid)])


def test_make_extract_fn_matches_jax(detector, programs):
    """The port's extraction program against JAX's jitted
    make_extract_fn on the same frames and weights: region_valid equal,
    and where a frame's scores are clear of ties, boxes within 1e-4 of
    the image size and feats and scores within 1e-4 / 1e-5 of their
    largest entry; a second chunk through the same program too."""
    from nafae_torch.extract import make_extract_fn

    jc, tc, params, tdet, frames = detector
    jfn, jp = JX.make_extract_fn(jc, params=params)
    fn, _ = make_extract_fn(tc, model=tdet, device="cpu")
    for chunk in (frames, frames[::-1].copy()):
        want = jax.tree.map(np.asarray, jfn(jp, jnp.asarray(chunk)))
        got = fn(chunk)
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["region_valid"],
                                      want["region_valid"])
        clear = _clear_of_ties(want["scores"], want["region_valid"])
        assert clear.any()
        np.testing.assert_allclose(got["boxes"][clear], want["boxes"][clear],
                                   rtol=0, atol=64 * 1e-4)
        for k, frac in (("feats", 1e-4), ("scores", 1e-5)):
            w = want[k][clear]
            np.testing.assert_allclose(got[k][clear], w, rtol=0,
                                       atol=frac * np.abs(w).max(),
                                       err_msg=k)
    if programs == "stand-in graph":
        assert fn.program.stats["graphs"] == 1
        assert fn.program.stats["replays"] == 2


class _FakeStream:
    def wait_stream(self, other):
        pass


class _Replayer:
    """A recording that runs nothing when it is made (a capture computes
    nothing) and runs its body eagerly at each replay."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


def test_train_fn_capture_runs_on_the_cpu(synth_root, monkeypatch):
    """TrainFn's own capture path (both refresh graphs of a shape, each
    after its warm-up steps on clones of the state) with CUDA's streams
    stood in for and a recording that replays its body eagerly: a 2-step
    run reaching both graphs captures both at step 0, warms up 2 x
    WARMUP_STEPS steps (the optimizer's tables hold 3 rows: the warm-ups
    read rows the tables hold), replays a step each, and trains as
    train_step does, bit for bit."""
    from tests.test_torch_build_train_fn import _batches
    from tests.test_torch_build_train_fn import _cfgs as _train_cfgs

    _, tc = _train_cfgs(synth_root, ["train.steps=2",
                                     "loss.kmeans_interval=3"])
    monkeypatch.setattr(TT, "eager_reason", lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(CG, "capture_stream", lambda device: _FakeStream())

    monkeypatch.setattr(CG, "record", lambda body, device, pool, stream: (
        CG.CapturedStep(_Replayer(body), [], []), 0))
    torch.use_deterministic_algorithms(True)
    try:
        tx = TT.make_optimizer(tc)
        fn = TT.build_train_fn(tc, tx, CPU)
        ts = TT.TrainState.create(tc, device="cpu")
        es = TT.TrainState.create(tc, device="cpu")
        for b in _batches(synth_root, 2):
            ts, m = fn(ts, b)
            es, em = TT.train_step(es, TT.batch_to_device(b, CPU), tc, tx)
            assert {k: float(v) for k, v in m.items()} == \
                {k: float(v) for k, v in em.items()}
        assert fn.stats["graphs"] == 2 and fn.stats["replays"] == 2
        assert fn.stats["warmup_steps"] == 2 * CG.WARMUP_STEPS
        for k in es.params:
            assert torch.equal(ts.params[k], es.params[k]), k
        assert torch.equal(ts.centers, es.centers)
    finally:
        torch.use_deterministic_algorithms(False)


def _c5_batches(n):
    rng = np.random.RandomState(0)
    return [{"frames": rng.rand(2, 3, 128, 128, 3).astype(np.float32),
             "word_ids": rng.randint(0, 67, (2, 3)).astype(np.int32),
             "frame_mask": np.array([[1, 1, 1], [1, 1, 0]], np.float32),
             "word_mask": np.array([[1, 1, 1], [1, 1, 0]], np.float32),
             "segment_id": np.arange(2, dtype=np.int32) + 2 * i}
            for i in range(n)]


@pytest.fixture(scope="module")
def c5_jax():
    """JAX's config-5 build_train_fn at spc 2 over two 128x128 batches:
    (configs, the port's detector with the same weights, the batches,
    the initial state, JAX's state and last metrics after them)."""
    ov = C5 + ["train.steps_per_call=2"]
    jc = jcfg.load_config(preset_name="config5", overrides=ov)
    tc = tcfg.load_config(preset_name="config5", overrides=ov)
    model, det_params = j_init(jax.random.PRNGKey(1), jc.detector)
    tdet = FasterRCNNExtractor(tc.detector).eval()
    tdet.load_state_dict(detector_params_from_jax(
        jax.tree.map(np.asarray, det_params)))
    batches = _c5_batches(2)
    js = jax.tree.map(np.asarray, JT.TrainState.create(
        jax.random.PRNGKey(0), jc))
    jstate, jm = JT.build_train_fn(jc, None, extractor=(model.apply,
                                                        det_params))(
        jax.tree.map(jnp.asarray, js), JT.stack_batches(batches))
    return tc, tdet, batches, js, jstate, jm


@pytest.mark.parametrize("way", ["eager", "stand-in capture"])
def test_config5_train_fn_matches_jax_multi_step(c5_jax, monkeypatch, way):
    """Config 5's step program (the frozen detector inside the step) over
    two batches at spc 2 against JAX's build_train_fn(cfg,
    extractor=...) with make_multi_step over the stacked batches: params
    and centers within 1e-5, the last step's metrics within 1e-5. The
    stand-in capture takes the card's bookkeeping: the frames in a static
    buffer, one graph (a refresh every step), two replays."""
    tc, tdet, batches, js, jstate, jm = c5_jax
    ts = state_from_jax(js, "cpu")
    captured = []
    if way == "stand-in capture":
        monkeypatch.setattr(TT, "eager_reason", lambda *a, **kw: None)
        monkeypatch.setattr(
            TT.TrainFn, "_capture",
            lambda self, state, inputs, refreshes: [_StandInCapture(
                self, state, inputs, refresh, captured)
                for refresh in refreshes])
    fn = TT.build_train_fn(tc, TT.make_optimizer(tc), CPU, extractor=tdet)
    for b in batches:
        ts, m = fn(ts, b)
    if way == "stand-in capture":
        assert fn.graphed and captured == [True]
        assert fn.stats["replays"] == 2 and fn.stats["eager_steps"] == 0
        (bufs,) = fn._inputs.values()
        assert tuple(bufs["frames"].shape) == (2, 3, 128, 128, 3)
    else:
        assert fn.stats["eager_steps"] == 2
    for k, v in jstate.params.items():
        np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(ts.centers.numpy(), np.asarray(jstate.centers),
                               rtol=1e-5, atol=1e-5)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


class _HostData(TorchDispatchMode):
    """Records each op that brings host data into a tensor (a Python
    scalar or list made a tensor, a list index) or reads a tensor back to
    the host: the copies and syncs that a CUDA graph's capture refuses.
    One-hot's check of its indices, which reads them back on the CPU
    only, is not recorded."""

    def __init__(self):
        super().__init__()
        self.seen, self.paused = [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused and func.__name__.split(".")[0] in (
                "lift_fresh", "lift_fresh_copy", "_local_scalar_dense"):
            self.seen.append(func.__name__)
        return func(*args, **(kwargs or {}))


def _one_hot_unrecorded(monkeypatch, mode):
    one_hot = torch.nn.functional.one_hot

    def wrapped(*a, **kw):
        mode.paused = True
        try:
            return one_hot(*a, **kw)
        finally:
            mode.paused = False
    monkeypatch.setattr(torch.nn.functional, "one_hot", wrapped)


def _c5_body(extra):
    """Config 5's step body (the captured `TrainFn._run`) at 64x64, run
    once first as a warm-up runs it: a thunk of one refresh or not."""
    from nafae_torch.models.detector.faster_rcnn import init_detector

    ov = [o for o in C5 if not o.startswith(("detector.image_size",
                                              "loss.kmeans_interval"))]
    tc = tcfg.load_config(preset_name="config5", overrides=ov + [
        "detector.image_size=64", "loss.kmeans_interval=2", *extra])
    det = init_detector(tc.detector, torch.Generator().manual_seed(0),
                        device="cpu")
    fn = TT.build_train_fn(tc, TT.make_optimizer(tc), CPU, extractor=det)
    batch = {**_c5_batches(1)[0], "frames": np.random.RandomState(1).rand(
        2, 3, 64, 64, 3).astype(np.float32)}
    st, _ = fn(TT.TrainState.create(tc, device="cpu"), batch)
    inputs = TT.batch_to_device(batch, CPU)
    return lambda refresh: fn._run(st, inputs, refresh, False, fn._counters)


def _serve_body(dt, quantize):
    _, tc = _serve_cfgs("context")
    tc.model.dtype, tc.model.quantize = dt, quantize
    srv = GroundingServer(tc, _serve_params(), device="cpu")
    samples = [srv._pad_segment(s) for s in _segments(4)]
    b = {k: torch.from_numpy(np.stack([s[k] for s in samples]))
         for k in samples[0]}
    args = [b[k] for k in ("feats", "boxes", "word_ids", "frame_mask",
                           "word_mask", "region_mask")]
    args.append(b.get("feats_scale"))
    return lambda: srv._forward(*args)


@pytest.mark.parametrize("body", [
    *(f"config5 {name} refresh={r}" for name in ("separable", "pallas_roi",
                                                 "bf16") for r in (1, 0)),
    *(f"serve {dt} {q}" for dt, q in (("float32", ""), ("bfloat16", ""),
                                      ("float32", "int8"),
                                      ("float32", "int8pre"))),
    "eval", "eval int8"])
def test_captured_bodies_bring_no_host_data(synth_root, monkeypatch, body):
    """The bodies the card captures (config 5's step with the detector,
    the serving forward, eval's batch), run a second time as a capture
    runs them after the warm-up, make no tensor of host data and read
    none back."""
    from nafae_torch.data.loader import BatchLoader
    from nafae_torch.models.grounding import inference_params, params_from_jax

    kind, *rest = body.split(" ")
    if kind == "config5":
        extra = {"separable": [], "pallas_roi": ["detector.roi_impl=pallas"],
                 "bf16": ["detector.dtype=bfloat16"]}[rest[0]]
        step = _c5_body(extra)
        run = functools.partial(step, rest[1] == "refresh=1")
    elif kind == "serve":
        run = _serve_body(rest[0], rest[1] if len(rest) > 1 else "")
    else:
        _, tc = _serve_cfgs("context")
        tc.model.quantize = rest[0] if rest else ""
        params = inference_params(tc, params_from_jax(_eval_params(0),
                                                      "cpu"))
        ds = TDataset(synth_root, "val", 8, 6, 64, 3, with_gt=True)
        batch = TT.batch_to_device(next(iter(BatchLoader(
            ds, 4, shuffle=False))), CPU)
        run = functools.partial(TE.eval_batch, params, batch)
    run()
    mode = _HostData()
    _one_hot_unrecorded(monkeypatch, mode)
    with mode:
        run()
    assert mode.seen == []


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 16 runs these "
                    "checks on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_server_graph_equals_eager_on_gpu(cuda_device):
    """The serving graph answers as make_ground_fn called eagerly, bit for
    bit."""
    _, tc = _serve_cfgs("context")
    srv = GroundingServer(tc, _serve_params(), device=cuda_device)
    samples = [srv._pad_segment(s) for s in _segments(4)]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    got = srv.run_batch(batch)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in batch.items()}
    with torch.inference_mode():
        want = srv._fn(srv.params, t["feats"], t["boxes"], t["word_ids"],
                       t["frame_mask"], t["word_mask"], t["region_mask"])
    assert srv._program.stats["graphs"] == 1
    for k, v in want.items():
        assert np.array_equal(got[k], v.cpu().numpy()), k


@pytest.mark.cuda
def test_eval_graph_equals_eager_on_gpu(synth_root, cuda_device):
    """Eval's graph gives its eager body's hits on the card, bit for bit,
    batch by batch, for two params."""
    from nafae_torch.data.loader import BatchLoader

    ds = TDataset(synth_root, "val", 8, 6, 64, 3, with_gt=True)
    for seed in (0, 1):
        params = {k: torch.from_numpy(v).to(cuda_device)
                  for k, v in _eval_params(seed).items()}
        prog = TE._eval_batch(params, cuda_device)
        for batch in BatchLoader(ds, 4, shuffle=False):
            got = [t.cpu() for t in prog(batch, iou_thresh=0.5)]
            want = TE.eval_batch(params, TT.batch_to_device(
                batch, cuda_device), 0.5)
            assert all(torch.equal(g, w.cpu()) for g, w in zip(got, want))


@pytest.mark.cuda
def test_extract_graph_equals_eager_on_gpu(detector, cuda_device):
    """The extraction graph's outputs are the detector's eager outputs,
    bit for bit."""
    from nafae_torch.extract import make_extract_fn

    _, tc, _, tdet, frames = detector
    model = tdet.to(cuda_device)
    fn, _ = make_extract_fn(tc, model=model, device=cuda_device)
    got = fn(frames)
    want = model(torch.from_numpy(frames).to(cuda_device))
    for k, v in want.items():
        assert np.array_equal(got[k], v.float().cpu().numpy()), k
