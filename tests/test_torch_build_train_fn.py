"""The port's step program (nafae_torch.train.build_train_fn,
nafae_torch.utils.cuda_graph) on the CPU, at
test_torch_train.py's small shapes.

On the CPU the program runs the step body eagerly, the body a captured
CUDA graph holds on the card; here it is held against the JAX package's
`build_train_fn` with `make_multi_step` over `stack_batches` (spc 3,
params within 1e-5, the last step's metrics), and over W+2 steps of the
selection bank (the slot taken on the device; `bank_write` alone too). Also: the optimizer's
tables bit for bit against `Optimizer.lr` and the host arithmetic they
replace, the refresh steps, the choice of graph or eager with each eager
reason, the launch accounting of a capture with a stand-in graph, the
program's graph bookkeeping with a stand-in capture (a graph a batch
shape and refresh, a new capture on new buffers), and, on a card only,
graphed against eager bit for bit.
"""

import contextlib
import copy
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
from nafae_torch.utils import cuda_graph as CG

OV = ["data.feat_dim=64", "model.feat_dim=64", "model.embed_dim=32",
      "data.batch_size=8", "data.max_frames=8", "data.num_regions=6",
      "data.max_words=3", "loss.num_clusters=8", "loss.kmeans_interval=2",
      "train.warmup_steps=2", "train.lr=0.003", "train.log_every=1",
      "train.ckpt_every=1000000", "train.eval_every=1000000"]
CPU = torch.device("cpu")


def _cfgs(synth_root, extra=()):
    ov = OV + [f"data.root={synth_root}"] + list(extra)
    return (jcfg.load_config(preset_name="config4", overrides=ov),
            tcfg.load_config(preset_name="config4", overrides=ov))


def _batches(synth_root, n):
    ds = SegmentDataset(synth_root, "train", 8, 6, 64, 3)
    return [b for _, b in BatchLoader(ds, 8, shuffle=True, seed=0).steps(n)]


def _start(jc):
    js = jax.tree.map(np.asarray, JT.TrainState.create(
        jax.random.PRNGKey(0), jc))
    return js, state_from_jax(js, "cpu")


def _close(ts, jstate, tol=1e-5):
    for k, v in jstate.params.items():
        np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(v),
                                   rtol=tol, atol=tol, err_msg=k)
    np.testing.assert_allclose(ts.centers.numpy(), np.asarray(jstate.centers),
                               rtol=tol, atol=tol)


def test_multi_step_matches_jax(synth_root):
    """spc = 3: two groups of three steps of the port's build_train_fn
    (eager on the CPU, as `fit` takes a group) against two calls of the
    JAX package's build_train_fn (make_multi_step scanning over
    stack_batches): params and centers within 1e-5, the last step's
    metrics within 1e-5."""
    jc, tc = _cfgs(synth_root, ["train.steps_per_call=3"])
    batches = _batches(synth_root, 6)
    js, ts = _start(jc)
    jfn = JT.build_train_fn(jc, None)
    jstate = jax.tree.map(jax.numpy.asarray, js)
    fn = TT.build_train_fn(tc, TT.make_optimizer(tc), CPU)
    assert fn.eager_reason.startswith("device cpu")
    held = dict(ts.params)
    for call in (batches[:3], batches[3:]):
        jstate, jm = jfn(jstate, JT.stack_batches(call))
        for b in call:
            ts, tm = fn(ts, b)
    assert ts.step == int(jstate.step) == 6
    assert ts.opt_state["count"] == 6
    assert all(ts.params[k] is held[k] for k in held)     # in place
    _close(ts, jstate)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_bank_slot_wraps_like_jax(synth_root):
    """loss.kmeans_source=bank with W = 3 over W + 2 steps: the slot comes
    from the program's device counter and wraps; bank, validity, params
    and centers against the JAX step's."""
    w = 3
    jc, tc = _cfgs(synth_root, ["loss.kmeans_source=bank",
                                f"loss.bank_steps={w}"])
    batches = _batches(synth_root, w + 2)
    js, ts = _start(jc)
    jfn = JT.build_train_fn(jc, None)
    jstate = jax.tree.map(jax.numpy.asarray, js)
    fn = TT.build_train_fn(tc, TT.make_optimizer(tc), CPU)
    bank = ts.bank
    for b in batches:
        jstate, _ = jfn(jstate, b)
        ts, _ = fn(ts, b)
    assert ts.bank is bank and int(fn._counters[0]) == w + 2
    np.testing.assert_allclose(ts.bank.numpy(), np.asarray(jstate.bank),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ts.bank_valid.numpy(),
                                  np.asarray(jstate.bank_valid))
    _close(ts, jstate)


@pytest.mark.parametrize("as_counter", [False, True])
def test_bank_write_slot_matches_jax(as_counter):
    """kmeans.bank_write over W + 2 steps, the step an int or the step
    body's 0-d counter: each write lands in slot step % W as the JAX
    package's does, a smaller write padded with valid 0, in place."""
    from nafae_torch.ops import kmeans as TK
    from nafae_tpu.ops import kmeans as JK

    w, k, e = 3, 5, 4
    rng = np.random.RandomState(4)
    bank = torch.zeros(w, 2, 4, k, e)
    bv = torch.zeros(w, 2, 4, k)
    jb, jv = jax.numpy.asarray(bank.numpy()), jax.numpy.asarray(bv.numpy())
    for step in range(w + 2):
        sel = rng.randn(2, 3 + step % 2, k, e).astype(np.float32)
        sv = (rng.rand(2, 3 + step % 2, k) > 0.3).astype(np.float32)
        jb, jv = JK.bank_write(jb, jv, step, jax.numpy.asarray(sel),
                               jax.numpy.asarray(sv))
        at = torch.tensor(step) if as_counter else step
        bt, vt = TK.bank_write(bank, bv, at, torch.from_numpy(sel),
                               torch.from_numpy(sv))
        assert bt is bank and vt is bv
        np.testing.assert_array_equal(bank.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(bv.numpy(), np.asarray(jv))


def _host_corrections(count: int) -> tuple[float, float]:
    """The host arithmetic the tables replace (the update at `count`)."""
    c = torch.tensor(float(count + 1))
    return ((1 - torch.tensor(TT.ADAM_B1) ** c).item(),
            (1 - torch.tensor(TT.ADAM_B2) ** c).item())


@pytest.mark.parametrize("opt", ["adam", "sgd"])
@pytest.mark.parametrize("warmup", [0, 7])
def test_tables_bit_for_bit(opt, warmup):
    """Every row of the tables: the step size -Optimizer.lr(c), and Adam's
    bias corrections (the CPU's) or their f32 reciprocals (CUDA's) as the
    host computed them per update; past train.steps they grow."""
    cfg = tcfg.load_config(preset_name="config2", overrides=[
        "train.steps=300", f"train.warmup_steps={warmup}",
        f"train.optimizer={opt}"])
    tx = TT.make_optimizer(cfg)
    rows = TT.Optimizer._rows(tx, 301, reciprocal=False)
    recip = TT.Optimizer._rows(tx, 301, reciprocal=True)
    assert rows.shape == (301, 3) and rows.dtype == np.float32
    for c in range(301):
        assert rows[c, 0] == np.float32(-tx.lr(c))
        if opt == "adam":
            bc = np.float32(_host_corrections(c))
            np.testing.assert_array_equal(rows[c, 1:], bc)
            np.testing.assert_array_equal(recip[c, 1:], np.float32(1) / bc)
        else:
            assert (rows[c, 1:] == 1).all()
    table = tx.tables(CPU)
    np.testing.assert_array_equal(table.numpy(), rows)
    assert tx.tables(CPU, 300) is table
    longer = tx.tables(CPU, 400)
    assert longer.shape == (401, 3)
    np.testing.assert_array_equal(longer[:301].numpy(), rows)


def test_refresh_steps(synth_root):
    """The Lloyd refresh runs at the steps that are multiples of
    loss.kmeans_interval, the k-means++ seed only at step 0, and the
    program's centers move at those steps only."""
    _, tc = _cfgs(synth_root, ["loss.kmeans_interval=3"])
    assert [s for s in range(10) if TT.refresh_due(tc, s)] == [0, 3, 6, 9]
    assert not any(TT.seed_due(tc, s) for s in range(3))
    pp = replace(tc, loss=replace(tc.loss, kmeans_init="plusplus"))
    assert [s for s in range(3) if TT.seed_due(pp, s)] == [0]
    c3 = replace(tc, loss=replace(tc.loss, cluster_weight=0.0))
    assert not any(TT.refresh_due(c3, s) for s in range(4))
    fn = TT.build_train_fn(tc, TT.make_optimizer(tc), CPU)
    ts = TT.TrainState.create(tc, device="cpu")
    moved = []
    for b in _batches(synth_root, 7):
        before = ts.centers.clone()
        ts, _ = fn(ts, b)
        moved.append(not torch.equal(before, ts.centers))
    assert [s for s, m in enumerate(moved) if m] == [0, 3, 6]
    assert fn.stats["eager_steps"] == 7 and fn.stats["replays"] == 0


class _Mesh:
    """A stand-in [data, frame] mesh: its shape and one group a name."""

    def __init__(self, data, frame):
        self.mesh = torch.zeros(data, frame)

    def get_group(self, name):
        return name


def test_eager_reason_names_each_case(synth_root, monkeypatch):
    """Captured on cuda with no mesh or an NCCL mesh without a frame axis,
    and at config 5 with the frozen detector in the step; each eager case
    names its reason (the choice reads the config and the device, nothing
    of a card)."""
    _, tc = _cfgs(synth_root)
    cuda = torch.device("cuda")
    backend = {"data": "nccl"}
    monkeypatch.setattr(torch.distributed, "get_backend",
                        lambda group=None: backend[group])
    assert TT.eager_reason(tc, cuda) is None
    assert TT.eager_reason(tc, cuda, _Mesh(1, 1)) is None
    c5 = tcfg.load_config(preset_name="config5")
    assert TT.eager_reason(c5, cuda) is None
    assert TT.build_train_fn(c5, TT.make_optimizer(c5), cuda,
                             extractor=object()).graphed
    cases = {
        "device cpu": dict(device=CPU),
        "debug_nans": dict(debug_nans=True),
        "frame parallelism": dict(mesh=_Mesh(1, 2)),
    }
    for words, kw in cases.items():
        args = {"device": cuda, **kw}
        assert words in TT.eager_reason(tc, **args), words
    backend["data"] = "gloo"
    assert "gloo mesh" in TT.eager_reason(tc, cuda, _Mesh(2, 1))
    fn = TT.build_train_fn(tc, TT.make_optimizer(tc), CPU,
                           debug_nans=True)
    assert not fn.graphed and "device cpu" in fn.eager_reason


class _StandInGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_launch_accounting_with_a_stand_in_graph():
    """What a capture counts is taken back out and added once a replay;
    a warm-up under `set_apart` leaves the counts as they were and
    counts its launches apart."""
    from nafae_torch.ops.kernels import cross_mil, ctx_mix
    from nafae_torch.parallel import sharding as S

    S.COLLECTIVES.reset()
    was = (dict(ctx_mix.launches), dict(cross_mil.launches))

    def body():
        ctx_mix.launches["ctx_mix_fwd_res"] += 1
        ctx_mix.launches["ctx_mix_bwd_res"] += 1
        cross_mil.launches["cross_mil"] += 2
        S.COLLECTIVES.add("all_reduce", torch.zeros(5))

    warm = {}
    for _ in range(2):
        with CG.set_apart(warm):
            body()
    assert (ctx_mix.launches, cross_mil.launches) == was
    assert warm == {"ctx_mix_fwd_res": 2, "ctx_mix_bwd_res": 2,
                    "cross_mil": 4}
    assert S.COLLECTIVES.records == []
    graph = _StandInGraph()
    step = CG.capture(body, graph, contextlib.nullcontext())
    assert (ctx_mix.launches, cross_mil.launches) == was
    assert S.COLLECTIVES.records == []
    for _ in range(3):
        step.replay()
    assert graph.replays == 3
    assert ctx_mix.launches["ctx_mix_fwd_res"] == \
        was[0]["ctx_mix_fwd_res"] + 3
    assert ctx_mix.launches["ctx_mix_bwd_res"] == \
        was[0]["ctx_mix_bwd_res"] + 3
    assert cross_mil.launches["cross_mil"] == was[1]["cross_mil"] + 6
    assert S.COLLECTIVES.records == [("all_reduce", (5,), "float32", 20)] * 3
    S.COLLECTIVES.reset()
    ctx_mix.launches.update(was[0])
    cross_mil.launches.update(was[1])


class _StandInCapture:
    """A capture that records the program's body and replays it
    eagerly (its launches set apart: a replay counts through the
    accounting). The program captures a shape's graphs together, one a
    refresh it reaches, this step's first."""

    def __init__(self, prog, state, inputs, refresh, log):
        self.args = (prog, state, inputs, refresh)
        log.append(refresh)

    def replay(self):
        prog, state, inputs, refresh = self.args
        with CG.set_apart({}):
            prog._run(state, inputs, refresh, False, prog._counters)


def test_program_keeps_a_graph_a_shape_and_refresh(synth_root, monkeypatch):
    """The program's bookkeeping with a stand-in capture on the CPU: one
    capture for each batch shape and refresh or not, a replay a step, a
    new capture on a restored state's new buffers, the counters reset to
    its step; the trajectory that of train_step, bit for bit."""
    _, tc = _cfgs(synth_root, ["loss.kmeans_interval=3"])
    captured = []
    monkeypatch.setattr(TT, "eager_reason", lambda *a, **kw: None)
    monkeypatch.setattr(
        TT.TrainFn, "_capture",
        lambda self, state, inputs, refreshes: [_StandInCapture(
            self, state, inputs, refresh, captured)
            for refresh in refreshes])
    batches = _batches(synth_root, 7)
    torch.use_deterministic_algorithms(True)
    try:
        tx = TT.make_optimizer(tc)
        fn = TT.build_train_fn(tc, tx, CPU)
        assert fn.graphed
        ts = TT.TrainState.create(tc, device="cpu")
        es = TT.TrainState.create(tc, device="cpu")
        for i, b in enumerate(batches[:4]):
            ts, m = fn(ts, b)
            es, em = TT.train_step(es, TT.batch_to_device(b, CPU), tc, tx)
            assert {k: float(v) for k, v in m.items()} == \
                {k: float(v) for k, v in em.items()}, i
        assert captured == [True, False]
        assert fn.stats["replays"] == 4 and fn.stats["eager_steps"] == 0
        restored = TT.TrainState.from_state_dict(     # new buffers
            copy.deepcopy(ts.state_dict()), "cpu")
        for b in batches[4:]:
            restored, _ = fn(restored, b)
            es, _ = TT.train_step(es, TT.batch_to_device(b, CPU), tc, tx)
        assert captured == [True, False, False, True]
        assert [int(t) for t in fn._counters] == [7, 7]
        for k in es.params:
            torch.testing.assert_close(restored.params[k], es.params[k],
                                       rtol=0, atol=0)
        torch.testing.assert_close(restored.centers, es.centers, rtol=0,
                                   atol=0)
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 15 runs this "
                    "check on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernels", ["auto", "pallas"])
def test_graphed_equals_eager_on_gpu(synth_root, cuda_device, kernels):
    """On a card: the captured program over 5 steps (refreshes at 0, 2, 4,
    both graphs replayed) bit for bit train_step run eagerly, its launch
    counts those of the eager steps."""
    from nafae_torch.ops.kernels import cross_mil, ctx_mix, diag

    _, tc = _cfgs(synth_root, [f"train.kernels={kernels}"])
    tx = TT.make_optimizer(tc)
    fn = TT.build_train_fn(tc, tx, cuda_device)
    assert fn.graphed
    ts = TT.TrainState.create(tc, device=cuda_device)
    es = TT.TrainState.create(tc, device=cuda_device)
    mods = (ctx_mix, cross_mil, diag)
    counts = {"graphed": {}, "eager": {}}

    def counted(kind, call):
        before = [dict(m.launches) for m in mods]
        out = call()
        for m, was in zip(mods, before):
            for k, n in m.launches.items():
                counts[kind][k] = counts[kind].get(k, 0) + n - was[k]
        return out

    for b in _batches(synth_root, 5):
        ts, m = counted("graphed", lambda: fn(ts, b))
        got = {k: float(v) for k, v in m.items()}
        es, em = counted("eager", lambda: TT.train_step(
            es, TT.batch_to_device(b, cuda_device), tc, tx))
        assert got == {k: float(v) for k, v in em.items()}
    assert counts["graphed"] == counts["eager"]
    assert fn.stats["graphs"] == 2 and fn.stats["replays"] == 5
    assert fn.stats["warmup_steps"] == 2 * TT.WARMUP_STEPS
    assert fn.stats["warmup_launches"] == {
        k: n // 5 * fn.stats["warmup_steps"]
        for k, n in counts["eager"].items() if n}
    for k in es.params:
        assert torch.equal(ts.params[k], es.params[k]), k
    assert torch.equal(ts.centers, es.centers)
