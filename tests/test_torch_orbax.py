"""The JAX package's orbax checkpoints read by the port, on the CPU.

The port reads them with numpy alone (`nafae_torch.utils.ocdbt`, `zarr2`,
`orbax_read`; tests/test_torch_zstd.py holds the zstd decoder). Held here:

(a) the OCDBT reader against tensorstore's own `ocdbt` store: key sets
    written compressed and not, with small inline limits, enough keys and
    small enough nodes for interior nodes, and enough commits for
    version-tree nodes; `list()` and `read()` equal, at every generation;
(b) the committed fixture tests/data/orbax_config4/ (the JAX package's
    `CheckpointManager.save` of `TrainState.create(PRNGKey(0), config4)` at
    full width): the port's restore is bit for bit `jax.tree.map(
    np.asarray, JAX's restore_latest(template))`, its sha256s are
    expected.json's, and it takes at most 10 s;
(c) a port `fit` resumed from a JAX orbax checkpoint (JAX `fit` for 2
    steps) equals the JAX package's own resumed `fit` to step 4: rows 3-4
    (rtol 1e-5 / atol 1e-6) and the final params, centers and optimizer
    state (rtol 1e-5 / atol 1e-5), with adamw, sgd and the bank source, at
    tests/test_torch_train.py's small widths;
(d) a bank saved from a data-parallel mesh on the CPU's forced host
    devices, its ring in several zarr chunks, restores equal;
(e) `load_eval_params` on an orbax directory reads params and step only;
(f) a bf16 leaf, a checkpoint written with use_ocdbt false, a
    `*.orbax-checkpoint-tmp-*` directory, an orbax step directory without
    its files, use_zarr3 true and an unknown compressor;
(g) the port on the CPU reproduces expected.json's first-step metrics and
    eval metrics from the fixture (rtol 1e-5 / atol 1e-6; hits equal).

Regenerate the fixture (the JAX package writes it; its data and seeds are
fixed here and copied into expected.json, which chip_smoke.py's phase 19
reads):

    python tests/test_torch_orbax.py --write-fixture
"""

import hashlib
import json
import pathlib
import shutil
import sys
import tempfile
import time

if __name__ == "__main__":       # run as a script: import the repo's packages
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import nafae_tpu.config as jcfg  # noqa: E402
import nafae_torch.config as tcfg  # noqa: E402
from nafae_tpu import train as JT  # noqa: E402
from nafae_tpu.utils import checkpoint as JC  # noqa: E402
from nafae_torch import train as TT  # noqa: E402
from nafae_torch.models.grounding import state_from_jax  # noqa: E402
from nafae_torch.utils import orbax_read, zarr2, zstd  # noqa: E402
from nafae_torch.utils.checkpoint import (  # noqa: E402
    CheckpointManager, load_eval_params)
from nafae_torch.utils.ocdbt import OcdbtStore  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "orbax_config4"
# the fixture's data: config-4 widths, one batch of 16 to train on and a
# val split to evaluate (the port's generate_synthetic_dataset is the JAX
# package's, seed for seed)
FIXTURE_DATA = {
    "train": dict(num_segments=16, feat_dim=2048, num_regions=20,
                  max_frames=20, max_words=8, seed=22),
    "val": dict(num_segments=16, feat_dim=2048, num_regions=20,
                max_frames=20, max_words=8, seed=22)}
# the JAX package's fit from the fixture: one f32 step on the auto route
FIXTURE_FIT = ["train.steps=1", "train.log_every=1", "train.kernels=auto",
               "model.dtype=float32", "train.ckpt_every=1000000",
               "train.eval_every=1000000"]
RESTORE_BUDGET_S = 10.0
SKIP = ("frames_per_sec", "ts")           # host clocks, not results


def _leaf_name(path) -> str:
    return jax.tree_util.keystr(path, simple=True, separator=".")


def _digest(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def _jax_leaves(state) -> dict[str, np.ndarray]:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {_leaf_name(p): np.asarray(v) for p, v in flat}


def _tree_leaves(tree: dict, at: str = "") -> dict:
    """The arrays of a read_tree result by dotted name (None leaves are
    left out, as a JAX tree leaves them out)."""
    out = {}
    for k, v in tree.items():
        name = f"{at}.{k}" if at else k
        if isinstance(v, dict):
            out.update(_tree_leaves(v, name))
        elif v is not None:
            out[name] = v
    return out


def _data(root: str, data: dict) -> None:
    from nafae_tpu.data.synthetic import generate_synthetic_dataset
    for split, kw in data.items():
        generate_synthetic_dataset(root, split, **kw)


def write_fixture(out: pathlib.Path = FIXTURE) -> dict:
    """Writes the fixture with the JAX package: the orbax checkpoint of
    `TrainState.create(PRNGKey(0), config4)`, and expected.json with each
    leaf's dtype, shape and sha256 as JAX restores it, the JAX package's
    first fit row from it (FIXTURE_FIT) and its `evaluate_config` on the
    val split with its params."""
    from nafae_tpu.evaluate import evaluate_config

    shutil.rmtree(out, ignore_errors=True)
    cfg = jcfg.load_config(preset_name="config4")
    state = JT.TrainState.create(jax.random.PRNGKey(0), cfg)
    ck = JC.CheckpointManager(str(out))
    ck.save(state, wait=True)
    ck.close()
    with tempfile.TemporaryDirectory() as tmp:
        restored = JC.CheckpointManager(shutil.copytree(out, f"{tmp}/ck")
                                ).restore_latest(state)
        restored = jax.tree.map(np.asarray, restored)
        _data(tmp, FIXTURE_DATA)
        fcfg = jcfg.load_config(preset_name="config4", overrides=[
            f"data.root={tmp}", f"train.ckpt_dir={tmp}/ck", *FIXTURE_FIT])
        rows = []
        JT.fit(fcfg, None, log_fn=rows.append)
        ev = evaluate_config(fcfg, params=restored.params, split="val")
    expected = {
        "data": FIXTURE_DATA, "fit_overrides": FIXTURE_FIT,
        "leaves": {k: _digest(v) for k, v in _jax_leaves(restored).items()},
        "fit_first_row": {k: v for k, v in rows[0].items() if k not in SKIP},
        "eval": {k: v for k, v in ev.items() if k != "per_class_acc"}}
    with open(out / "expected.json", "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")
    return expected


def _expected() -> dict:
    with open(FIXTURE / "expected.json") as f:
        return json.load(f)


@pytest.fixture
def fixture_copy(tmp_path):
    """The fixture's checkpoint directory, copied (neither package writes
    into the committed one)."""
    return shutil.copytree(FIXTURE, tmp_path / "ck")


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("config,keys,commits", [
    pytest.param({"compression": None, "max_inline_value_bytes": 4,
                  "max_decoded_node_bytes": 200}, 40, 1, id="raw-interior"),
    pytest.param({"compression": {"id": "zstd", "level": 5},
                  "max_inline_value_bytes": 16,
                  "max_decoded_node_bytes": 300}, 300, 1,
                 id="zstd-interior"),
    pytest.param({"compression": {"id": "zstd", "level": 1},
                  "max_inline_value_bytes": 4,
                  "version_tree_arity_log2": 2}, 23, 23, id="version-tree"),
    pytest.param({}, 12, 3, id="defaults")])
def test_ocdbt_matches_tensorstore(tmp_path, config, keys, commits):
    """Every key and value of every generation equals tensorstore's."""
    import tensorstore as ts

    base = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    kv = ts.KvStore.open({**base, "config": config}).result()
    rng = np.random.RandomState(keys)
    values = {f"k/{i:04d}/{'x' * (i % 7)}".encode():
              rng.bytes(int(rng.randint(0, 40))) for i in range(keys)}
    items = sorted(values.items())
    for part in np.array_split(np.arange(len(items)), commits):
        with ts.Transaction() as txn:
            for i in part:
                kv.with_transaction(txn).write(*items[i]).result()
    newest = OcdbtStore(str(tmp_path))
    gens = range(newest.generation, 0, -1) if commits > 1 else [None]
    for gen in gens:
        spec = base if gen is None else {**base, "version": gen}
        want = ts.KvStore.open(spec).result()
        names = want.list().result()
        got = OcdbtStore(str(tmp_path), gen)
        assert got.list() == sorted(k.decode() for k in names)
        for k in names:
            assert got.read(k.decode()) == want.read(k).result().value
    assert newest.read("absent") is None
    assert newest.list() == sorted(k.decode() for k in values)
    with pytest.raises(ValueError, match="no generation"):
        OcdbtStore(str(tmp_path), newest.generation + 1)


def test_ocdbt_checks_its_framing(tmp_path):
    """A flipped byte in the manifest fails its crc32c; a missing
    manifest or data file raises ValueError naming it."""
    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_inline_value_bytes": 1}}).result()
    kv.write(b"key", b"value").result()
    OcdbtStore(str(tmp_path))
    (data,) = (tmp_path / "d").iterdir()
    raw = bytearray((tmp_path / "manifest.ocdbt").read_bytes())
    raw[20] ^= 1
    (tmp_path / "manifest.ocdbt").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="checksum"):
        OcdbtStore(str(tmp_path))
    raw[20] ^= 1
    (tmp_path / "manifest.ocdbt").write_bytes(bytes(raw))
    data.rename(tmp_path / "moved")
    with pytest.raises(ValueError, match=data.name):
        OcdbtStore(str(tmp_path))
    (tmp_path / "manifest.ocdbt").unlink()
    with pytest.raises(ValueError, match="manifest.ocdbt is missing"):
        OcdbtStore(str(tmp_path))


# ---------------------------------------------------------------- (b)

def test_fixture_restores_bit_for_bit(fixture_copy):
    """The full-width config-4 state: read_tree's leaves are JAX's restore
    and expected.json's sha256s; the port's TrainState (restore_latest)
    is state_from_jax of JAX's restore, bit for bit; within 10 s."""
    expected = _expected()
    cfg = jcfg.load_config(preset_name="config4")
    template = JT.TrainState.create(jax.random.PRNGKey(1), cfg)
    want = jax.tree.map(np.asarray,
                        JC.CheckpointManager(str(fixture_copy)).restore_latest(
                            template))
    t0 = time.perf_counter()
    tree = orbax_read.read_tree(str(fixture_copy / "0"))
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = CheckpointManager(str(fixture_copy)).restore_latest(
        TT.TrainState.create(tcfg.load_config(preset_name="config4"),
                             device="cpu"))
    restore_s = time.perf_counter() - t0
    print(f"config-4 orbax state (2.1 MB): read_tree {read_s:.3f} s, "
          f"restore_latest {restore_s:.3f} s on this CPU")
    assert max(read_s, restore_s) <= RESTORE_BUDGET_S
    leaves = _tree_leaves(tree)
    jleaves = _jax_leaves(want)
    assert set(leaves) == set(jleaves) == set(expected["leaves"])
    for k, v in leaves.items():
        assert v.dtype == jleaves[k].dtype, k
        np.testing.assert_array_equal(v, jleaves[k], err_msg=k)
        assert _digest(v) == expected["leaves"][k], k
    ref = state_from_jax(want, "cpu")
    assert got.step == ref.step == 0
    assert got.opt_state["count"] == ref.opt_state["count"]
    for a, b in ((got.params, ref.params), (got.opt_state["mu"],
                                            ref.opt_state["mu"]),
                 (got.opt_state["nu"], ref.opt_state["nu"]),
                 ({"c": got.centers}, {"c": ref.centers})):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert got.bank is None and got.bank_valid is None


# ---------------------------------------------------------------- (c)

OV = ["data.feat_dim=64", "model.feat_dim=64", "model.embed_dim=32",
      "data.batch_size=8", "data.max_frames=8", "data.num_regions=6",
      "data.max_words=3", "loss.num_clusters=8", "loss.kmeans_interval=3",
      "train.warmup_steps=2", "train.log_every=1",
      "train.ckpt_every=1000000", "train.eval_every=1000000"]


@pytest.mark.parametrize("extra", [
    pytest.param([], id="adamw"),
    pytest.param(["train.optimizer=sgd"], id="sgd"),
    pytest.param(["loss.kmeans_source=bank", "loss.bank_steps=2"],
                 id="bank")])
def test_port_resumes_what_jax_saved(synth_root, tmp_path, extra):
    """JAX fit for 2 steps saves step 2; the port's fit to step 4 on a
    copy of that directory and JAX's own on the original both resume at 2
    and agree: rows 3-4, final params, centers, optimizer state, bank."""
    def cfgs(steps, ck):
        ov = OV + [f"data.root={synth_root}", f"train.ckpt_dir={ck}",
                   f"train.steps={steps}", *extra]
        return (jcfg.load_config(preset_name="config4", overrides=ov),
                tcfg.load_config(preset_name="config4", overrides=ov))

    jc, _ = cfgs(2, tmp_path / "j")
    JT.fit(jc, None)
    assert orbax_read.steps(str(tmp_path / "j")) == [2]
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    jc, tc = cfgs(4, tmp_path / "j")
    _, tc = cfgs(4, tmp_path / "t")
    jrows, trows = [], []
    jstate, _ = JT.fit(jc, None, log_fn=jrows.append)
    tstate, _ = TT.fit(tc, device="cpu", log_fn=trows.append)
    assert [r["step"] for r in jrows] == [r["step"] for r in trows] == [3, 4]
    for j, t in zip(jrows, trows):
        for k in j:
            if k not in SKIP:
                np.testing.assert_allclose(t[k], j[k], rtol=1e-5, atol=1e-6,
                                           err_msg=k)
    want = state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    assert tstate.step == want.step == 4
    assert tstate.opt_state["count"] == want.opt_state["count"] == 4
    assert set(tstate.opt_state) == set(want.opt_state)
    pairs = [(tstate.params, want.params), ({"c": tstate.centers},
                                            {"c": want.centers})]
    pairs += [(tstate.opt_state[k], want.opt_state[k])
              for k in tstate.opt_state if k != "count"]
    if tstate.bank is not None:
        pairs.append(({"b": tstate.bank, "v": tstate.bank_valid},
                      {"b": want.bank, "v": want.bank_valid}))
    for a, b in pairs:
        for k in b:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    # the port wrote its own checkpoint beside the orbax step it resumed
    assert CheckpointManager(str(tmp_path / "t")).steps() == [4]
    assert orbax_read.steps(str(tmp_path / "t")) == [2]


# ---------------------------------------------------------------- (d)

def test_bank_from_a_mesh_restores_in_chunks(tmp_path):
    """A bank-source state whose ring is sharded over 4 of the forced host
    devices (batch axis) is written in 4 zarr chunks; it restores equal."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    cfg = jcfg.load_config(preset_name="config4", overrides=OV + [
        "loss.kmeans_source=bank", "loss.bank_steps=3"])
    state = JT.TrainState.create(jax.random.PRNGKey(3), cfg)
    rng = np.random.RandomState(3)
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    state = state.replace(
        bank=jax.device_put(rng.randn(*state.bank.shape).astype(np.float32),
                            NamedSharding(mesh, P(None, "data"))),
        bank_valid=jax.device_put(
            (rng.rand(*state.bank_valid.shape) > 0.5).astype(np.float32),
            NamedSharding(mesh, P(None, "data"))))
    ck = JC.CheckpointManager(str(tmp_path))
    ck.save(state, wait=True)
    ck.close()
    store = OcdbtStore(str(tmp_path / "0" / "default"))
    chunks = [k for k in store.list() if k.startswith("bank/")
              and not k.endswith(".zarray")]
    assert len(chunks) == 4, chunks
    got = CheckpointManager(str(tmp_path)).restore_latest(
        TT.TrainState.create(tcfg.load_config(
            preset_name="config4", overrides=OV + [
                "loss.kmeans_source=bank", "loss.bank_steps=3"]),
            device="cpu"))
    np.testing.assert_array_equal(got.bank.numpy(), np.asarray(state.bank))
    np.testing.assert_array_equal(got.bank_valid.numpy(),
                                  np.asarray(state.bank_valid))


# ---------------------------------------------------------------- (e)

def test_load_eval_params_reads_params_only(fixture_copy, monkeypatch):
    """Of an orbax step, load_eval_params reads and decompresses the keys
    of params and step alone, and gives the params JAX saved."""
    read, decoded = [], []
    real_read, real_zstd = OcdbtStore.read, zstd.decompress

    def spy_read(self, key):
        read.append(key)
        return real_read(self, key)

    def spy_zstd(data):
        out = real_zstd(data)
        decoded.append(len(out))
        return out

    monkeypatch.setattr(OcdbtStore, "read", spy_read)
    monkeypatch.setattr(zstd, "decompress", spy_zstd)
    cfg = tcfg.load_config(preset_name="config4")
    params = load_eval_params(cfg, str(fixture_copy), device="cpu")
    assert read and all(k.split(".")[0].split("/")[0] in ("params", "step")
                        for k in read), read
    chunks = [k for k in read if not k.endswith(".zarray")]
    assert sorted(chunks) == ["params.b_v/0", "params.w_v/0.0",
                              "params.word_emb/0.0", "step/0"]
    # the chunks and the B+tree's nodes, nothing of opt_state or centers
    assert sum(decoded) < (2048 + 67 + 1) * 256 * 4 + 64 * 1024
    leaves = _expected()["leaves"]
    for k, v in params.items():
        assert _digest(v.numpy()) == leaves[f"params.{k}"], k


# ---------------------------------------------------------------- (f)

def _save_tree(path, step, tree, **handler):
    """orbax's CheckpointManager.save of a plain tree; handler: the
    PyTreeCheckpointHandler's options (use_ocdbt, use_zarr3)."""
    import orbax.checkpoint as ocp

    with ocp.CheckpointManager(
            str(path), item_handlers=ocp.PyTreeCheckpointHandler(**handler)
    ) as m:
        m.save(step, args=ocp.args.PyTreeSave(tree))
        m.wait_until_finished()


@pytest.mark.parametrize("use_ocdbt", [True, False],
                         ids=["ocdbt", "plain-files"])
def test_tree_dtypes_and_layouts(tmp_path, use_ocdbt):
    """bf16, f16, int8, uint8, bool, int32 and f32 leaves, a scalar, a
    None and a tuple restore as JAX restores them, through OCDBT or through
    plain files (use_ocdbt false: orbax here still writes it)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    tree = {"bf": jnp.asarray(rng.randn(3, 5), jnp.bfloat16),
            "half": jnp.asarray(rng.randn(7), jnp.float16),
            "i8": jnp.asarray(rng.randint(-100, 100, (4, 2)), jnp.int8),
            "u8": jnp.asarray(rng.randint(0, 255, 9), jnp.uint8),
            "flag": jnp.asarray(rng.rand(6) > 0.5),
            "seq": (jnp.arange(5, dtype=jnp.int32),
                    jnp.asarray(rng.randn(2, 3, 4), jnp.float32)),
            "scalar": jnp.asarray(7, jnp.int32), "none": None}
    _save_tree(tmp_path, 3, tree, use_ocdbt=use_ocdbt)
    assert (tmp_path / "3" / "default" / "manifest.ocdbt").exists() \
        == use_ocdbt
    got = orbax_read.read_tree(str(tmp_path / "3"))
    assert got["none"] is None and set(got["seq"]) == {"0", "1"}
    assert got["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bf"].float().numpy(),
                                  np.asarray(tree["bf"], np.float32))
    for name, want in (("half", tree["half"]), ("i8", tree["i8"]),
                       ("u8", tree["u8"]), ("flag", tree["flag"]),
                       ("seq.0", tree["seq"][0]), ("seq.1", tree["seq"][1]),
                       ("scalar", tree["scalar"])):
        node = got
        for k in name.split("."):
            node = node[k]
        assert node.dtype == np.asarray(want).dtype, name
        np.testing.assert_array_equal(node, np.asarray(want), err_msg=name)


def test_zarr_chunks_orders_and_fill(tmp_path):
    """zarr v2 over plain files, written by tensorstore: edge chunks
    stored whole and cropped, C and F order, a missing chunk as the fill
    value (null: zeros, as tensorstore reads it), a scalar."""
    import tensorstore as ts

    rng = np.random.RandomState(6)
    for name, dtype, order, fill in (("c", "<f4", "C", None),
                                     ("f", "<i8", "F", None),
                                     ("h", "<f8", "C", 2.5),
                                     ("u", "<u4", "F", 7)):
        arr = ts.open({"driver": "zarr", "kvstore": f"file://{tmp_path}/"
                       f"{name}", "metadata": {
                           "shape": [5, 7], "chunks": [2, 3],
                           "dtype": dtype, "fill_value": fill,
                           "compressor": None if name == "c" else
                           {"id": "zstd", "level": 3}, "order": order},
                       "create": True}).result()
        data = rng.randint(0, 100, (5, 7)).astype(np.dtype(dtype))
        arr[:4, :].write(data[:4]).result()        # row chunk 2 missing
        want = arr.read().result()
        got = zarr2.read_array(zarr2.FileStore(str(tmp_path)), name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert got[4, 0] == (0 if fill is None else fill)
    s = ts.open({"driver": "zarr", "kvstore": f"file://{tmp_path}/s",
                 "metadata": {"shape": [], "chunks": [], "dtype": "<i4",
                              "fill_value": None, "compressor": None},
                 "create": True}).result()
    s.write(np.int32(-9)).result()
    assert zarr2.read_array(zarr2.FileStore(str(tmp_path)), "s") == -9


def test_steps_follow_orbax(tmp_path):
    """orbax_read.steps lists what orbax's CheckpointManager lists: an
    uncommitted `*.orbax-checkpoint-tmp-*` directory, a non-integer name,
    a zero-padded name and a file do not count; a step directory without
    its files counts, and reading it raises ValueError naming what is
    missing (it is never passed over)."""
    import orbax.checkpoint as ocp

    _save_tree(tmp_path, 2, {"x": np.arange(3, dtype=np.int32)})
    for name in ("7.orbax-checkpoint-tmp-1234", "abc", "08"):
        (tmp_path / name).mkdir()
    (tmp_path / "9").write_text("")
    assert orbax_read.steps(str(tmp_path)) == [2]
    (tmp_path / "5").mkdir()
    with ocp.CheckpointManager(str(tmp_path)) as m:
        assert orbax_read.steps(str(tmp_path)) == sorted(m.all_steps()) \
            == [2, 5]
        assert m.latest_step() == 5
    with pytest.raises(ValueError, match=r"5/default/_METADATA is missing"):
        orbax_read.read_tree(str(tmp_path / "5"))
    template = TT.TrainState.create(tcfg.load_config(
        preset_name="config4", overrides=OV), device="cpu")
    with pytest.raises(ValueError, match="_METADATA is missing"):
        CheckpointManager(str(tmp_path)).restore_latest(template)
    # a step whose files are there but whose database is not
    shutil.rmtree(tmp_path / "5")
    shutil.rmtree(tmp_path / "2" / "default" / "d")
    with pytest.raises(ValueError, match="ocdbt"):
        orbax_read.read_tree(str(tmp_path / "2"))


def test_unsupported_encodings_raise(tmp_path):
    """use_zarr3 true raises naming the flag; a compressor other than
    zstd raises naming it; a checkpoint of another model does not fit."""
    x = {"x": np.arange(6, dtype=np.float32)}
    _save_tree(tmp_path / "z3", 1, x, use_zarr3=True)
    with pytest.raises(ValueError, match="use_zarr3"):
        orbax_read.read_tree(str(tmp_path / "z3" / "1"))
    _save_tree(tmp_path / "plain", 1, x, use_ocdbt=False)
    meta = tmp_path / "plain" / "1" / "default" / "x" / ".zarray"
    zarray = json.loads(meta.read_text())
    zarray["compressor"] = {"id": "blosc", "cname": "lz4"}
    meta.write_text(json.dumps(zarray))
    with pytest.raises(ValueError, match="'blosc'"):
        orbax_read.read_tree(str(tmp_path / "plain" / "1"))


def test_restore_refuses_another_run(fixture_copy):
    """The config-4 fixture does not fit a run of another width or
    optimizer: ValueError, not a state of the wrong shapes."""
    narrow = TT.TrainState.create(tcfg.load_config(
        preset_name="config4", overrides=OV), device="cpu")
    with pytest.raises(ValueError, match="does not fit this run"):
        CheckpointManager(str(fixture_copy)).restore_latest(narrow)
    sgd = TT.TrainState.create(tcfg.load_config(
        preset_name="config4", overrides=["train.optimizer=sgd"]),
        device="cpu")
    with pytest.raises(ValueError, match="trace"):
        CheckpointManager(str(fixture_copy)).restore_latest(sgd)


# ---------------------------------------------------------------- (g)

def test_port_reproduces_the_fixture_metrics(fixture_copy, tmp_path):
    """From the fixture, the port on the CPU gives expected.json's first
    fit row (rtol 1e-5 / atol 1e-6) and its eval (hits equal, accuracies
    to 1e-12), and writes state_1.pt beside the untouched orbax step."""
    from nafae_torch.data.synthetic import generate_synthetic_dataset
    from nafae_torch.evaluate import evaluate_config

    expected = _expected()
    root = tmp_path / "data"
    for split, kw in expected["data"].items():
        generate_synthetic_dataset(str(root), split, **kw)
    before = {p: p.read_bytes() for p in (fixture_copy / "0").rglob("*")
              if p.is_file()}
    cfg = tcfg.load_config(preset_name="config4", overrides=[
        f"data.root={root}", f"train.ckpt_dir={fixture_copy}",
        *expected["fit_overrides"]])
    rows = []
    TT.fit(cfg, device="cpu", log_fn=rows.append)
    assert len(rows) == 1
    want = expected["fit_first_row"]
    assert set(want) <= set(rows[0]) and rows[0]["step"] == want["step"]
    for k, v in want.items():
        np.testing.assert_allclose(rows[0][k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert CheckpointManager(str(fixture_copy)).steps() == [1]
    assert before == {p: p.read_bytes() for p in
                      (fixture_copy / "0").rglob("*") if p.is_file()}
    (fixture_copy / "state_1.pt").unlink()       # evaluate the orbax step
    params = load_eval_params(cfg, device="cpu")
    got = evaluate_config(cfg, params=params, device="cpu")
    ev = expected["eval"]
    assert got["num_annotations"] == ev["num_annotations"]
    assert round(got["box_acc_micro"] * got["num_annotations"]) == \
        round(ev["box_acc_micro"] * ev["num_annotations"])
    for k in ("box_acc_micro", "box_acc_macro"):
        assert abs(got[k] - ev[k]) <= 1e-12, k


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-fixture"]:
        sys.exit(f"usage: python {sys.argv[0]} --write-fixture")
    jax.config.update("jax_platforms", "cpu")
    exp = write_fixture()
    print(json.dumps({k: exp[k] for k in ("fit_first_row", "eval")},
                     indent=1))
