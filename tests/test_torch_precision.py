"""model.matmul_precision in the port (`device.matmul_precision` around the
losses and their gradient in `train.step_body`), on the CPU at
test_torch_train.py's small shapes.

Held: (a) one step at `default` against the JAX package's step under the
same override, at test_torch_train's tolerances (the CPU's f32 products
ignore the TF32 flag, and JAX's DEFAULT equals HIGHEST there, so this holds
the plumbing, not the rounding); (b) the scope: the TF32 flag as every
matrix product of one config-4 step sees it, with the cluster loss and a
k-means++ seeding and Lloyd refresh, on both routes, through `train_step`
and through `build_train_fn`'s eager step: on for every product of the
losses' forward and backward under `default` but K3's backward (pinned
exact, as the reference pins it), off for k-means and the optimizer, off
everywhere under `highest`, and after the step what it was before; the
detector's pinned fc layers and the RoIAlign products the knob reaches;
(c) a server and eval built from a `default` config run no product with
the flag on (a function mode: a dispatch mode sees nothing under
torch.inference_mode).
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

import nafae_torch.config as tcfg
from nafae_torch import train as TT
from nafae_torch.device import matmul_precision
from nafae_torch.ops.kernels import cross_mil as K3
from tests.test_torch_serve import _params as _serve_params
from tests.test_torch_serve import _segments
from tests.test_torch_train import OV, _batches, _one_step_matches_jax

DEFAULT = ["model.matmul_precision=default"]
PRODUCTS = {torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
            torch.ops.aten.baddbmm}


def _tf32() -> bool:
    return torch.backends.cuda.matmul.allow_tf32


class _Products(TorchDispatchMode):
    """Records (phase, TF32 flag) at every matrix product; `phase` is set
    by the wrappers of `_phases`, `entries` the flag at each entry."""

    def __init__(self):
        super().__init__()
        self.phase, self.seen, self.entries = "before", [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in PRODUCTS:
            self.seen.append((self.phase, _tf32()))
        return func(*args, **(kwargs or {}))

    def flags(self, phase: str) -> set:
        return {f for p, f in self.seen if p == phase}


class _Calls(TorchFunctionMode):
    """Records the TF32 flag at every product called through torch's
    Python API; unlike a dispatch mode, it sees the calls that serving
    and eval make under torch.inference_mode."""
    NAMES = {"matmul", "einsum", "linear", "mm", "bmm", "addmm", "baddbmm"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", None) in self.NAMES:
            self.seen.append(_tf32())
        return func(*args, **(kwargs or {}))


def _phases(rec: _Products, monkeypatch, tx) -> None:
    """Name the step's parts: the losses from compute_losses' entry through
    the backward, K3's backward inside them, the optimizer's update, and
    k-means; what comes after each is "rest"."""
    def mark(name, fn, then):
        def wrapped(*a, **kw):
            prev, rec.phase = rec.phase, name
            rec.entries.append((name, _tf32()))
            try:
                return fn(*a, **kw)
            finally:
                rec.phase = prev if then is None else then
        return wrapped

    monkeypatch.setattr(TT, "compute_losses",
                        mark("losses", TT.compute_losses, "losses"))
    monkeypatch.setattr(K3, "cross_mil_bwd",
                        mark("pinned", K3.cross_mil_bwd, None))
    for name in ("kmeans_lloyd", "kmeans_plusplus_init"):
        monkeypatch.setattr(TT, name, mark("kmeans", getattr(TT, name),
                                           "rest"))
    tx.update = mark("optimizer", tx.update, "rest")


def _step_cfg(synth_root, precision, kernels):
    return tcfg.load_config(preset_name="config4", overrides=OV + [
        f"data.root={synth_root}", f"train.kernels={kernels}",
        f"model.matmul_precision={precision}", "loss.kmeans_init=plusplus"])


@pytest.mark.parametrize("runner", ["train_step", "build_train_fn"])
@pytest.mark.parametrize("kernels", ["auto", "pallas"])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_precision_scope(synth_root, monkeypatch, precision, kernels, runner):
    cfg = _step_cfg(synth_root, precision, kernels)
    batch = _batches(synth_root, cfg, 1)[0]
    state = TT.TrainState.create(cfg, device="cpu")
    tx = TT.make_optimizer(cfg)
    rec = _Products()
    _phases(rec, monkeypatch, tx)
    if runner == "train_step":
        step = lambda st: TT.train_step(st, TT.batch_to_device(  # noqa: E731
            batch, st.device), cfg, tx)
    else:
        fn = TT.build_train_fn(cfg, tx, torch.device("cpu"))
        step = lambda st: fn(st, batch)                          # noqa: E731
    with rec:
        step(state)
    assert not _tf32()
    assert {p for p, _ in rec.entries} == {"losses", "optimizer", "kmeans"} \
        | ({"pinned"} if kernels == "pallas" else set())
    assert not any(f for p, f in rec.entries if p in ("optimizer", "kmeans"))
    assert rec.flags("losses") == {precision == "default"}
    assert rec.flags("kmeans") == {False}
    assert rec.flags("pinned") == ({False} if kernels == "pallas" else set())
    for p in ("before", "optimizer", "rest"):
        assert rec.flags(p) <= {False}
    # a caller's flag comes back after the step, and under `highest` the
    # losses run exact inside it all the same
    rec.seen.clear()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with rec:
            step(state)
        assert _tf32()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert rec.flags("losses") == {precision == "default"}


def test_pinned_and_reached_products():
    """Inside the `default` scope: the VGG16 head's fc6/fc7 stay exact
    (the reference's Dense layers take no precision) and K3's backward too
    (HIGHEST in the reference); the plain RoIAlign's products take TF32, as
    the reference's einsums take its PRECISION."""
    from nafae_torch.models.detector.vgg import VGG16RoIHead
    from nafae_torch.ops.roi_align import roi_align_matmul

    rec = _Products()
    gen = torch.Generator().manual_seed(0)
    with torch.device("meta"):
        head = VGG16RoIHead()
        rois = torch.empty(3, 7, 7, 512)
    feat = torch.rand(1, 8, 8, 4, generator=gen)
    boxes = torch.tensor([[[0.5, 1.0, 6.0, 7.5], [2.0, 2.0, 4.0, 5.0]]])
    w, v = torch.rand(6, 4, generator=gen), torch.rand(2, 3, 5, 4,
                                                       generator=gen)
    fm = torch.ones(2, 3)
    idx = torch.randint(0, 5, (2, 6, 3), generator=gen, dtype=torch.int32)
    with matmul_precision("default"), rec:
        rec.phase = "vgg"
        head(rois)
        rec.phase = "k3_bwd"
        K3.cross_mil_bwd(w, v, fm, None, idx, torch.rand(2, 6, 3,
                                                         generator=gen))
        rec.phase = "roi_align"
        roi_align_matmul(feat, boxes, 7, 1.0)
    assert not _tf32()
    assert rec.flags("vgg") == rec.flags("k3_bwd") == {False}
    assert rec.flags("roi_align") == {True}


def test_matmul_precision_rejects_unknown_values():
    with pytest.raises(ValueError, match="unknown matmul precision"):
        with matmul_precision("high"):
            pass
    assert not _tf32()


@pytest.mark.parametrize("dtype,kernels", [("float32", "auto"),
                                           ("float32", "pallas"),
                                           ("bfloat16", "auto")])
def test_default_step_matches_jax(synth_root, dtype, kernels):
    _one_step_matches_jax(synth_root, "config4", dtype, kernels, DEFAULT)


def test_serving_and_eval_stay_exact(synth_root):
    """model.matmul_precision=default reaches training only: a server and
    evaluate_config built from such a config run every product with the
    flag off, as the reference's serve and evaluate read PRECISION outside
    any context."""
    from nafae_torch.evaluate import evaluate_config
    from nafae_torch.serve import GroundingServer

    over = ["data.feat_dim=16", "model.feat_dim=16", "model.embed_dim=8",
            "data.max_frames=6", "data.num_regions=4", "data.max_words=3",
            "data.batch_size=4", *DEFAULT]
    srv_cfg = tcfg.load_config(preset_name="config4", overrides=over)
    ev_cfg = tcfg.load_config(preset_name="config1", overrides=[
        "data.feat_dim=64", "model.feat_dim=64", "model.embed_dim=32",
        f"data.root={synth_root}", *DEFAULT])
    rng = np.random.RandomState(0)
    ev_params = {"word_emb": rng.randn(67, 32).astype(np.float32),
                 "w_v": (rng.randn(64, 32) / 8).astype(np.float32),
                 "b_v": np.zeros(32, np.float32)}
    rec = _Calls()
    with rec:
        GroundingServer(srv_cfg, _serve_params(), device="cpu"
                        ).ground_segments(_segments(5))
        evaluate_config(ev_cfg, ev_params, device="cpu")
    assert rec.seen and not any(rec.seen)
