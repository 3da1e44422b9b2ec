"""The port's Faster R-CNN extractor (nafae_torch.models.detector) against
the JAX package's, stage by stage and end to end, on the CPU in f32, with
the JAX weights carried across by `detector_params_from_jax`.

Held: anchors exactly; C4 features, RPN objectness and deltas, the C5 head
and the detection head within 1e-4 of each tensor's largest entry;
proposal selection for every `topk_impl` (exact, approx, window, none) and
both `nms_impl`, fed JAX's own objectness and deltas: the same survivors
(keep_valid equal, boxes within 1e-4 of the image size: decode's exp may
differ by an ulp); the whole extractor with the reference's routes (the
TPU kernels in interpret mode where JAX takes them): region_valid equal,
boxes and feats held where JAX's survivors are clear of score ties. Also:
BN folding equals the reference's, init_detector draws flax's
distributions (the VGG16 detector too, in the flax tree's layout), and
each of the reference's TPU stem knobs gives its C4 features.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafae_tpu.config import DetectorConfig as JDC
from nafae_tpu.models.detector import anchors as JA
from nafae_tpu.models.detector import rpn as JRPN
from nafae_tpu.models.detector.faster_rcnn import \
    FasterRCNNExtractor as JFRCNN
from nafae_tpu.models.detector.faster_rcnn import init_detector as j_init
from nafae_tpu.models.detector.resnet import fold_frozen_bn as j_fold
from nafae_torch.config import DetectorConfig as TDC
from nafae_torch.models.detector import anchors as TA
from nafae_torch.models.detector import rpn as TRPN
from nafae_torch.models.detector.faster_rcnn import (FasterRCNNExtractor,
                                                     detector_params_from_jax,
                                                     init_detector)
from nafae_torch.models.detector.resnet import fold_frozen_bn

SMALL = dict(image_size=64, num_proposals=5, rpn_pre_nms_topk=32,
             anchor_scales=(16, 32))
NUM_CLASSES = 5


def _close(got, want, frac=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale)


@pytest.fixture(scope="module")
def det():
    """JAX weights (with detection heads) for the small config, numpy."""
    _, params = j_init(jax.random.PRNGKey(1), JDC(**SMALL),
                       with_detections=True, num_classes=NUM_CLASSES)
    rng = np.random.RandomState(0)
    return {"params": params, "tree": jax.tree.map(np.asarray, params),
            "frames": rng.rand(3, 64, 64, 3).astype(np.float32)}


def _port(tree, **kw):
    cfg = dict(SMALL)
    cfg.update(kw)
    model = FasterRCNNExtractor(TDC(**cfg), with_detections=True,
                                num_classes=NUM_CLASSES).eval()
    model.load_state_dict(detector_params_from_jax(tree))
    return model


def test_anchors_exact():
    for fh, fw, scales in ((4, 4, (16, 32)), (40, 40, (32, 64, 128, 256, 512)),
                           (3, 5, (8,))):
        np.testing.assert_array_equal(
            TA.generate_anchors(fh, fw, 16, scales),
            JA.generate_anchors(fh, fw, 16, scales))


def test_stages_match(det):
    jm = JFRCNN(JDC(**SMALL), with_detections=True, num_classes=NUM_CLASSES)
    tm = _port(det["tree"])
    x = det["frames"]
    p = det["params"]
    jfeat = jm.apply(p, jnp.asarray(x), method=lambda m, im: m.backbone(im))
    with torch.no_grad():
        tfeat = tm.backbone(torch.from_numpy(x))
        _close(tfeat, jfeat)
        jobj, jdel = jm.apply(p, jfeat, method=lambda m, f: m.rpn(f))
        tobj, tdel = tm.rpn(torch.from_numpy(np.array(jfeat)))
        _close(tobj, jobj)
        _close(tdel, jdel)
        rng = np.random.RandomState(1)
        rois = rng.randn(4, 7, 7, 1024).astype(np.float32)
        jhead = jm.apply(p, jnp.asarray(rois), method=lambda m, r: m.head(r))
        thead = tm.head(torch.from_numpy(rois))
        _close(thead, jhead)
        jlog, jd = jm.apply(p, jhead, method=lambda m, f: m.det_head(f))
        tlog, td = tm.det_head(torch.from_numpy(np.asarray(jhead)))
        _close(tlog, jlog)
        _close(td, jd)


@pytest.mark.parametrize("nms_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("topk_impl", ["exact", "approx", "window", "none"])
def test_proposal_selection_matches(det, topk_impl, nms_impl):
    """Both packages select from JAX's objectness and deltas."""
    jm = JFRCNN(JDC(**SMALL))
    x = jnp.asarray(det["frames"])
    p = {"params": {k: v for k, v in det["params"]["params"].items()
                    if k != "det_head"}}
    feat = jm.apply(p, x, method=lambda m, im: m.backbone(im))
    raw = topk_impl == "none"
    obj, deltas = jm.apply(p, feat, method=lambda m, f: m.rpn(f, raw=raw))
    anchors = JA.generate_anchors(4, 4, 16, SMALL["anchor_scales"])
    kw = dict(nms_impl=nms_impl, topk_impl=topk_impl, topk_window=4)
    jd, td = (None, None) if raw else (deltas, torch.from_numpy(
        np.asarray(deltas)))
    jr, tr = (deltas, torch.from_numpy(np.asarray(deltas))) if raw else \
        (None, None)
    want = JRPN.select_proposals_batched(
        obj, jd, jnp.asarray(anchors), 64, 32, 5, 0.7, deltas_raw=jr, **kw)
    got = TRPN.select_proposals_batched(
        torch.from_numpy(np.asarray(obj)), td, torch.from_numpy(anchors), 64,
        32, 5, 0.7, deltas_raw=tr, **kw)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=64 * 1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-6)


def test_stable_topk_orders_ties_by_index():
    s = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0, 1.0]])
    vals, idx = TRPN.stable_topk(s, 4)
    want = jax.lax.top_k(jnp.asarray(s.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(
        TRPN.windowed_topk(s, 3, 2)[1].numpy(),
        np.asarray(JRPN.windowed_topk(jnp.asarray(s.numpy()), 3, 2)[1]))


def _clear_of_ties(scores, valid, gap=1e-5):
    """Frames whose surviving scores differ pairwise by more than gap."""
    ok = []
    for s, v in zip(scores, valid):
        live = np.sort(s[v > 0])
        ok.append(live.size < 2 or np.diff(live).min() > gap)
    return np.asarray(ok)


# (overrides, JAX module kwargs, port kwargs)
E2E = {
    "config5-pallas": (dict(full_pool_nms=True, nms_impl="auto"),
                       dict(use_pallas_nms=True, use_pallas_roi_align=True),
                       dict(use_pallas_nms=True, use_pallas_roi_align=True)),
    "topk-exact": (dict(approx_topk=False), {}, {}),
    "window-combined": (dict(topk_window=3, roi_impl="combined"), {}, {}),
}


@pytest.mark.parametrize("case", sorted(E2E))
def test_extractor_end_to_end(det, case):
    ov, jkw, tkw = E2E[case]
    jm = JFRCNN(JDC(**SMALL, **ov), with_detections=True,
                num_classes=NUM_CLASSES, **jkw)
    want = jax.tree.map(np.asarray, jax.jit(jm.apply)(
        det["params"], jnp.asarray(det["frames"])))
    cfg = dict(SMALL, **ov)
    tm = FasterRCNNExtractor(TDC(**cfg), with_detections=True,
                             num_classes=NUM_CLASSES, **tkw)
    tm.load_state_dict(detector_params_from_jax(det["tree"]))
    got = {k: v.numpy() for k, v in tm(torch.from_numpy(det["frames"]))
           .items()}
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["region_valid"], want["region_valid"])
    clear = _clear_of_ties(want["scores"], want["region_valid"])
    assert clear.any()
    np.testing.assert_allclose(got["boxes"][clear], want["boxes"][clear],
                               rtol=0, atol=64 * 1e-4)
    _close(got["feats"][clear], want["feats"][clear])
    _close(got["scores"][clear], want["scores"][clear], 1e-5)
    np.testing.assert_array_equal(got["det_classes"][clear],
                                  want["det_classes"][clear])
    _close(got["det_boxes"][clear], want["det_boxes"][clear])


def test_fold_bn_matches_reference(det):
    tree = det["tree"]
    folded = jax.tree.map(np.asarray, j_fold(det["params"]))
    tm = _port(tree)
    fold_frozen_bn(tm)
    fold_frozen_bn(tm)                                 # idempotent
    want = detector_params_from_jax(folded)
    got = tm.state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)


def test_init_detector_distributions():
    cfg = TDC(**SMALL, fold_bn=False)
    m = init_detector(cfg, torch.Generator().manual_seed(0), device="cpu",
                      with_detections=True, num_classes=NUM_CLASSES)
    w = m.backbone.Bottleneck_8.Conv_1.weight          # 3x3, 256 in
    std = (1.0 / w[0].numel()) ** 0.5
    assert abs(w.std().item() / std - 1) < 0.02
    assert w.abs().max().item() <= 2 * std / .87962566103423978 + 1e-6
    assert torch.equal(m.rpn.Conv_0.bias, torch.zeros_like(m.rpn.Conv_0.bias))
    bn = m.backbone.FrozenBN_0
    assert torch.equal(bn.scale, torch.ones(64)) and torch.equal(
        bn.var, torch.ones(64)) and torch.equal(bn.mean, torch.zeros(64))
    again = init_detector(cfg, torch.Generator().manual_seed(0), device="cpu",
                          with_detections=True, num_classes=NUM_CLASSES)
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                 again.state_dict().values()))


def test_bf16_detector_runs():
    m = init_detector(TDC(**SMALL, dtype="bfloat16", full_pool_nms=True),
                      torch.Generator().manual_seed(0), device="cpu")
    out = m(torch.rand(2, 64, 64, 3, generator=torch.Generator()
                       .manual_seed(1)))
    assert out["feats"].dtype == torch.float32
    assert out["feats"].shape == (2, 5, 2048)
    assert torch.isfinite(out["feats"]).all()


@pytest.mark.parametrize("knob", ["stem_s2d", "stem_im2col", "stem_nminor",
                                  "stem_pad_ch"])
def test_unported_options_raise(det, knob):
    """Each of the reference's TPU stem knobs is accepted: with it on, the
    port's detector (its plain 7x7/s2 stem) gives the JAX detector's C4
    features under the same knob, from the same parameters, within 1e-4
    of the largest entry."""
    kw = {knob: 8 if knob == "stem_pad_ch" else True}
    jm = JFRCNN(JDC(**SMALL, **kw), with_detections=True,
                num_classes=NUM_CLASSES)
    want = jm.apply(det["params"], jnp.asarray(det["frames"]),
                    method=lambda m, im: m.backbone(im))
    with torch.no_grad():
        got = _port(det["tree"], **kw).backbone(
            torch.from_numpy(det["frames"]))
    assert got.shape == want.shape
    _close(got, want)


def test_init_vgg16_detector():
    """detector.backbone=vgg16 builds the VGG16 detector: 13 biased 3x3
    convs, fc6/fc7, a 512-in RPN and a 4096-in detection head, drawn in
    flax's distributions (lecun-normal kernels, zero biases); the module
    names are the flax tree's."""
    m = init_detector(TDC(**SMALL, backbone="vgg16", rpn_channels=512),
                      torch.Generator().manual_seed(0), device="cpu",
                      with_detections=True, num_classes=NUM_CLASSES)
    _, jp = j_init(jax.random.PRNGKey(0), JDC(**SMALL, backbone="vgg16",
                                              rpn_channels=512),
                   with_detections=True, num_classes=NUM_CLASSES)
    want = detector_params_from_jax(jax.tree.map(np.asarray, jp))
    got = m.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
    assert m.rpn.Conv_0.weight.shape == (512, 512, 3, 3)
    assert m.det_head.cls.weight.shape == (NUM_CLASSES + 1, 4096)
    w = m.backbone.Conv_4.weight                       # 3x3, 128 in
    std = (1.0 / w[0].numel()) ** 0.5
    assert abs(w.std().item() / std - 1) < 0.02
    assert torch.equal(m.backbone.Conv_4.bias, torch.zeros(256))
    fc6 = m.head.Dense_0.weight
    assert abs(fc6[:64].std().item() * 25088 ** 0.5 - 1) < 0.02
