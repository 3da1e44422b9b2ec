"""The port's VGG16 Faster R-CNN (`detector.backbone=vgg16`,
nafae_torch.models.detector.vgg) against the JAX package's, on the CPU in
f32, with the JAX weights carried across by `detector_params_from_jax`
(conv biases, fc6/fc7 as Dense_0/Dense_1).

Held: the detector at image 64, on the top-k route and on config 5's
full-pool route, region_valid equal and boxes, scores and 4096-d feats
within 1e-4 of each tensor's largest entry; the inline config-5 step with
the VGG16 detector (tests/test_detector.py's shapes: 32x32 frames, B=2,
T=2) against JAX's `build_train_fn`, metrics within rtol 1e-5 and
gradients within rtol 1e-4 / atol 1e-6 on both `train.kernels` routes, as
tests/test_torch_inline.py holds the ResNet step. Also: the bf16 detector
runs, and the flatten before fc6 is the (h, w, c) one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nafae_tpu.config as jcfg
import nafae_torch.config as tcfg
from nafae_tpu import train as JT
from nafae_tpu.config import DetectorConfig as JDC
from nafae_tpu.models.detector.faster_rcnn import \
    FasterRCNNExtractor as JFRCNN
from nafae_tpu.models.detector.faster_rcnn import init_detector as j_init
from nafae_torch import train as TT
from nafae_torch.config import DetectorConfig as TDC
from nafae_torch.models.detector.faster_rcnn import (FasterRCNNExtractor,
                                                     detector_params_from_jax)
from nafae_torch.models.grounding import state_from_jax

VGG = dict(backbone="vgg16", image_size=64, num_proposals=4,
           rpn_pre_nms_topk=16, anchor_scales=(16, 32), rpn_channels=512,
           approx_topk=False)
# tests/test_detector.py::test_inline_train_step_vgg_backbone
OV = ["detector.backbone=vgg16", "detector.rpn_channels=512",
      "model.feat_dim=4096", "model.embed_dim=16", "data.batch_size=2",
      "data.max_frames=2", "data.num_regions=4", "data.max_words=3",
      "loss.num_clusters=4", "loss.ctx_window=1", "loss.kmeans_interval=1",
      "detector.image_size=32", "detector.num_proposals=4",
      "detector.rpn_pre_nms_topk=8", "detector.anchor_scales=[8,16]",
      "train.warmup_steps=0", "train.donate=false"]


def _close(got, want, frac=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale)


@pytest.fixture(scope="module")
def det():
    """JAX's VGG16 detector weights, once for the module (fc6 alone is
    25088 x 4096), as a flax tree and as the port's state dict. The tree
    does not depend on the image size, and both configs have 6 anchors."""
    _, params = j_init(jax.random.PRNGKey(1), JDC(**VGG))
    sd = detector_params_from_jax(jax.tree.map(np.asarray, params))
    return {"params": params, "sd": sd}


def _port(sd, cfg):
    m = FasterRCNNExtractor(cfg).eval()
    m.load_state_dict(sd)
    return m


@pytest.mark.parametrize("full_pool", [False, True],
                         ids=["topk", "full-pool"])
def test_vgg_detector_matches_jax(det, full_pool):
    kw = dict(VGG, full_pool_nms=full_pool)
    frames = np.random.RandomState(0).rand(3, 64, 64, 3).astype(np.float32)
    want = jax.jit(JFRCNN(JDC(**kw)).apply)(det["params"], frames)
    got = _port(det["sd"], TDC(**kw))(torch.from_numpy(frames))
    assert got["feats"].shape == (3, 4, 4096)
    np.testing.assert_array_equal(got["region_valid"].numpy(),
                                  np.asarray(want["region_valid"]))
    for k in ("boxes", "scores", "feats"):
        _close(got[k].numpy(), want[k])


def test_vgg_head_flattens_hwc(det):
    """fc6 reads the crop flattened (h, w, c): a crop that is zero but for
    one cell and channel gives fc6's column (h·7 + w)·512 + c."""
    m = _port(det["sd"], TDC(**VGG))
    crop = torch.zeros(1, 7, 7, 512)
    crop[0, 2, 5, 300] = 1.0
    w6, b6 = m.head.Dense_0.weight, m.head.Dense_0.bias
    want = torch.relu(torch.relu(w6[:, (2 * 7 + 5) * 512 + 300] + b6)
                      @ m.head.Dense_1.weight.T + m.head.Dense_1.bias)
    torch.testing.assert_close(m.head(crop)[0], want, rtol=1e-5, atol=1e-6)


def test_bf16_vgg_detector_runs(det):
    m = _port(det["sd"], TDC(**VGG, dtype="bfloat16", full_pool_nms=True))
    out = m(torch.rand(2, 64, 64, 3, generator=torch.Generator()
                       .manual_seed(1)))
    assert out["feats"].dtype == torch.float32
    assert out["feats"].shape == (2, 4, 4096)
    assert torch.isfinite(out["feats"]).all()


@pytest.mark.parametrize("kernels", ["auto", "pallas"])
def test_inline_vgg_step_matches_jax(det, kernels):
    ov = OV + [f"train.kernels={kernels}"]
    jc = jcfg.load_config(preset_name="config5", overrides=ov)
    tc = tcfg.load_config(preset_name="config5", overrides=ov)
    ext = (JFRCNN(jc.detector).apply, det["params"])
    tdet = _port(det["sd"], tc.detector)
    rng = np.random.RandomState(0)
    batch = {
        "frames": rng.rand(2, 2, 32, 32, 3).astype(np.float32),
        "word_ids": rng.randint(0, 67, (2, 3)).astype(np.int32),
        "frame_mask": np.array([[1, 1], [1, 0]], np.float32),
        "word_mask": np.array([[1, 1, 1], [1, 1, 0]], np.float32),
        "segment_id": np.arange(2, dtype=np.int32),
    }
    js = jax.tree.map(np.asarray, JT.TrainState.create(
        jax.random.PRNGKey(0), jc))
    assert js.params["w_v"].shape[0] == 4096
    ts = state_from_jax(js, "cpu")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = TT.batch_to_device(batch, torch.device("cpu"))

    gj = jax.jit(jax.grad(lambda p: JT.compute_losses(
        p, js.centers, jb, jc, 0, kernels=jc.train.resolved_kernels(),
        extractor=ext)[0]))(js.params)
    params = {k: v.detach().requires_grad_() for k, v in ts.params.items()}
    total, _ = TT.compute_losses(params, ts.centers, tb, tc,
                                 tc.train.resolved_kernels(), tdet)
    names = sorted(params)
    gt = dict(zip(names, torch.autograd.grad(total, [params[k]
                                                     for k in names])))
    assert set(gt) == set(gj)
    for k in gj:
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)

    _, mj = JT.build_train_fn(jc, None, extractor=ext)(
        jax.tree.map(jnp.asarray, js), jb)
    new, mt = TT.train_step(ts, tb, tc, extractor=tdet)
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert new.step == 1
