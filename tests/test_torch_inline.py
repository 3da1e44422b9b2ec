"""The port's config-5 inline training step (frames -> frozen Faster R-CNN
-> losses, nafae_torch.train with an extractor) against the JAX package's
`build_train_fn(cfg, extractor=...)` on the CPU, at tests/test_e2e.py's
small shapes: the same frames, grounding state and detector weights
(carried across by `detector_params_from_jax`).

Held for both `train.kernels` routes (auto; pallas, whose fused kernels the
JAX side runs in interpret mode): one step's metrics within rtol 1e-5 and
its gradients within rtol 1e-4 / atol 1e-6 of JAX's, the detector's
outputs reaching the losses as feats, boxes and region mask. Also: `fit`
trains 2 steps with data.from_videos=true from AVI files, and with
`detector.weights` its first step is the step through the JAX package's
converted and folded checkpoint.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nafae_tpu.config as jcfg
import nafae_torch.config as tcfg
from nafae_tpu import train as JT
from nafae_tpu.models.detector.faster_rcnn import init_detector as j_init
from nafae_torch import train as TT
from nafae_torch.models.detector.faster_rcnn import (
    FasterRCNNExtractor, detector_params_from_jax)
from nafae_torch.models.grounding import state_from_jax

OV = ["model.feat_dim=2048", "model.embed_dim=32", "data.batch_size=2",
      "data.max_frames=3", "data.num_regions=4", "data.max_words=3",
      "loss.num_clusters=4", "loss.ctx_window=2", "loss.kmeans_interval=1",
      "detector.image_size=64", "detector.num_proposals=4",
      "detector.rpn_pre_nms_topk=16", "detector.anchor_scales=[16,32]",
      "train.donate=false", "train.warmup_steps=0"]


@pytest.fixture(scope="module")
def inline():
    jc = jcfg.load_config(preset_name="config5", overrides=OV)
    model, det_params = j_init(jax.random.PRNGKey(1), jc.detector)
    rng = np.random.RandomState(0)
    batch = {
        "frames": rng.rand(2, 3, 64, 64, 3).astype(np.float32),
        "word_ids": rng.randint(0, 67, (2, 3)).astype(np.int32),
        "frame_mask": np.array([[1, 1, 1], [1, 1, 0]], np.float32),
        "word_mask": np.array([[1, 1, 1], [1, 1, 0]], np.float32),
        "segment_id": np.arange(2, dtype=np.int32),
    }
    tc = tcfg.load_config(preset_name="config5", overrides=OV)
    tdet = FasterRCNNExtractor(tc.detector).eval()
    tdet.load_state_dict(detector_params_from_jax(
        jax.tree.map(np.asarray, det_params)))
    return {"jc": jc, "extractor": (model.apply, det_params), "batch": batch,
            "tdet": tdet}


@pytest.mark.parametrize("kernels", ["auto", "pallas"])
def test_inline_step_matches_jax(inline, kernels):
    ov = [f"train.kernels={kernels}"]
    jc = jcfg.load_config(preset_name="config5", overrides=OV + ov)
    tc = tcfg.load_config(preset_name="config5", overrides=OV + ov)
    batch, ext, tdet = inline["batch"], inline["extractor"], inline["tdet"]
    js = jax.tree.map(np.asarray, JT.TrainState.create(
        jax.random.PRNGKey(0), jc))
    ts = state_from_jax(js, "cpu")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = TT.batch_to_device(batch, torch.device("cpu"))

    gj = jax.jit(jax.grad(lambda p: JT.compute_losses(
        p, js.centers, jb, jc, 0, kernels=jc.train.resolved_kernels(),
        extractor=ext)[0]))(js.params)
    params = {k: v.detach().requires_grad_() for k, v in ts.params.items()}
    total, aux = TT.compute_losses(params, ts.centers, tb, tc,
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


def test_detector_outputs_reach_the_losses(inline):
    """compute_losses with an extractor equals compute_losses on the
    detector's feats, boxes and NMS survivors as a feature batch."""
    tc = tcfg.load_config(preset_name="config5", overrides=OV)
    js = jax.tree.map(np.asarray, JT.TrainState.create(
        jax.random.PRNGKey(0), inline["jc"]))
    ts = state_from_jax(js, "cpu")
    tb = TT.batch_to_device(inline["batch"], torch.device("cpu"))
    det = inline["tdet"](tb["frames"].reshape(6, 64, 64, 3))
    fb = {k: v for k, v in tb.items() if k != "frames"}
    fb["feats"] = det["feats"].reshape(2, 3, 4, 2048)
    fb["boxes"] = det["boxes"].reshape(2, 3, 4, 4)
    fb["region_mask"] = det["region_valid"].reshape(2, 3, 4)
    a, _ = TT.compute_losses(ts.params, ts.centers, tb, tc,
                             extractor=inline["tdet"])
    b, _ = TT.compute_losses(ts.params, ts.centers, fb, tc)
    assert torch.equal(a, b)


@pytest.fixture
def segments(tmp_path):
    from nafae_torch.data.avi import write_avi
    rng = np.random.RandomState(0)
    lines = []
    for n in range(3):
        path = str(tmp_path / f"v{n}.avi")
        write_avi(path, [rng.randint(0, 256, (64, 64, 3), np.uint8)
                         for _ in range(5)], 1.0)
        lines.append(json.dumps({"id": f"seg{n}", "video": path,
                                 "sentence": "heat the oil in a pan and add "
                                             "onions"}))
    anns = tmp_path / "segments.jsonl"
    anns.write_text("\n".join(lines) + "\n")
    return str(anns)


def test_fit_from_videos(segments, tmp_path):
    tc = tcfg.load_config(preset_name="config5", overrides=OV + [
        "data.from_videos=true", f"data.annotations={segments}",
        "train.steps=2", "train.log_every=1", "train.ckpt_every=100",
        f"train.ckpt_dir={tmp_path}/ck"])
    logs = []
    state, metrics = TT.fit(tc, device="cpu", log_fn=logs.append)
    assert state.step == 2 and len(logs) == 2
    assert np.isfinite(float(metrics["loss"]))
    assert {"l_rank", "l_ctx", "l_clu"} <= set(metrics)


def test_fit_loads_detector_weights(segments, tmp_path):
    """fit with detector.weights (a faster-rcnn.pytorch checkpoint) and
    detector.fold_bn trains through the converted detector: its first
    step equals a step through the detector the JAX package's loader and
    fold give (`load_detector_weights`, `fold_frozen_bn`), carried across
    by detector_params_from_jax, from the same initial state."""
    from nafae_tpu.models.detector.resnet import fold_frozen_bn as j_fold
    from nafae_tpu.utils.torch_convert import load_detector_weights
    from nafae_torch.data.loader import BatchLoader
    from nafae_torch.data.video_dataset import VideoSegmentDataset
    from nafae_torch.data.vocab import vocab_from_config
    from tests.test_torch_convert_frcnn import make_frcnn_sd

    pth = str(tmp_path / "frcnn.pth")
    torch.save({"model": {"module." + k: torch.from_numpy(v) for k, v in
                          make_frcnn_sd(np.random.RandomState(9)).items()}},
               pth)
    tc = tcfg.load_config(preset_name="config5", overrides=OV + [
        "data.from_videos=true", f"data.annotations={segments}",
        "detector.rpn_channels=512", "detector.fold_bn=true",
        f"detector.weights={pth}", "train.steps=1", "train.log_every=1",
        f"train.ckpt_dir={tmp_path}/ck"])
    logs = []
    state, _ = TT.fit(tc, device="cpu", log_fn=logs.append)
    assert state.step == 1 and len(logs) == 1

    jc = jcfg.load_config(preset_name="config5", overrides=OV + [
        "detector.rpn_channels=512"])
    _, p0 = j_init(jax.random.PRNGKey(5), jc.detector)
    tree = j_fold(load_detector_weights(pth, p0, num_scales=2,
                                        num_ratios=3))
    tdet = FasterRCNNExtractor(tc.detector).eval()
    tdet.load_state_dict(detector_params_from_jax(
        jax.tree.map(np.asarray, tree)))
    ds = VideoSegmentDataset(segments, tc.data.max_frames,
                             tc.detector.image_size, tc.data.max_words,
                             frame_rate=tc.detector.frame_rate,
                             vocab=vocab_from_config(tc.data))
    batch = next(iter(BatchLoader(ds, tc.data.batch_size, shuffle=True,
                                  seed=tc.train.seed)))
    _, m = TT.train_step(TT.TrainState.create(tc, device="cpu"),
                         TT.batch_to_device(batch, torch.device("cpu")), tc,
                         extractor=tdet)
    for k, v in m.items():
        assert logs[0][k] == float(v), k
