"""The port's torch checkpoint conversion (nafae_torch.utils.torch_convert)
against the JAX package's (nafae_tpu.utils.torch_convert), on the CPU, on
state dicts made from seeded random numbers in the layouts the JAX
converter tests build (no checkpoint ships with the repository).

Held, bit for bit and key by key, for five lineages (torchvision resnet50,
resnet101 and vgg16; faster-rcnn.pytorch ResNet, nested under "model" with
"module." prefixes, and VGG16, each with an RPN and a detection head),
with and without the BN fold after the load: route A, the JAX package's
`load_detector_weights` on its initial params then
`detector_params_from_jax`, against route B, the port's
`load_detector_weights` on a detector that starts from the same initial
params. Also: a lineage or depth mismatch raises ValueError with the
reference's fix; `convert_state_dict` / `convert_pth` (a square w_v, the
optional keys) equal the reference's; the CLI's .npz serves through the
port's GroundingServer as the JAX CLI's serves through the JAX server.
"""

import json

import jax
import numpy as np
import pytest
import torch

from nafae_tpu.config import DetectorConfig as JDC
from nafae_tpu.models.detector.faster_rcnn import init_detector as j_init
from nafae_tpu.models.detector.resnet import fold_frozen_bn as j_fold
from nafae_tpu.utils import torch_convert as J
from nafae_torch.config import DetectorConfig as TDC
from nafae_torch.models.detector.faster_rcnn import (FasterRCNNExtractor,
                                                     detector_params_from_jax)
from nafae_torch.models.detector.resnet import RESNET_BLOCKS, fold_frozen_bn
from nafae_torch.utils import torch_convert as T
from tests.test_torch_convert_frcnn import make_frcnn_sd
from tests.test_torch_convert_vgg import make_vgg16_sd
from tests.test_utils import make_resnet50_sd

SCALES = (16, 32)
RATIOS = (0.5, 1.0, 2.0)
A = len(SCALES) * len(RATIOS)
NUM_CLASSES = 5


def _cfg(backbone):
    return dict(backbone=backbone, image_size=64, num_proposals=4,
                rpn_pre_nms_topk=16, anchor_scales=SCALES,
                anchor_ratios=RATIOS, rpn_channels=512)


def frcnn_vgg16_sd(rng, num_classes=NUM_CLASSES + 1):
    """faster-rcnn.pytorch vgg16 checkpoint: RCNN_base = features[:-1],
    RCNN_top = fc6/fc7, the 2A-channel RPN and linear detection heads."""
    sd = {}
    for k, v in make_vgg16_sd(rng).items():
        if k.startswith("features."):
            sd["RCNN_base." + k[len("features."):]] = v
        else:                                        # classifier.{0,3}
            sd["RCNN_top." + k[len("classifier."):]] = v
    f32 = np.float32
    sd["RCNN_rpn.RPN_Conv.weight"] = (rng.randn(512, 512, 3, 3) * 0.03
                                      ).astype(f32)
    sd["RCNN_rpn.RPN_Conv.bias"] = rng.randn(512).astype(f32)
    sd["RCNN_rpn.RPN_cls_score.weight"] = (rng.randn(2 * A, 512, 1, 1) * 0.1
                                           ).astype(f32)
    sd["RCNN_rpn.RPN_cls_score.bias"] = rng.randn(2 * A).astype(f32)
    sd["RCNN_rpn.RPN_bbox_pred.weight"] = (rng.randn(4 * A, 512, 1, 1) * 0.1
                                           ).astype(f32)
    sd["RCNN_rpn.RPN_bbox_pred.bias"] = (rng.randn(4 * A) * 0.1).astype(f32)
    sd["RCNN_cls_score.weight"] = (rng.randn(num_classes, 4096) * 0.05
                                   ).astype(f32)
    sd["RCNN_cls_score.bias"] = rng.randn(num_classes).astype(f32)
    sd["RCNN_bbox_pred.weight"] = (rng.randn(num_classes * 4, 4096) * 0.05
                                   ).astype(f32)
    sd["RCNN_bbox_pred.bias"] = (rng.randn(num_classes * 4) * 0.1).astype(f32)
    return sd


# lineage -> (detector backbone, state dict maker, how the .pth nests it)
LINEAGES = {
    "torchvision-resnet50": ("resnet50", lambda r: make_resnet50_sd(r),
                             "plain"),
    "torchvision-resnet101": ("resnet101", lambda r: make_resnet50_sd(
        r, blocks=RESNET_BLOCKS["resnet101"]), "plain"),
    "torchvision-vgg16": ("vgg16", make_vgg16_sd, "plain"),
    "faster-rcnn-resnet": ("resnet50", lambda r: make_frcnn_sd(r), "model"),
    "faster-rcnn-vgg16": ("vgg16", frcnn_vgg16_sd, "state_dict"),
}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Per backbone, JAX's initial detector params (with detection heads);
    per lineage, a .pth written once. Built lazily and kept for the
    module: the VGG16 trees hold fc6's 25088 x 4096 weights."""
    d = tmp_path_factory.mktemp("pth")
    inits, pths = {}, {}

    def init(backbone):
        if backbone not in inits:
            _, p = j_init(jax.random.PRNGKey(1), JDC(**_cfg(backbone)),
                          with_detections=True, num_classes=NUM_CLASSES)
            inits[backbone] = p
        return inits[backbone]

    def pth(lineage):
        if lineage not in pths:
            _, make, nest = LINEAGES[lineage]
            sd = {k: torch.from_numpy(v) for k, v in
                  make(np.random.RandomState(len(pths) + 3)).items()}
            if nest == "model":     # DataParallel prefixes, an epoch entry
                obj = {"model": {"module." + k: v for k, v in sd.items()},
                       "epoch": 1}
            elif nest == "state_dict":
                obj = {"state_dict": sd}
            else:
                obj = sd
            path = str(d / f"{lineage}.pth")
            torch.save(obj, path)
            pths[lineage] = path
        return pths[lineage]

    return init, pths, pth


@pytest.mark.parametrize("fold", [False, True], ids=["loaded", "folded"])
@pytest.mark.parametrize("lineage", list(LINEAGES))
def test_load_detector_weights_matches_jax(work, lineage, fold):
    init, _, pth = work
    backbone = LINEAGES[lineage][0]
    p0 = init(backbone)
    path = pth(lineage)

    pa = J.load_detector_weights(path, p0, num_scales=len(SCALES),
                                 num_ratios=len(RATIOS))
    if fold:
        pa = j_fold(pa)
    want = detector_params_from_jax(jax.tree.map(np.asarray, pa))
    del pa

    model = FasterRCNNExtractor(TDC(**_cfg(backbone)), with_detections=True,
                                num_classes=NUM_CLASSES).eval()
    model.load_state_dict(detector_params_from_jax(
        jax.tree.map(np.asarray, p0)))
    out = T.load_detector_weights(path, model, num_scales=len(SCALES),
                                  num_ratios=len(RATIOS))
    assert out is model
    if fold:
        fold_frozen_bn(model)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # the checkpoint really landed: the first conv is the source's
    first = "RCNN_base.0.weight" if "faster" in lineage else (
        "features.0.weight" if backbone == "vgg16" else "conv1.weight")
    src = torch.load(path, weights_only=True, mmap=True)
    src = src.get("model", src.get("state_dict", src))
    src = {k.removeprefix("module."): v for k, v in src.items()}
    if not fold or backbone == "vgg16":
        assert torch.equal(got["backbone.Conv_0.weight"], src[first])


def _fix(msg):
    """The fix a mismatch message names: the text after the dash."""
    return msg.split("—", 1)[1].strip()


@pytest.mark.parametrize("case", ["vgg16-into-resnet", "resnet-into-vgg16",
                                  "resnet101-into-resnet50"])
def test_mismatch_raises_with_the_fix(work, case):
    init = work[0]
    rng = np.random.RandomState(23)
    if case == "vgg16-into-resnet":
        sd, backbone, jfn, tfn = (make_vgg16_sd(rng), "resnet50",
                                  J.convert_detector_vgg16,
                                  T.convert_detector_vgg16)
    elif case == "resnet-into-vgg16":
        sd, backbone, jfn, tfn = (make_resnet50_sd(rng), "vgg16",
                                  J.convert_detector_resnet50,
                                  T.convert_detector_resnet50)
    else:
        sd, backbone, jfn, tfn = (
            make_resnet50_sd(rng, blocks=RESNET_BLOCKS["resnet101"]),
            "resnet50", J.convert_detector_resnet50,
            T.convert_detector_resnet50)
    with pytest.raises(ValueError) as want:
        jfn(sd, init(backbone))
    model = FasterRCNNExtractor(TDC(**_cfg(backbone)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError) as got:
        tfn(sd, model)
    assert _fix(str(got.value)) == _fix(str(want.value))
    assert "detector.backbone" in _fix(str(got.value))
    # nothing was written before the check
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())


def _grounding_sd(rng, v=67, e=16, d=16, name="vis_proj.weight"):
    """A grounding checkpoint: square w_v (D = E, where a shape guess would
    pick the wrong orientation) and both optional params."""
    return {"emb.weight": rng.randn(v, e).astype(np.float32),
            name: rng.randn(e, d).astype(np.float32),
            "vis_proj.bias": rng.randn(e).astype(np.float32),
            "frame_attn.weight": rng.randn(1, e).astype(np.float32),
            "bilinear.weight": rng.randn(e, e).astype(np.float32)}


@pytest.mark.parametrize("name", ["vis_proj.weight", "w_v"])
def test_convert_state_dict_matches_jax(name):
    sd = _grounding_sd(np.random.RandomState(0), name=name)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    want = J.convert_state_dict(tsd)
    got = T.convert_state_dict(tsd)
    assert set(got) == set(want) == {"word_emb", "w_v", "b_v", "attn_w",
                                     "m_sim"}
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    expect = {"w_v": (16, 16)}
    np.testing.assert_array_equal(
        T.convert_state_dict(sd, expect=expect)["w_v"],
        sd[name].T if name != "w_v" else sd[name])
    with pytest.raises(ValueError, match="w_v"):
        T.convert_state_dict(sd, expect={"w_v": (16, 8)})
    with pytest.raises(KeyError, match="word_emb"):
        T.convert_state_dict({k: v for k, v in sd.items()
                              if k != "emb.weight"})


def test_convert_pth_matches_jax(tmp_path):
    sd = _grounding_sd(np.random.RandomState(1))
    path = str(tmp_path / "g.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "epoch": 3}, path)
    key_map = {"word_emb": ["emb.weight"], "w_v": ["vis_proj.weight"],
               "b_v": ["vis_proj.bias"]}
    for km in (None, key_map):
        want = J.convert_pth(path, str(tmp_path / "j.npz"), km)
        got = T.convert_pth(path, str(tmp_path / "t.npz"), km)
        assert set(got) == set(want)
        with np.load(tmp_path / "j.npz") as jz, \
                np.load(tmp_path / "t.npz") as tz:
            assert sorted(tz.files) == sorted(jz.files)
            for k in jz.files:
                np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cli_npz_serves(tmp_path, capsys):
    """`python -m nafae_torch.utils.torch_convert` writes the JAX CLI's
    .npz; the port's server answers on it as the JAX server answers on
    the JAX CLI's file."""
    import nafae_tpu.config as jcfg
    import nafae_torch.config as tcfg
    from nafae_tpu.serve import GroundingServer as JaxServer
    from nafae_tpu.utils.torch_convert import load_converted
    from nafae_torch.serve import GroundingServer, _load_params
    from tests.test_torch_serve import _assert_same_response, _segments

    rng = np.random.RandomState(2)
    sd = {"emb.weight": rng.randn(67, 8).astype(np.float32),
          "vis_proj.weight": (rng.randn(8, 16) / 4).astype(np.float32),
          "vis_proj.bias": (rng.randn(8) * 0.1).astype(np.float32)}
    pth = str(tmp_path / "g.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    J.main([pth, str(tmp_path / "j.npz")])
    want_out = capsys.readouterr().out
    T.main([pth, str(tmp_path / "t.npz")])
    got_out = capsys.readouterr().out
    assert json.loads(got_out) == json.loads(want_out) == {
        "word_emb": [67, 8], "w_v": [16, 8], "b_v": [8]}

    over = ["data.feat_dim=16", "model.feat_dim=16", "model.embed_dim=8",
            "data.max_frames=6", "data.num_regions=4", "data.max_words=3",
            "data.batch_size=4"]
    tc = tcfg.load_config(preset_name="config1", overrides=over)
    jc = jcfg.load_config(preset_name="config1", overrides=over)
    segs = _segments(5, seed=3)
    got = GroundingServer(tc, _load_params(tc, str(tmp_path / "t.npz"),
                                           torch.device("cpu")),
                          device="cpu").ground_segments(segs)
    want = JaxServer(jc, load_converted(str(tmp_path / "j.npz"))
                     ).ground_segments(segs)
    _assert_same_response(got, want)
