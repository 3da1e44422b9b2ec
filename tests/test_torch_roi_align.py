"""The port's RoIAlign (nafae_torch.ops.roi_align: the gather, separable and
combined forms; nafae_torch.ops.kernels.roi_align: the plain version of the
RoIAlign kernel K5 and its wrapper) against the JAX package's
`ops/roi_align` forms and the TPU kernel `roi_align_pallas` (interpret
mode, as tests/test_pallas.py runs it), on the same numpy maps and boxes.

Held: f32 at rtol 1e-5 / atol 1e-6 form against form (the kernel's plain
version against an f64 sum of its own weights and against JAX's separable
form, each product form against its JAX twin; the plain version against
roi_align_pallas at atol 1e-5, see the test),
1e-4 / 1e-5 against a gather form (tests/test_pallas.py:268-273: the four
taps and the sample mean summed in another order, with cancellation); bf16 features at 2e-2; edge boxes: the all-zero
boxes of dead NMS slots, boxes running off the map, boxes smaller than a
cell; H != W and C not a multiple of 32; a frame of dead boxes, R = 1 and
33, C = 1024, a 200 x 136 map, sampling ratios 1 and 3 (the cases the CUDA
kernel's staging is likely to break). The CUDA kernel runs only on a
GPU: the `cuda` test skips here, and chip_smoke.py holds it against the
plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nafae_tpu.ops import roi_align as JR
from nafae_tpu.ops.pallas.roi_align import roi_align_pallas
from nafae_torch.ops import roi_align as TR
from nafae_torch.ops.kernels import roi_align as K


def _boxes(rng, n, extent):
    xy = rng.rand(n, 2) * extent * 0.8
    wh = rng.rand(n, 2) * extent * 0.6 + 2
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _edge_boxes(h, w, scale):
    """Image-coordinate boxes: all zero, off the map on every side, smaller
    than a cell, the whole map, a degenerate line."""
    H, W = h / scale, w / scale
    return np.array([[0, 0, 0, 0],
                     [-40, -30, 5, 6],
                     [W - 4, H - 3, W + 50, H + 70],
                     [-100, -100, -50, -60],
                     [3.1, 3.1, 3.3, 3.2],
                     [0, 0, W, H],
                     [7.5, 2.0, 7.5, 20.0]], np.float32)


# frames, H, W, C, boxes a frame, spatial scale
SHAPES = {"small": (2, 12, 14, 8, 5, 0.5), "c37": (3, 9, 16, 37, 4, 0.25),
          "square": (1, 10, 10, 33, 6, 1.0)}


def _inputs(case, edge, seed=0):
    f, h, w, c, n, scale = SHAPES[case]
    rng = np.random.RandomState(seed)
    feat = rng.randn(f, h, w, c).astype(np.float32)
    if edge:
        bx = np.stack([_edge_boxes(h, w, scale)] * f)
    else:
        bx = np.stack([_boxes(rng, n, min(h, w) / scale) for _ in range(f)])
    return feat, bx, scale


def _jax_per_frame(fn, feat, boxes, scale, **kw):
    return np.concatenate([np.asarray(fn(jnp.asarray(feat[i]),
                                         jnp.asarray(boxes[i]), out_size=7,
                                         spatial_scale=scale, **kw))
                           for i in range(feat.shape[0])])


def _rand_boxes(rng, f, r, h, w, scale):
    return np.stack([np.concatenate([
        (xy := rng.rand(r, 2) * [w / scale, h / scale] * 0.8),
        xy + rng.rand(r, 2) * [w / scale, h / scale] * 0.6 + 2], 1)
        for _ in range(f)]).astype(np.float32)


def _edge_case(name):
    """(feat, boxes, scale, sampling ratio) of the cases the CUDA kernel's
    staging is likely to break: a frame whose boxes are all dead NMS slots,
    the whole map beside sub-cell boxes, R = 1 and 33, the config-5 width
    (C = 1024 on 40 x 40), a map too large to stage whole, sampling ratios
    other than 2."""
    rng = np.random.RandomState(len(name))
    f, h, w, c, r, scale, sr = {
        "dead_frame": (2, 12, 12, 8, 6, 0.5, 2),
        "whole_and_subcell": (1, 40, 40, 8, 6, 1 / 16, 2),
        "R1": (2, 10, 12, 8, 1, 0.25, 2),
        "R33": (2, 10, 12, 8, 33, 0.25, 2),
        "C1024": (1, 40, 40, 1024, 3, 1 / 16, 2),
        "row_bands": (1, 200, 136, 64, 3, 0.125, 2),
        "sr1": (2, 14, 10, 12, 5, 0.5, 1),
        "sr3": (2, 14, 10, 12, 5, 0.5, 3),
    }[name]
    feat = rng.randn(f, h, w, c).astype(np.float32)
    boxes = _rand_boxes(rng, f, r, h, w, scale)
    if name == "dead_frame":
        boxes[0] = 0.0
    if name in ("whole_and_subcell", "row_bands"):
        boxes[0, 0] = [0, 0, w / scale, h / scale]
    if name == "whole_and_subcell":
        boxes[0, 1:, 2:] = boxes[0, 1:, :2] + [3.0, 2.0]
    return feat, boxes, scale, sr


EDGE_CASES = ["dead_frame", "whole_and_subcell", "R1", "R33", "C1024",
              "row_bands", "sr1", "sr3"]


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_forms_match_jax_f32(case, edge):
    feat, boxes, scale = _inputs(case, edge)
    tf, tb = torch.from_numpy(feat), torch.from_numpy(boxes)
    want_pk = _jax_per_frame(roi_align_pallas, feat, boxes, scale)
    got_pk = K.roi_align(tf, tb, 7, scale)            # CPU: the plain version
    assert got_pk.dtype == torch.float32
    c = feat.shape[-1]
    # the same weights, sums in f64: the plain version is within 1e-6
    b = tb * scale
    wy = TR._weights(b[..., 1], b[..., 3], feat.shape[1], 7, 2).double()
    wx = TR._weights(b[..., 0], b[..., 2], feat.shape[2], 7, 2).double()
    exact = torch.einsum("frph,frqw,fhwc->frpqc", wy, wx,
                         tf.double()).reshape(got_pk.shape)
    np.testing.assert_allclose(got_pk.numpy(), exact.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        got_pk.numpy(), _jax_per_frame(JR.roi_align_matmul, feat, boxes,
                                       scale), rtol=1e-5, atol=1e-6)
    # the TPU kernel run in interpret mode is itself off the f64 sum of
    # these weights by up to 2.1e-6 on the "square" case (the plain
    # version by 2.8e-7, JAX's separable form by 2.3e-7), also on boxes
    # whose weights are exact in f32, so it is held at atol 1e-5
    np.testing.assert_allclose(got_pk.numpy(), want_pk, rtol=1e-5, atol=1e-5)
    for jfn, tfn in ((JR.roi_align_matmul, TR.roi_align_matmul),
                     (JR.roi_align_combined, TR.roi_align_combined)):
        want = _jax_per_frame(jfn, feat, boxes, scale)
        got = tfn(tf, tb, 7, scale).reshape(-1, 7, 7, c)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    want_g = _jax_per_frame(JR.roi_align, feat, boxes, scale)
    got_g = torch.cat([TR.roi_align(tf[i], tb[i], 7, scale)
                       for i in range(tf.shape[0])])
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_pk.numpy(), want_g, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_bf16_feat(case):
    """bf16 maps: the plain version rounds its weights to bf16 and sums in
    f32 (f32 output), as the TPU kernel does, so it is held to it as in f32
    (1e-5); the separable form returns bf16, within 2e-2."""
    feat, boxes, scale = _inputs(case, False, seed=1)
    fb = torch.from_numpy(feat).to(torch.bfloat16)
    tb = torch.from_numpy(boxes)
    want = _jax_per_frame(roi_align_pallas,
                          np.asarray(jnp.asarray(feat, jnp.bfloat16)), boxes,
                          scale)
    got = K.roi_align(fb, tb, 7, scale)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    mm = TR.roi_align_matmul(fb, tb, 7, scale)
    assert mm.dtype == torch.bfloat16
    np.testing.assert_allclose(mm.float().reshape(got.shape).numpy(), want,
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_plain_matches_the_tpu_kernel_at_edge_cases(case, dtype):
    """The plain version, which the card holds the CUDA kernel to, against
    `roi_align_pallas` at the edge cases, f32 and bf16 maps, and in f32
    against JAX's separable form at 1e-6. Against the interpreted kernel
    f32 takes atol 1e-5 (see test_forms_match_jax_f32), and 1e-4 on the
    200 x 136 map: there the interpreted kernel is off JAX's own separable
    form and the f64 sum of these weights by 3.3e-5 (sample points near 200
    carry an f32 step of 1.5e-5), the plain version by 2.4e-7. With bf16
    maps both sides round the weights to bf16; XLA may contract the sample
    point's multiply-add, so a weight near a bf16 midpoint can round the
    other way (2^-8 of it) for one (box, p) or (box, q): at least 90% of
    the outputs are held at 1e-5, all at the bf16 tolerance 2e-2."""
    feat, boxes, scale, sr = _edge_case(case)
    tf, tb = torch.from_numpy(feat), torch.from_numpy(boxes)
    jf = feat
    if dtype == "bfloat16":
        tf = tf.to(torch.bfloat16)
        jf = np.asarray(jnp.asarray(feat, jnp.bfloat16))
    got = K.roi_align(tf, tb, 7, scale, sr)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    want = _jax_per_frame(roi_align_pallas, jf, boxes, scale,
                          sampling_ratio=sr)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-4 if case == "row_bands" else 1e-5)
        np.testing.assert_allclose(
            got.numpy(), _jax_per_frame(JR.roi_align_matmul, feat, boxes,
                                        scale, sampling_ratio=sr),
            rtol=1e-5, atol=1e-6)
    else:
        close = np.isclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        assert close.mean() >= 0.9, close.mean()
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)
    if case == "dead_frame":               # dead slots: all the same cell
        dead = got[:boxes.shape[1]]
        assert torch.equal(dead, dead[:1].expand_as(dead))


def test_bilinear_weights_match_jax():
    rng = np.random.RandomState(2)
    coords = np.sort(rng.rand(6, 2) * 30 - 5, axis=1).astype(np.float32)
    want = JR.bilinear_weights(jnp.asarray(coords), 17, 7, 2)
    got = TR.bilinear_weights(torch.from_numpy(coords), 17, 7, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_frame_chunks_do_not_change_the_result(monkeypatch):
    feat, boxes, scale = _inputs("c37", False)
    tf, tb = torch.from_numpy(feat), torch.from_numpy(boxes)
    whole = K.roi_align_plain(tf, tb, 7, scale)
    mm = TR.roi_align_matmul(tf, tb, 7, scale)
    for chunk in (1, 2):
        monkeypatch.setattr(TR, "FRAME_CHUNK", chunk)
        assert torch.equal(K.roi_align_plain(tf, tb, 7, scale), whole)
        assert torch.equal(TR.roi_align_matmul(tf, tb, 7, scale), mm)


def test_launch_rejects_what_the_kernel_does_not_take():
    f = torch.zeros(2, 4, 4, 8)
    b = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="feat"):
        K.launch(torch.zeros(4, 4, 8), b)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        K.launch(f.double(), b)
    with pytest.raises(ValueError, match="H, W"):
        K.launch(torch.zeros(1, 4, 3000, 8), torch.zeros(1, 3, 4))
    with pytest.raises(ValueError, match="sampling_ratio"):
        K.launch(f, b, 1.0, 0)
    with pytest.raises(ValueError, match="boxes must be"):
        K.launch(f, torch.zeros(2, 3, 4).double().float()[:, :, :3]
                 .contiguous().reshape(2, 3, 3))
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.roi_align(f.to("meta"), b.to("meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on "
                    "the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_gpu(cuda_device, dtype):
    """Every shape, random and edge boxes: within rtol 1e-5 / atol 1e-6 of
    the plain version (same weights, f32 sums in another order), one launch
    a call."""
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    cases = [(*_inputs(case, edge), 2) for case in sorted(SHAPES)
             for edge in (False, True)]
    cases += [_edge_case(name) for name in EDGE_CASES]
    for feat, boxes, scale, sr in cases:
        tf = torch.from_numpy(feat).to(cuda_device, tdt)
        tb = torch.from_numpy(boxes).to(cuda_device)
        before = K.launches["roi_align"]
        got = K.roi_align(tf, tb, 7, scale, sr)
        torch.cuda.synchronize()
        assert K.launches["roi_align"] == before + 1
        torch.testing.assert_close(got, K.roi_align_plain(tf, tb, 7, scale, sr),
                                   rtol=1e-5, atol=1e-6)
