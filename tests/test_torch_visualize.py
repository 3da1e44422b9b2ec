"""The port's visualize (nafae_torch.visualize) against the JAX package's.

The same numpy params and the synthetic val split go to
`nafae_tpu.visualize.visualize_config` and to the port's on the CPU:
predictions.jsonl must be equal line for line. The port draws boxes with
numpy and writes PNGs through zlib (the GPU machine has no cv2); its boxes
must equal `cv2.rectangle`'s pixels on the same canvas (cv2 is here), and
its PNGs must read back through cv2 as the frames it drew. Also: the CLI
with a checkpoint directory and --no-render, a split without ground
truth, and `python -m nafae_torch`.
"""

import json
import os
import shutil
import subprocess
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

import nafae_tpu.config as jcfg
import nafae_torch.config as tcfg
from nafae_tpu import visualize as JV
from nafae_tpu.data.synthetic import _class_directions
from nafae_torch import visualize as TV

SMALL = ["data.feat_dim=64", "model.feat_dim=64", "model.embed_dim=32"]


def _cfgs(root):
    ov = SMALL + [f"data.root={root}"]
    return (jcfg.load_config(preset_name="config1", overrides=ov),
            tcfg.load_config(preset_name="config1", overrides=ov))


def _oracle():
    dirs = _class_directions(67, 64)
    w = dirs.T[:, :32].astype(np.float32)
    return {"word_emb": (dirs @ w).astype(np.float32), "w_v": w,
            "b_v": np.zeros(32, np.float32)}


def _random(seed=3):
    rng = np.random.RandomState(seed)
    return {"word_emb": rng.randn(67, 32).astype(np.float32),
            "w_v": (rng.randn(64, 32) / 8).astype(np.float32),
            "b_v": (rng.randn(32) * 0.1).astype(np.float32)}


def _lines(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


@pytest.mark.parametrize("which", ["oracle", "random"])
def test_predictions_equal_the_reference(synth_root, tmp_path, which):
    params = _oracle() if which == "oracle" else _random()
    jc, tc = _cfgs(synth_root)
    want = JV.visualize_config(jc, str(tmp_path / "jax"),
                               {k: jnp.asarray(v) for k, v in params.items()},
                               num_segments=12, render=False)
    got = TV.visualize_config(tc, str(tmp_path / "torch"), params,
                              num_segments=12, render=True, device="cpu")
    assert _lines(got) == _lines(want)
    recs = _lines(got)
    assert any("hit" in r for r in recs)
    seg = recs[0]["segment"]
    frames = sorted({r["frame"] for r in recs if r["segment"] == seg})
    pngs = sorted(os.listdir(tmp_path / "torch" / seg))
    assert pngs == [f"frame{t:03d}.png" for t in frames]
    # each PNG is the frame render_frame draws, read back by cv2 as BGR
    t = frames[0]
    img = cv2.imread(str(tmp_path / "torch" / seg / pngs[0]))
    size = TV._canvas_size([r for r in recs if r["segment"] == seg], 640)
    want_img = TV.render_frame(
        np.full((size, size, 3), 40, np.uint8),
        [r for r in recs if r["segment"] == seg and r["frame"] == t])
    np.testing.assert_array_equal(img, want_img)


def _boxes(rng, n, size):
    """Boxes inside, across and outside the canvas, degenerate, inverted."""
    xy = rng.integers(-6, size + 6, (n, 4))
    xy[0] = [3, 3, 3, 3]
    xy[1] = [0, 0, size - 1, size - 1]
    xy[2] = [size - 2, 5, size + 3, 9]
    xy[3] = [9, 7, 2, 1]
    xy[4] = [-3, -1, 4, 0]
    return xy


@pytest.mark.parametrize("thickness", [1, 2])
@pytest.mark.parametrize("size", [13, 40])
def test_draw_rectangle_equals_cv2(thickness, size):
    rng = np.random.default_rng(size + thickness)
    for x0, y0, x1, y1 in _boxes(rng, 40, size):
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        base = rng.integers(0, 256, (size, size + 3, 3)).astype(np.uint8)
        want = base.copy()
        cv2.rectangle(want, (int(x0), int(y0)), (int(x1), int(y1)), color,
                      thickness)
        got = base.copy()
        TV.draw_rectangle(got, (x0, y0), (x1, y1), color, thickness)
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"{(x0, y0, x1, y1)}")


def test_render_frame_draws_the_reference_boxes():
    """The reference's render_frame without its text label: GT thin gray,
    hit / miss / no-GT boxes 2 pixels thick, in its BGR colours."""
    recs = [{"box": [10.2, 12.7, 40.0, 33.5], "gt_box": [8.0, 9.0, 41.6, 30.0],
             "hit": True},
            {"box": [50.0, 5.0, 60.4, 70.0], "gt_box": [0.0, 0.0, 9.5, 9.5],
             "hit": False},
            {"box": [-4.0, 60.0, 20.0, 90.0]}]
    canvas = np.full((80, 80, 3), 40, np.uint8)
    want = canvas.copy()
    for r in recs:
        if "gt_box" in r:
            x0, y0, x1, y1 = (int(round(v)) for v in r["gt_box"])
            cv2.rectangle(want, (x0, y0), (x1, y1), (180, 180, 180), 1)
        color = JV._COLORS["nogt" if "hit" not in r
                           else ("hit" if r["hit"] else "miss")]
        x0, y0, x1, y1 = (int(round(v)) for v in r["box"])
        cv2.rectangle(want, (x0, y0), (x1, y1), color, 2)
    got = TV.render_frame(canvas, recs)
    np.testing.assert_array_equal(got, want)
    assert (canvas == 40).all()                     # drawn on a copy


def test_write_png_reads_back(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (7, 11, 3)).astype(
        np.uint8)
    path = str(tmp_path / "x.png")
    TV.write_png(path, img)
    np.testing.assert_array_equal(cv2.imread(path), img)


def test_cli_with_checkpoint_dir_and_no_render(synth_root, tmp_path,
                                               capsys):
    """--no-render with the params of a checkpoint directory of the port
    (TrainState saved by its CheckpointManager): records only, equal to
    the reference's on the same params."""
    from nafae_torch.train import TrainState
    from nafae_torch.utils.checkpoint import CheckpointManager

    jc, tc = _cfgs(synth_root)
    state = TrainState.create(tc, device="cpu", seed=0)
    ck = str(tmp_path / "ck")
    CheckpointManager(ck).save(state)
    out = str(tmp_path / "viz")
    rc = TV.main(["--preset", "config1", "--override", *SMALL,
                  f"data.root={synth_root}", "--checkpoint", ck,
                  "--out", out, "--num-segments", "2", "--no-render",
                  "--device", "cpu"])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["records"] == len(_lines(printed["predictions"])) > 0
    assert not [d for d in os.listdir(out)
                if os.path.isdir(os.path.join(out, d))]
    params = {k: v.numpy() for k, v in state.params.items()}
    want = JV.visualize_config(jc, str(tmp_path / "jax"),
                               {k: jnp.asarray(v) for k, v in params.items()},
                               num_segments=2, render=False)
    assert _lines(printed["predictions"]) == _lines(want)


def test_without_ground_truth(synth_root, tmp_path):
    root = tmp_path / "nogt"
    (root / "val").mkdir(parents=True)
    src = os.path.join(synth_root, "val")
    shutil.copy(os.path.join(src, "index.jsonl"), root / "val")
    for f in os.listdir(src):
        if f.endswith(".npz"):
            with np.load(os.path.join(src, f)) as z:
                np.savez(root / "val" / f, **{k: z[k] for k in z.files
                                              if not k.startswith("gt_")})
    jc, tc = _cfgs(str(root))
    got = TV.visualize_config(tc, str(tmp_path / "t"), _oracle(),
                              num_segments=3, device="cpu")
    want = JV.visualize_config(jc, str(tmp_path / "j"),
                               {k: jnp.asarray(v) for k, v in
                                _oracle().items()},
                               num_segments=3, render=False)
    recs = _lines(got)
    assert recs and recs == _lines(want)
    assert not any("hit" in r or "gt_box" in r for r in recs)


def test_package_cli_dispatches(synth_root, tmp_path):
    """python -m nafae_torch: usage and exit code 2 without a command; a
    command's exit code otherwise."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bare = subprocess.run([sys.executable, "-m", "nafae_torch"], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert bare.returncode == 2
    assert "usage: python -m nafae_torch" in bare.stderr
    assert "visualize" in bare.stderr and "serve" in bare.stderr
    npz = str(tmp_path / "p.npz")
    np.savez(npz, **_oracle())
    out = str(tmp_path / "viz")
    run = subprocess.run(
        [sys.executable, "-m", "nafae_torch", "visualize", "--override",
         *SMALL, f"data.root={synth_root}", "--checkpoint", npz, "--out",
         out, "--num-segments", "1", "--no-render", "--device", "cpu"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert json.loads(run.stdout.strip().splitlines()[-1])["records"] > 0
