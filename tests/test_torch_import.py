"""The port stands alone: nafae_torch, chip_smoke.py and kernel_ab.py import
neither JAX nor the JAX package, and entry points need a CUDA device unless
the caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nafae_tpu",
             "tensorstore", "zstandard", "numcodecs", "zarr")
SOURCES = sorted(str(p.relative_to(ROOT)) for p in
                 [*(ROOT / "nafae_torch").rglob("*.py"),
                  ROOT / "chip_smoke.py", ROOT / "kernel_ab.py"])


def test_import_leaves_jax_out():
    code = ("import sys, nafae_torch, nafae_torch.serve, "
            "nafae_torch.train, nafae_torch.ops.kernels.ctx_mix, "
            "nafae_torch.ops.kernels.cross_mil, nafae_torch.ops.kernels.diag, "
            "nafae_torch.ops.losses, nafae_torch.ops.kmeans, "
            "nafae_torch.data.loader, nafae_torch.utils.checkpoint, "
            "nafae_torch.utils.metrics_log, nafae_torch.extract, "
            "nafae_torch.data.avi, nafae_torch.data.video_dataset, "
            "nafae_torch.models.detector.faster_rcnn, "
            "nafae_torch.ops.kernels.nms, nafae_torch.ops.kernels.roi_align, "
            "nafae_torch.ops.nms, nafae_torch.ops.roi_align, "
            "nafae_torch.utils.torch_convert, nafae_torch.data.annotations, "
            "nafae_torch.data.robowatch, nafae_torch.models.detector.vgg, "
            "nafae_torch.visualize, nafae_torch.__main__, "
            "nafae_torch.parallel.mesh, nafae_torch.parallel.sharding, "
            "nafae_torch.parallel.sp, nafae_torch.parallel.multihost, "
            "nafae_torch.utils.profiling, nafae_torch.evaluate, "
            "nafae_torch.utils.native_io, nafae_torch.data.grain_loader, "
            "nafae_torch.ops.kernels._build, nafae_torch.utils.cuda_graph, "
            "nafae_torch.utils.zstd, nafae_torch.utils.ocdbt, "
            "nafae_torch.utils.zarr2, nafae_torch.utils.orbax_read; "
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("module", ["nafae_torch.visualize",
                                    "nafae_torch.__main__",
                                    "nafae_torch.parallel.sharding",
                                    "nafae_torch.parallel.sp",
                                    "nafae_torch.parallel.multihost",
                                    "nafae_torch.utils.profiling",
                                    "nafae_torch.utils.native_io",
                                    "nafae_torch.data.grain_loader",
                                    "nafae_torch.ops.kernels._build",
                                    "nafae_torch.utils.cuda_graph",
                                    "nafae_torch.utils.orbax_read"])
def test_new_entry_points_leave_jax_out(module):
    """Each of the entry modules alone, in a fresh interpreter."""
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("rel", SOURCES)
def test_sources_import_no_jax(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
        assert not bad, f"{rel}:{node.lineno} imports {bad}"


def test_entry_points_need_cuda_unless_cpu_requested(monkeypatch):
    from nafae_torch.config import load_config
    from nafae_torch.device import resolve_device
    from nafae_torch.serve import GroundingServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(preset_name="config4", overrides=[
        "data.feat_dim=16", "model.feat_dim=16", "model.embed_dim=8"])
    params = {"word_emb": np.zeros((67, 8), np.float32),
              "w_v": np.zeros((16, 8), np.float32),
              "b_v": np.zeros(8, np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GroundingServer(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert GroundingServer(cfg, params, device="cpu").device.type == "cpu"
    from nafae_torch.train import TrainState, fit
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainState.create(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(cfg)
    assert TrainState.create(cfg, device="cpu").device.type == "cpu"
    from nafae_torch.extract import make_extract_fn
    from nafae_torch.models.detector.faster_rcnn import init_detector
    det = load_config(preset_name="config5", overrides=[
        "detector.image_size=32", "detector.anchor_scales=[16]"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_detector(det.detector, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_extract_fn(det)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_mesh_needs_cuda_unless_cpu_requested(monkeypatch):
    """make_mesh takes NCCL on the card and gloo only when the CPU is
    asked for: without a card it raises, and no process group starts."""
    from nafae_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert not torch.distributed.is_initialized()
