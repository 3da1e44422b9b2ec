"""The device mesh of the port, on torch.distributed.

Each process of the job is one rank and drives one device: `cuda:LOCAL_RANK`
over NCCL, or the CPU over gloo when the caller asks for the CPU. There is
no fallback from one backend to the other. The mesh's axes are the
reference's (`nafae_tpu/parallel/mesh.py`):
  data  — videos: each rank holds a row shard of the global batch;
  frame — the frame axis (frame parallelism, not ported yet: ROADMAP
          Queue 1 item 8), so its size must be 1.

Launch a data-parallel run with torchrun, which sets RANK, WORLD_SIZE,
LOCAL_RANK and MASTER_ADDR/MASTER_PORT:

    torchrun --nproc_per_node N -m nafae_torch.train --mesh ...

Without that environment the process group is a world of one, started
through a file store in a temporary directory.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import warnings

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from nafae_torch.device import resolve_device

_FRAME_TODO = ("frame parallelism (mesh.frame_axis > 1) is not ported yet "
               "(ROADMAP Queue 1 item 8)")


def init_process_group(device: str | torch.device | None = None
                       ) -> torch.device:
    """Starts the default process group, unless one is running, and
    returns this rank's device: cuda:LOCAL_RANK with NCCL (raises without
    a card or without NCCL), or the CPU with gloo when device is "cpu".
    The group's rank, world size and address come from torchrun's
    environment; without it, a world of one."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL; pass device='cpu' "
                               "for a gloo group on the CPU")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"the process group runs {dist.get_backend()}, but a "
                f"{dev.type} mesh needs {backend}")
        return dev
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        global _STORE_DIR
        _STORE_DIR = tempfile.mkdtemp(prefix="nafae_pg_")
        dist.init_process_group(
            backend, init_method=f"file://{_STORE_DIR}/store", rank=0,
            world_size=1)
    return dev


_STORE_DIR = None     # the file store of a world of one started here


def shutdown() -> None:
    """Ends the default process group and removes the file store that
    init_process_group made for a world of one."""
    global _STORE_DIR
    if dist.is_initialized():
        dist.destroy_process_group()
    if _STORE_DIR is not None:
        shutil.rmtree(_STORE_DIR, ignore_errors=True)
        _STORE_DIR = None


def make_mesh(data_axis: int = -1, frame_axis: int = 1,
              data_axis_name: str = "data", frame_axis_name: str = "frame",
              device: str | torch.device | None = None) -> DeviceMesh:
    """A [data, frame] DeviceMesh over the default process group (started
    here when none runs, `init_process_group`). data_axis -1 takes every
    rank; a mesh smaller than the world warns, and the ranks outside it
    take no part."""
    if frame_axis > 1:
        raise NotImplementedError(_FRAME_TODO)
    dev = init_process_group(device)
    n = dist.get_world_size()
    if data_axis == -1:
        if n % frame_axis:
            raise ValueError(
                f"{n} ranks not divisible by frame_axis={frame_axis}")
        data_axis = n // frame_axis
    if data_axis * frame_axis > n:
        raise ValueError(
            f"mesh {data_axis}x{frame_axis} needs {data_axis * frame_axis} "
            f"ranks, have {n}")
    names = (data_axis_name, frame_axis_name)
    if data_axis * frame_axis < n:
        warnings.warn(
            f"mesh {data_axis}x{frame_axis} uses {data_axis * frame_axis} of "
            f"{n} ranks; the rest idle", stacklevel=2)
        return DeviceMesh(dev.type, torch.arange(data_axis * frame_axis)
                          .reshape(data_axis, frame_axis),
                          mesh_dim_names=names)
    return init_device_mesh(dev.type, (data_axis, frame_axis),
                            mesh_dim_names=names)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on `mesh`: the current CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
