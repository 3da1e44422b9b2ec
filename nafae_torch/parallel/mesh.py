"""The device mesh of the port, on torch.distributed.

Each process of the job is one rank and drives one device: `cuda:LOCAL_RANK`
over NCCL, or the CPU over gloo when the caller asks for the CPU. There is
no fallback from one backend to the other. The mesh's axes are the
reference's (`nafae_tpu/parallel/mesh.py`), in its row-major order (rank
d·F + f sits at [d, f]):
  data  — videos: each rank holds a row shard of the global batch;
  frame — the frame axis (frame parallelism, `parallel/sp.py`): each rank
          holds T/F consecutive frames of its rows; the context window
          reaches its neighbours' frames through a halo exchange and the
          frame softmax is an online softmax over the axis.

Launch a run with torchrun, which sets RANK, WORLD_SIZE, LOCAL_RANK and
MASTER_ADDR/MASTER_PORT:

    torchrun --nproc_per_node N -m nafae_torch.train --mesh ...

Without that environment the process group is a world of one, started
through a file store in a temporary directory. Across hosts, see
`parallel/multihost.py`.
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


def _backend(dev: torch.device, backend: str | None) -> str:
    """The backend of a group on `dev`: NCCL on cuda and gloo on the CPU
    unless `backend` names one. gloo on cuda is taken only when asked for
    (several ranks on one card: NCCL refuses a duplicate GPU in a
    communicator); the collectives then stage their tensors through host
    memory (`sharding.staged`)."""
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; choose nccl | gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL runs on cuda; pass device='cpu' without "
                             "a backend for a gloo group on the CPU")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL; pass device='cpu' "
                               "for a gloo group on the CPU")
    return backend


def init_process_group(device: str | torch.device | None = None,
                       backend: str | None = None,
                       init_method: str | None = None,
                       world_size: int | None = None,
                       rank: int | None = None) -> torch.device:
    """Starts the default process group, unless one is running, and
    returns this rank's device: cuda:LOCAL_RANK with NCCL (raises without
    a card or without NCCL), or the CPU with gloo when device is "cpu".
    backend "gloo" on cuda is a test affordance (see `_backend`).

    The group's address, size and rank come from init_method, world_size
    and rank when given (`multihost.init_multihost`), else from torchrun's
    environment; without either, a world of one."""
    dev = resolve_device(device)
    backend = _backend(dev, backend)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"the process group runs {dist.get_backend()}, but this "
                f"{dev.type} mesh asks for {backend}")
        return dev
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
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
    _AXES_GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
    if _STORE_DIR is not None:
        shutil.rmtree(_STORE_DIR, ignore_errors=True)
        _STORE_DIR = None


def make_mesh(data_axis: int = -1, frame_axis: int = 1,
              data_axis_name: str = "data", frame_axis_name: str = "frame",
              device: str | torch.device | None = None,
              backend: str | None = None) -> DeviceMesh:
    """A [data, frame] DeviceMesh over the default process group (started
    here when none runs, `init_process_group`), rank d·F + f at [d, f].
    data_axis -1 takes every rank; a mesh smaller than the world warns,
    and the ranks outside it take no part. backend: see
    `init_process_group`. Every rank of the world must call it, in the
    same order: it makes the axes' groups, and the group over both axes
    of a mesh smaller than the world (`axes_group`)."""
    if frame_axis < 1:
        raise ValueError(f"frame_axis={frame_axis} must be >= 1")
    dev = init_process_group(device, backend)
    n = dist.get_world_size()
    if data_axis == -1:
        if n % frame_axis:
            raise ValueError(
                f"{n} ranks not divisible by frame_axis={frame_axis}")
        data_axis = n // frame_axis
    size = data_axis * frame_axis
    if size > n:
        raise ValueError(
            f"mesh {data_axis}x{frame_axis} needs {size} ranks, have {n}")
    names = (data_axis_name, frame_axis_name)
    if size < n:
        warnings.warn(
            f"mesh {data_axis}x{frame_axis} uses {size} of {n} ranks; the "
            "rest idle", stacklevel=2)
        mesh = DeviceMesh(dev.type, torch.arange(size)
                          .reshape(data_axis, frame_axis),
                          mesh_dim_names=names)
    else:
        mesh = init_device_mesh(dev.type, (data_axis, frame_axis),
                                mesh_dim_names=names)
    if size < n and frame_axis > 1:   # a collective call: every rank
        _AXES_GROUPS[_ranks(mesh)] = dist.new_group(list(range(size)))
    return mesh


# The groups over both axes of make_mesh's meshes smaller than the world
# whose frame axis is longer than 1, by the meshes' ranks
_AXES_GROUPS: dict[tuple[int, ...], object] = {}


def _ranks(mesh: DeviceMesh) -> tuple[int, ...]:
    return tuple(mesh.mesh.flatten().tolist())


def axes_group(mesh: DeviceMesh):
    """The group over both axes of a [data, frame] mesh (the reference's
    all_axes): the data axis's group when the frame axis has size 1, the
    world when the mesh holds every rank, else the group make_mesh made
    for the mesh."""
    if mesh.mesh.shape[1] == 1:
        return mesh.get_group(0)
    ranks = _ranks(mesh)
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    if ranks not in _AXES_GROUPS:
        raise ValueError(
            f"no group over both axes of the mesh of ranks {list(ranks)}: "
            "build a mesh smaller than the world with make_mesh, which "
            "makes that group on every rank")
    return _AXES_GROUPS[ranks]


def frame_size(mesh: DeviceMesh | None) -> int:
    """The size of the mesh's frame axis (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.mesh.shape[1])


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on `mesh`: the current CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
