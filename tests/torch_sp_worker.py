"""One rank of a data × frame world on the CPU (gloo), for
tests/test_torch_sp.py: the cases of tests/torch_dp_worker.py (train
steps, fit, each on the mesh its case names) and the frame-parallel
primitives of `nafae_torch.parallel.sp` alone. Imports torch and
nafae_torch only: spawned children must not import JAX.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.distributed as dist

from nafae_torch.parallel import sharding as S
from nafae_torch.parallel import sp
from tests import torch_dp_worker as W


def _frame_slice(x: np.ndarray, mesh, dim: int) -> torch.Tensor:
    """This rank's frames of x along `dim` (its frame coordinate)."""
    f, n = mesh.get_coordinate()[1], int(mesh.mesh.shape[1])
    return torch.from_numpy(np.ascontiguousarray(
        S.shard_rows(x, f, n, dim)))


def _halo_case(case, mesh, rank, world):
    """halo_exchange of this rank's frames of case["x"] [B,T,C]; its
    output, and the gradient of sum(out · case["weights"][f]) with
    respect to the rank's frames; the exchange's sends and receives."""
    group = mesh.get_group("frame")
    x = _frame_slice(case["x"], mesh, 1).requires_grad_()
    S.COLLECTIVES.reset()
    out = sp.halo_exchange(x, case["window"], group)
    weights = torch.from_numpy(case["weights"][mesh.get_coordinate()[1]])
    (grad,) = torch.autograd.grad(torch.sum(out * weights), x)
    return {"out": out.detach().numpy(), "grad": grad.numpy(),
            "collectives": list(S.COLLECTIVES.records)}


def _scores_case(case, mesh, rank, world):
    """sp_video_scores of this rank's frames of case["a"] [B,K,T]: S, and
    the gradient of sum(S · case["weights"]) with respect to its frames."""
    group = mesh.get_group("frame")
    a = _frame_slice(case["a"], mesh, 2).requires_grad_()
    fm = _frame_slice(case["frame_mask"], mesh, 1)
    s, _ = sp.sp_video_scores(a, torch.from_numpy(case["word_mask"]), fm,
                              case["temp"], case["pool"], group)
    (grad,) = torch.autograd.grad(
        torch.sum(s * torch.from_numpy(case["weights"])), a)
    return {"s": s.detach().numpy(), "grad": grad.numpy()}


def _axes_case(case, mesh, rank, world):
    """axes_group of meshes made with and without make_mesh: the world's
    group for case["mesh"] (every rank), the size of the data axis's group
    for an init_device_mesh mesh of frame axis 1, the size of and a sum
    over make_mesh's group for a 1x2 mesh on ranks 0-1, and the error for
    a DeviceMesh on ranks 2-3 that make_mesh did not make."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from nafae_torch.parallel.mesh import axes_group, make_mesh

    out = {"world": axes_group(mesh) is dist.group.WORLD}
    flat = init_device_mesh("cpu", (world, 1),
                            mesh_dim_names=("data", "frame"))
    out["frame1"] = dist.get_world_size(axes_group(flat))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # a mesh smaller than the world
        sub = make_mesh(1, 2, device="cpu")
    out["sub"] = None
    if rank < 2:
        x = torch.tensor([rank + 1.0])
        dist.all_reduce(x, group=axes_group(sub))
        out["sub"] = (dist.get_world_size(axes_group(sub)), float(x))
    bare = DeviceMesh("cpu", torch.arange(2, 4).reshape(1, 2))
    try:
        axes_group(bare)
        out["bare"] = None
    except ValueError as e:
        out["bare"] = str(e)
    return out


KINDS = {**W.CASES, "halo": _halo_case, "scores": _scores_case,
         "axes": _axes_case}


def run(rank: int, world: int, tmp: str) -> None:
    W.run(rank, world, tmp, KINDS)


def spawn(world: int, tmp: str, cases: dict) -> list[dict]:
    """Runs `cases` on a gloo world of `world` CPU processes; returns each
    rank's results."""
    return W.spawn(world, tmp, cases, run)
