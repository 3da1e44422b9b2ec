"""Multi-host runs: one process group across hosts (the port of
`nafae_tpu/parallel/multihost.py`).

In the port every rank is one process on one device, so a run across
hosts is the same program as a run on one host; what differs is how the
process group finds its members:

- ``init_multihost``: starts the default process group from an explicit
  coordinator address, process count and process id, or from a launcher's
  environment (torchrun, a SLURM or Open MPI job that exports
  MASTER_ADDR/MASTER_PORT); with nothing configured it warns and stays a
  single process, so a multi-host launch never quietly trains on one.
- ``process_shard``: the per-process slice of a range, disjoint and
  covering, the remainder to the first processes.
- ``global_batch_spec``: which dim of each batch key the mesh's data and
  frame axes shard, the one spec `train.fit` slices by.
- ``local_batch``: this rank's part of the global batch; with
  `train.batch_to_device`, which puts it on the rank's device, the
  counterpart of the reference's ``host_local_to_global``: every process
  loads the identically seeded global batch and keeps its rows and
  frames.

The reference's ``batch_sharding`` (a NamedSharding per key) has no
counterpart: torch.distributed has no global array to place, and each
rank holds its own tensors.

    # on each of two hosts, one card each:
    torchrun --nnodes 2 --node_rank <0|1> --nproc_per_node 1 \\
        --master_addr <host0> --master_port 29500 \\
        -m nafae_torch.train --multihost --preset config4 --override ...
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

# Launchers whose ranks this module reads when no coordinator is given:
# (rank, world size, rank on the host). Each needs MASTER_ADDR and
# MASTER_PORT beside them; torchrun sets all of them itself.
_LAUNCHERS = (("RANK", "WORLD_SIZE", "LOCAL_RANK"),                 # torchrun
              ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"),    # SLURM
              ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",      # Open MPI
               "OMPI_COMM_WORLD_LOCAL_RANK"))


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   device: str | torch.device | None = None) -> bool:
    """Starts the default process group of a run across processes and
    hosts; returns True when one runs (started here or before), False for
    a single process. Safe to call twice.

    The group comes from, in order: the arguments (coordinator
    "host:port", num_processes, process_id, all three); the markers of a
    launcher (`_LAUNCHERS`: torchrun's RANK/WORLD_SIZE, SLURM's
    SLURM_PROCID/SLURM_NTASKS, Open MPI's
    OMPI_COMM_WORLD_RANK/OMPI_COMM_WORLD_SIZE), with MASTER_ADDR and
    MASTER_PORT for the address (and the launcher's local rank for the
    card, as LOCAL_RANK). A launcher's markers without the address
    warn and return False, as does a process with no launch configured:
    the run then goes on as one process with the global batch. device: as
    `parallel.mesh.init_process_group` (NCCL on cuda, gloo with device
    "cpu")."""
    from nafae_torch.parallel.mesh import init_process_group

    if dist.is_initialized():
        return True
    if coordinator is not None or num_processes is not None \
            or process_id is not None:
        if coordinator is None or num_processes is None or process_id is None:
            raise ValueError("init_multihost takes coordinator, "
                             "num_processes and process_id together")
        init_process_group(device, init_method=f"tcp://{coordinator}",
                           world_size=num_processes, rank=process_id)
        return True
    for rank_var, size_var, local_var in _LAUNCHERS:
        if rank_var not in os.environ or size_var not in os.environ:
            continue
        addr, port = (os.environ.get(k) for k in ("MASTER_ADDR",
                                                  "MASTER_PORT"))
        if not addr or not port:
            warnings.warn(
                f"--multihost: {rank_var}/{size_var} are set but MASTER_ADDR"
                "/MASTER_PORT are not; continuing as a SINGLE process. "
                "Export them, or pass coordinator, num_processes and "
                "process_id.", stacklevel=2)
            return False
        if rank_var == "RANK":      # torchrun's agent holds the store
            init_process_group(device)
        else:
            # the card of this rank: init_process_group reads LOCAL_RANK
            os.environ.setdefault("LOCAL_RANK",
                                  os.environ.get(local_var, "0"))
            init_process_group(device, init_method=f"tcp://{addr}:{port}",
                               world_size=int(os.environ[size_var]),
                               rank=int(os.environ[rank_var]))
        return True
    warnings.warn(
        "--multihost requested but no coordinator is configured (no "
        "MASTER_ADDR / RANK / WORLD_SIZE, no SLURM or Open MPI job); "
        "continuing as a SINGLE process with the global batch size.",
        stacklevel=2)
    return False


def process_shard(n: int, process_id: int, process_count: int) -> range:
    """The contiguous slice of [0, n) owned by process `process_id` of
    `process_count`: disjoint and covering, the remainder to the first
    n % process_count processes."""
    base, rem = divmod(n, process_count)
    lo = process_id * base + min(process_id, rem)
    return range(lo, lo + base + (1 if process_id < rem else 0))


def global_batch_spec(cfg, mesh, with_frames: bool = False
                      ) -> dict[str, tuple[int, int | None]]:
    """key -> (the dim the data axis shards, the dim the frame axis shards
    or None) of one batch, as the reference's PartitionSpecs: every key's
    rows over the data axis, and the frame-indexed keys' frames over the
    frame axis when it has more than one rank."""
    from nafae_torch.parallel.mesh import frame_size

    fdim = 1 if frame_size(mesh) > 1 else None
    spec = {"word_ids": (0, None), "frame_mask": (0, fdim),
            "word_mask": (0, None), "segment_id": (0, None)}
    keys = ("frames",) if with_frames else ("feats", "boxes", "region_mask")
    spec.update({k: (0, fdim) for k in keys})
    return spec


def local_batch(batch: dict, spec: dict, mesh) -> dict[str, np.ndarray]:
    """This rank's part of a global numpy batch: along each key's data dim
    the rows of its data rank (`process_shard`), along its frame dim the
    frames of its frame rank. Without a mesh the whole batch. Raises on a
    key the spec does not name, and when a sharded dim does not divide
    over its axis."""
    if mesh is None:
        return batch
    coord = mesh.get_coordinate()
    sizes = tuple(int(s) for s in mesh.mesh.shape)
    out = {}
    for k, v in batch.items():
        if k not in spec:
            raise KeyError(f"batch key {k!r} has no entry in the batch spec")
        v = np.asarray(v)
        for dim, pos, size in zip(spec[k], coord, sizes):
            if dim is None or size == 1:
                continue
            if v.shape[dim] % size:
                raise ValueError(
                    f"batch key {k!r}: dim {dim} of {v.shape} does not "
                    f"divide over the mesh's {size} ranks")
            r = process_shard(v.shape[dim], pos, size)
            v = v[(slice(None),) * dim + (slice(r.start, r.stop),)]
        out[k] = v
    return out
