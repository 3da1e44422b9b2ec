"""One rank of a data-parallel world on the CPU (gloo), for
tests/test_torch_dp.py (and, through tests/torch_sp_worker.py, of a
data × frame world for tests/test_torch_sp.py). Imports torch and
nafae_torch only: spawned children must not import JAX, so the reference
is computed in the parent.

The parent pickles a list of cases into <tmp>/cases.pkl and spawns
`run(rank, world, tmp)` on `world` processes; each rank runs every case
in order (the collectives must match across ranks) and pickles its
results into <tmp>/out_<rank>.pkl. A case runs on the mesh its "mesh"
entry names, (data, frame), by default (world, 1).
"""

from __future__ import annotations

import datetime
import os
import pickle
import warnings

import torch
import torch.distributed as dist

from nafae_torch import train as TT
from nafae_torch.config import load_config
from nafae_torch.parallel import sharding as S
from nafae_torch.parallel.mesh import make_mesh


class RecordingOptimizer(TT.Optimizer):
    """The optimizer, keeping the gradients each update was given."""

    def update(self, grads, state, params):
        self.grads = {k: g.clone() for k, g in grads.items()}
        return super().update(grads, state, params)


def _cfg(case):
    return load_config(preset_name=case["preset"],
                       overrides=case["overrides"])


def _step_case(case, mesh, rank, world):
    """An optimizer step on this rank's part of each of the case's global
    batches; the state, per-step metrics, last gradients and each step's
    collectives."""
    from nafae_torch.parallel.multihost import global_batch_spec, local_batch

    cfg = _cfg(case)
    state = TT.TrainState.from_state_dict(case["state"], "cpu")
    if state.bank is not None:
        state.bank = TT._bank_shard(state.bank, mesh)
        state.bank_valid = TT._bank_shard(state.bank_valid, mesh)
    extractor = None
    if case.get("detector") is not None:
        from nafae_torch.models.detector.faster_rcnn import \
            FasterRCNNExtractor
        extractor = FasterRCNNExtractor(cfg.detector).eval()
        extractor.load_state_dict(case["detector"])
    if case.get("gumbels") is not None:        # JAX's k-means++ draws
        real = TT.kmeans_plusplus_init
        g = torch.from_numpy(case["gumbels"])
        TT.kmeans_plusplus_init = (
            lambda f, v, k, generator=None, **kw: real(f, v, k, gumbels=g,
                                                       **kw))
    tx = RecordingOptimizer(cfg)
    spec = global_batch_spec(cfg, mesh, with_frames=extractor is not None)
    metrics, collectives = [], []
    try:
        for batch in case["batches"]:
            S.COLLECTIVES.reset()
            state, m = TT.train_step(
                state, TT.batch_to_device(local_batch(batch, spec, mesh),
                                          torch.device("cpu")),
                cfg, tx, extractor, mesh)
            collectives.append(list(S.COLLECTIVES.records))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        if case.get("gumbels") is not None:
            TT.kmeans_plusplus_init = real
    return {"params": {k: v.numpy() for k, v in state.params.items()},
            "centers": state.centers.numpy(), "metrics": metrics,
            "grads": {k: v.numpy() for k, v in tx.grads.items()},
            "bank": None if state.bank is None else state.bank.numpy(),
            "bank_valid": (None if state.bank_valid is None
                           else state.bank_valid.numpy()),
            "collectives": collectives}


def _fit_case(case, mesh, rank, world):
    """fit under the mesh: the logged metrics and the final params."""
    logs = []
    state, _ = TT.fit(_cfg(case), mesh=mesh, log_fn=logs.append)
    return {"logs": logs, "step": state.step,
            "params": {k: v.numpy() for k, v in state.params.items()},
            "centers": state.centers.numpy()}


def _eval_case(case, mesh, rank, world):
    from nafae_torch.evaluate import evaluate_config
    params = {k: torch.from_numpy(v) for k, v in case["params"].items()}
    return evaluate_config(_cfg(case), params=params, mesh=mesh)


def _errors_case(case, mesh, rank, world):
    """The refusals and the warning of a world of more than one rank."""
    out = {}
    try:
        TT.fit(_cfg(case), mesh=mesh)
    except ValueError as e:
        out["fit"] = str(e)
    try:
        make_mesh(data_axis=world + 1, device="cpu")
    except ValueError as e:
        out["mesh"] = str(e)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sub = make_mesh(data_axis=1, device="cpu")
    out["warning"] = [str(w.message) for w in caught]
    out["sub_coordinate"] = sub.get_coordinate()
    return out


CASES = {"step": _step_case, "fit": _fit_case, "eval": _eval_case,
         "errors": _errors_case}


def run(rank: int, world: int, tmp: str, kinds: dict = CASES) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        meshes, out = {}, {}
        for name, case in cases.items():
            shape = tuple(case.get("mesh", (world, 1)))
            if shape not in meshes:      # every rank makes them in one order
                meshes[shape] = make_mesh(*shape, device="cpu")
            out[name] = kinds[case["kind"]](case, meshes[shape], rank, world)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(world: int, tmp: str, cases: dict, fn=run) -> list[dict]:
    """Runs `cases` on a gloo world of `world` CPU processes (each running
    `fn(rank, world, tmp)`); returns each rank's results."""
    import torch.multiprocessing as mp

    with open(os.path.join(tmp, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    mp.start_processes(fn, args=(world, tmp), nprocs=world,
                       start_method="spawn")
    outs = []
    for r in range(world):
        with open(os.path.join(tmp, f"out_{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs
