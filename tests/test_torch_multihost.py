"""The port's runs across hosts (nafae_torch.parallel.multihost): the
per-process slice, the refusal to start without a launch, the batch spec
against the JAX package's shardings, and a real two-"host" run of the
train CLI (two torchrun agents, one process each, on 127.0.0.1), after
tests/test_multihost.py."""

import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import nafae_tpu.config as jcfg
import nafae_torch.config as tcfg
from nafae_tpu.parallel import make_mesh as j_make_mesh
from nafae_tpu.parallel import multihost as JMH
from nafae_torch.parallel import multihost as MH
from tests.test_torch_dp import OV, _fit

LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS",
               "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE")


@pytest.mark.parametrize("n", [8, 10, 3])
def test_process_shard_disjoint_cover(n):
    for cnt in (1, 2, 4):
        got = []
        for pid in range(cnt):
            r = MH.process_shard(n, pid, cnt)
            assert r == JMH.process_shard(n, pid, cnt)
            got.extend(r)
        assert got == list(range(n))    # disjoint, covering, ordered


@pytest.mark.parametrize("env", [{}, {"SLURM_PROCID": "0",
                                      "SLURM_NTASKS": "2"}])
def test_init_multihost_without_a_launch_stays_single(monkeypatch, env):
    """No coordinator and no launcher, or a launcher's ranks without
    MASTER_ADDR: warn, return False, start nothing."""
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.warns(UserWarning, match="SINGLE"):
        assert MH.init_multihost(device="cpu") is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="together"):
        MH.init_multihost(coordinator="127.0.0.1:1", device="cpu")


def _fake_mesh(shape, coord):
    """What global_batch_spec and local_batch read of a DeviceMesh."""
    return SimpleNamespace(mesh=torch.arange(shape[0] * shape[1]).reshape(
        shape), get_coordinate=lambda: list(coord))


@pytest.mark.parametrize("with_frames", [False, True])
def test_global_batch_spec_matches_jax_shardings(with_frames):
    """On a 4x2 mesh each rank's local_batch is exactly the shard that the
    JAX package's global_batch_spec places on the device at the same mesh
    coordinate, key by key (rows over data, frames over frame)."""
    cfg = tcfg.load_config(preset_name="config4", overrides=[
        "mesh.data_axis=4", "mesh.frame_axis=2"])
    jc = jcfg.load_config(preset_name="config4", overrides=[
        "mesh.data_axis=4", "mesh.frame_axis=2"])
    jmesh = j_make_mesh(4, 2, devices=jax.devices()[:8])
    jspec = JMH.global_batch_spec(jc, jmesh, with_frames=with_frames)
    spec = MH.global_batch_spec(cfg, _fake_mesh((4, 2), (0, 0)),
                                with_frames=with_frames)
    assert set(spec) == set(jspec)
    rng = np.random.RandomState(0)
    shapes = {"word_ids": (8, 3), "frame_mask": (8, 4), "word_mask": (8, 3),
              "segment_id": (8,), "frames": (8, 4, 2, 2, 3),
              "feats": (8, 4, 5, 6), "boxes": (8, 4, 5, 4),
              "region_mask": (8, 4, 5)}
    batch = {k: rng.randn(*shapes[k]).astype(np.float32) for k in spec}
    coords = {d: (i, j) for i, row in enumerate(jmesh.devices)
              for j, d in enumerate(row)}
    for k, v in batch.items():
        arr = jax.device_put(v, NamedSharding(jmesh, jspec[k]))
        for shard in arr.addressable_shards:
            mine = MH.local_batch({k: v}, spec,
                                  _fake_mesh((4, 2), coords[shard.device]))
            np.testing.assert_array_equal(mine[k], np.asarray(shard.data),
                                          err_msg=k)
    with pytest.raises(KeyError, match="no entry"):
        MH.local_batch({"gt_boxes": batch["word_ids"]}, spec,
                       _fake_mesh((4, 2), (0, 0)))
    # without a frame axis nothing is cut along the frames
    flat = MH.global_batch_spec(cfg, _fake_mesh((8, 1), (0, 0)))
    assert all(f is None for _, f in flat.values())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_host_torchrun_trains_as_one_process(synth_root, tmp_path):
    """Two torchrun agents (--nnodes 2, one process each, on 127.0.0.1)
    running `-m nafae_torch.train --multihost --device cpu`: rank 0 alone
    prints and checkpoints, and its loss and grad_norm are the
    single-process run's (rtol 1e-5 and 1e-6, from the metrics.jsonl it
    writes); rank 1 exits 0 silent."""
    from nafae_torch.utils.metrics_log import MetricsLogger
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for k in LAUNCH_VARS:
        env.pop(k, None)
    ov = OV + [f"data.root={synth_root}", f"train.ckpt_dir={tmp_path}/m",
               "train.steps=2", "train.log_every=1"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2",
         "--node_rank", str(node), "--nproc_per_node", "1",
         "--master_addr", "127.0.0.1", "--master_port", str(port),
         "-m", "nafae_torch.train", "--multihost", "--device", "cpu",
         "--preset", "config4", "--override", *ov],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for node in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
        outs.append([ln for ln in out.splitlines() if "step=" in ln])
    assert len(outs[0]) == 2 and outs[1] == []
    assert sorted(os.listdir(tmp_path / "m")) == ["metrics.jsonl",
                                                  "state_2.pt"]
    got = MetricsLogger(str(tmp_path / "m")).read()
    _, single = _fit(synth_root, tmp_path / "s", 2)
    assert [r["step"] for r in got] == [1, 2]
    for g, s in zip(got, single):
        np.testing.assert_allclose(g["loss"], s["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], s["grad_norm"],
                                   rtol=1e-6)
