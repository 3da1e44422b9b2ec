"""The train CLI's observability in the port: the TensorBoard mirror of
`utils/metrics_log.py` (an event file written with the standard library,
read back by tensorboard's EventAccumulator and by the port's own CRC-
checking reader), `utils/profiling.py` (trace, ThroughputTracker against
the JAX package's), `--profile` and `--debug-nans`."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import nafae_torch.config as tcfg
from nafae_torch import train as TT
from nafae_torch.utils import metrics_log as ML
from nafae_torch.utils import profiling as TP

OV = ["data.feat_dim=64", "model.feat_dim=64", "model.embed_dim=32",
      "data.batch_size=8", "data.max_frames=8", "data.num_regions=6",
      "data.max_words=3", "loss.num_clusters=8", "loss.kmeans_interval=5",
      "train.warmup_steps=0", "train.log_every=1", "train.ckpt_every=1000000",
      "train.eval_every=1000000"]


def _cfg(synth_root, tmp_path, extra=()):
    return tcfg.load_config(preset_name="config4", overrides=OV + [
        f"data.root={synth_root}", f"train.ckpt_dir={tmp_path}/ck",
        *extra])


def test_crc32c_standard_vector():
    assert ML.crc32c(b"123456789") == 0xE3069283
    assert ML.crc32c(b"") == 0


def test_events_read_back_by_event_accumulator(tmp_path):
    """Each logged record's numeric fields but ts and step are one scalar
    event at its step; strings stay in the JSONL only."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    log = ML.MetricsLogger(str(tmp_path / "ck"),
                           tensorboard_dir=str(tmp_path / "tb"))
    records = [{"step": s, "loss": 1.0 / s, "l_rank": 0.25 * s,
                "frames_per_sec": 1234.5 + s, "note": "text"}
               for s in (1, 2, 5)]
    for r in records:
        log.log(r)
    ea = EventAccumulator(str(tmp_path / "tb"))
    ea.Reload()
    assert sorted(ea.Tags()["scalars"]) == ["frames_per_sec", "l_rank",
                                            "loss"]
    jsonl = log.read()
    for tag in ("loss", "l_rank", "frames_per_sec"):
        got = [(e.step, e.value) for e in ea.Scalars(tag)]
        assert got == [(r["step"], float(np.float32(r[tag]))) for r in jsonl]
    events = ML.read_events(log.tb_path)
    assert [e.get("step") for e in events] == [None, 1, 2, 5]


def test_read_events_checks_the_crcs(tmp_path):
    log = ML.MetricsLogger(str(tmp_path), tensorboard_dir=str(tmp_path))
    log.log({"step": 1, "loss": 0.5})
    blob = bytearray(open(log.tb_path, "rb").read())
    assert len(ML.read_events(log.tb_path)) == 2
    blob[-6] ^= 1                            # a bit of the last event's data
    open(log.tb_path, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="data CRC"):
        ML.read_events(log.tb_path)
    open(log.tb_path, "wb").write(bytes(blob[:-2]))
    with pytest.raises(ValueError, match="cut"):
        ML.read_events(log.tb_path)


def test_throughput_tracker_matches_the_reference(monkeypatch):
    import time

    from nafae_tpu.utils.profiling import ThroughputTracker as JTracker
    clock = iter(np.cumsum([0.5, 0.1, 0.3, 0.2, 0.7, 0.1, 0.4, 0.25]))
    ticks = [float(t) for t in clock]
    got = {}
    for name, cls in (("port", TP.ThroughputTracker), ("jax", JTracker)):
        it = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(it))
        tr = cls(frames_per_batch=320, window=3)
        got[name] = ([tr.step() for _ in ticks], tr.summary())
    assert got["port"] == got["jax"]
    assert got["port"][1]["windows"] == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    with TP.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert any("mm" in str(n) for n in names)


def test_cli_profile_writes_the_trace(synth_root, tmp_path, capsys):
    TT.main(["--preset", "config4", "--device", "cpu", "--profile",
             str(tmp_path / "prof"), "--override", *OV,
             f"data.root={synth_root}", f"train.ckpt_dir={tmp_path}/ck",
             "train.steps=1"])
    out = capsys.readouterr().out
    assert f"profile trace written to {tmp_path / 'prof'}" in out
    (path,) = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    # the step's forward operations and its backward ran inside the trace
    assert "aten::mm" in names and "BmmBackward0" in names


def test_debug_nans_raises_on_an_out_of_range_word(synth_root, tmp_path,
                                                   monkeypatch):
    """A word id past the vocab embeds as a NaN row (jnp.take's rule):
    with debug_nans the step raises FloatingPointError naming the first
    loss term; without it fit trains on, to NaN metrics."""
    real = TT.batch_to_device

    def bad_word(batch, device):
        out = real(batch, device)
        out["word_ids"][0, 0] = 1000
        return out

    monkeypatch.setattr(TT, "batch_to_device", bad_word)
    cfg = _cfg(synth_root, tmp_path, ["train.steps=2"])
    with pytest.raises(FloatingPointError, match="loss term 'l_rank'"):
        TT.fit(cfg, device="cpu", debug_nans=True)
    assert not torch.is_anomaly_enabled()
    state, metrics = TT.fit(_cfg(synth_root, tmp_path / "b",
                                 ["train.steps=2"]), device="cpu")
    assert state.step == 2 and np.isnan(float(metrics["loss"]))


def test_debug_nans_names_the_parameter(synth_root, tmp_path,
                                        monkeypatch):
    """A finite loss whose gradient is not (w_v's, made NaN in the
    backward): the check after the backward names the parameter."""
    from nafae_torch.data.loader import BatchLoader
    from nafae_torch.data.youcook2 import SegmentDataset

    class NanGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return g * torch.nan

    real = TT.G.project_regions
    monkeypatch.setattr(TT.G, "project_regions",
                        lambda f, w, b, *a, **k: real(f, NanGrad.apply(w),
                                                      b, *a, **k))
    cfg = _cfg(synth_root, tmp_path)
    ds = SegmentDataset(synth_root, "train", 8, 6, 64, 3)
    batch = TT.batch_to_device(next(iter(BatchLoader(ds, 8, seed=0))),
                               torch.device("cpu"))
    state = TT.TrainState.create(cfg, device="cpu")
    with pytest.raises(FloatingPointError,
                       match="gradient of parameter 'w_v'"):
        TT.train_step(state, batch, cfg, debug_nans=True)
    _, m = TT.train_step(state, batch, cfg)
    assert np.isfinite(float(m["loss"])) and np.isnan(float(m["grad_norm"]))


def test_cli_debug_nans_trains(synth_root, tmp_path, capsys):
    TT.main(["--preset", "config4", "--device", "cpu", "--debug-nans",
             "--override", *OV, f"data.root={synth_root}",
             f"train.ckpt_dir={tmp_path}/ck", "train.steps=2"])
    assert "step=2" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "ck" / "state_2.pt")
    assert not torch.is_anomaly_enabled()
