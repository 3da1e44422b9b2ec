"""Profiling helpers: a torch.profiler trace of a block, and a frames/sec
counter (the port of `nafae_tpu/utils/profiling.py`).

    with trace("/tmp/nafae_trace"):
        state, metrics = train_step(state, batch, cfg)
    # -> a Chrome trace JSON (<host>_<pid>.<ms>.pt.trace.json) in the
    #    directory, readable by Perfetto or chrome://tracing

    tracker = ThroughputTracker(frames_per_batch=B*T)
    ... tracker.step() each train step; tracker.summary()

The reference's `collective_payloads` parses XLA's HLO; the port counts
its collectives as it issues them (`parallel.sharding.COLLECTIVES`).
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block: CPU activity, and CUDA activity when
    a card is present; the trace is written to log_dir as the block ends."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


class ThroughputTracker:
    """Frames/sec counter over windows of `window` steps."""

    def __init__(self, frames_per_batch: int, window: int = 50):
        self.frames_per_batch = frames_per_batch
        self.window = window
        self._t0 = None
        self._count = 0
        self.history: list[float] = []

    def step(self) -> float | None:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            return None
        self._count += 1
        if self._count % self.window == 0:
            fps = self.frames_per_batch * self.window / (now - self._t0)
            self.history.append(fps)
            self._t0 = now
            return fps
        return None

    def summary(self) -> dict:
        if not self.history:
            return {"frames_per_sec": 0.0, "windows": 0}
        return {"frames_per_sec": sum(self.history) / len(self.history),
                "peak_frames_per_sec": max(self.history),
                "windows": len(self.history)}
