"""CUDA graphs of the port's device programs: capture with the launch
counts and the collectives carried over to every replay, and `Graphed`,
the program of serving, eval and feature extraction.

Each kernel wrapper of `ops/kernels` counts its launches in Python (the
module's `launches` dict), and `parallel.sharding.COLLECTIVES` records
each collective in Python too. A replayed graph runs no Python, so
`capture` notes what the captured code counted, takes it back out (a
capture launches nothing on the device), and `CapturedStep.replay` adds
it once a replay: the counts read after a run are those of the kernels
its steps launched, captured or not. `set_apart` moves the launches of
the eager warm-up runs before a capture, which are no steps of the run,
into a count of their own.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.utils._pytree as pytree

from nafae_torch.parallel import sharding as S

# eager runs of a program on a side stream before its capture: kernels
# build, lazily made constants (the detector's anchors) are made and
# cuDNN picks its algorithms in them, not in the capture
WARMUP_STEPS = 2


def counters() -> list[dict[str, int]]:
    """The `launches` dict of every kernel module."""
    from nafae_torch.ops.kernels import (cross_mil, ctx_mix, diag, nms,
                                         roi_align)

    return [m.launches for m in (ctx_mix, cross_mil, diag, nms, roi_align)]


class Counts:
    """A snapshot of every launch count and of the collective log."""

    def __init__(self):
        self.launches = [dict(c) for c in counters()]
        self.collectives = len(S.COLLECTIVES.records)

    def since(self) -> tuple[list[dict[str, int]], list]:
        """(launches counted since the snapshot, a dict a module; the
        collectives recorded since)."""
        return ([{k: n - was[k] for k, n in c.items() if n != was[k]}
                 for c, was in zip(counters(), self.launches)],
                S.COLLECTIVES.records[self.collectives:])

    def restore(self) -> None:
        """Puts the counts back and drops the records since."""
        for c, was in zip(counters(), self.launches):
            c.update(was)
        del S.COLLECTIVES.records[self.collectives:]


@contextlib.contextmanager
def set_apart(launches: dict[str, int]):
    """Runs the block with the launches it counts moved from the module
    counts into `launches` (by kernel) and its collectives dropped."""
    before = Counts()
    try:
        yield
    finally:
        for delta in before.since()[0]:
            for k, n in delta.items():
                launches[k] = launches.get(k, 0) + n
        before.restore()


class CapturedStep:
    """A captured graph with what its capture counted; `replay` runs it
    on the current stream and counts that once more."""

    def __init__(self, graph, launches: list[dict[str, int]],
                 collectives: list):
        self.graph, self.launches = graph, launches
        self.collectives = list(collectives)

    def replay(self) -> None:
        self.graph.replay()
        for c, delta in zip(counters(), self.launches):
            for k, n in delta.items():
                c[k] += n
        S.COLLECTIVES.records.extend(self.collectives)


def capture(body, graph, context) -> CapturedStep:
    """Runs body() inside `context` (torch.cuda.graph(graph, ...)), which
    captures it into `graph`; returns the CapturedStep, the counts as they
    were before."""
    before = Counts()
    try:
        with context:
            body()
        launches, collectives = before.since()
        return CapturedStep(graph, launches, collectives)
    finally:
        before.restore()


# the capture stream of each device (`capture_stream`)
_STREAMS: dict = {}


def capture_stream(device: str | torch.device) -> torch.cuda.Stream:
    """The side stream on which every program of the port warms up and is
    captured, one a device for the process. cuBLAS's workspace for a
    stream and a calling thread (this one, and autograd's for the
    backward) lives as long as the process, so one stream makes one of
    each; made here, with the allocator's cache emptied, each takes a
    small block of its own, where one made in a warm-up takes part of a
    freed activation's block and keeps the whole block reserved (7.81 GiB
    under config 5's f32 detector)."""
    device = torch.device(device)
    key = (device.index if device.index is not None
           else torch.cuda.current_device())
    stream = _STREAMS.get(key)
    if stream is None:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream), torch.enable_grad():
            for dt in (torch.float32, torch.bfloat16):
                x = torch.ones(16, 16, device=device, dtype=dt,
                               requires_grad=True)
                torch.nn.functional.linear(x, x, x[0]).sum().backward()
        stream.synchronize()
        _STREAMS[key] = stream
    return stream


def record(body, device: torch.device, pool, stream
           ) -> tuple[CapturedStep, int]:
    """Captures body() into a new CUDA graph in memory pool `pool` on
    `stream`, after the allocator's cache is emptied (a graph's pool
    cannot take the blocks that warm-up runs left cached, so they are
    given back first); returns the CapturedStep and the bytes the pool
    grew by."""
    torch.cuda.synchronize(device)
    # torch.cuda.graph empties the cache as it begins: do it first, so
    # that the growth of reserved memory is the pool's
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    step = capture(body, graph, torch.cuda.graph(
        graph, pool=pool, stream=stream, capture_error_mode="thread_local"))
    return step, torch.cuda.memory_reserved(device) - reserved


class Graphed:
    """fn(*args, **static) as one device program, the counterpart of the
    reference's `jax.jit(fn)` for an inference function: args are
    pytrees (dicts, tuples) of tensors, numpy arrays or None; static
    arguments are hashable values (eval's iou_thresh).

    On CUDA: a graph for each key (the args' structure, shapes and
    dtypes, and the static arguments), all in one memory pool. At a key's
    first call its static input buffers are made on the device, the args
    copied in, fn run WARMUP_STEPS times eagerly on a side stream (their
    launches set apart in stats["warmup_launches"]) and captured; every
    call copies the args into the key's buffers, replays and returns the
    graph's outputs. The outputs are the program's buffers, valid until
    the next call: read them before calling again (a caller shared by
    threads holds one lock over the call and the read). What fn reads
    besides its args (a model's weights) is read at each replay from the
    tensors the capture saw. An error in a capture or a replay raises.

    Elsewhere (`graphed` False: the CPU) fn runs eagerly on the args moved
    to `device`. `stats` counts graphs, replays, warm-up calls and their
    launches by kernel, capture seconds and the pool's bytes."""

    def __init__(self, fn, device: str | torch.device):
        self.fn, self.device = fn, torch.device(device)
        self.graphed = self.device.type == "cuda"
        self.stats = {"graphs": 0, "replays": 0, "warmup_calls": 0,
                      "warmup_launches": {}, "capture_s": 0.0,
                      "pool_bytes": 0}
        self._programs: dict = {}
        self._pool = self._stream = None

    def __call__(self, *args, **static):
        leaves, spec = pytree.tree_flatten(args)
        leaves = [None if x is None else torch.as_tensor(x) for x in leaves]
        if not self.graphed:
            return self.fn(*pytree.tree_unflatten(
                [None if x is None else x.to(self.device) for x in leaves],
                spec), **static)
        key = (spec, tuple(None if x is None else (x.shape, x.dtype)
                           for x in leaves), tuple(sorted(static.items())))
        program = self._programs.get(key)
        if program is None:
            bufs = [None if x is None else
                    torch.empty_like(x, device=self.device) for x in leaves]
            self._stage(bufs, leaves)
            program = self._programs[key] = (bufs, *self._capture(
                pytree.tree_unflatten(bufs, spec), static))
        else:
            self._stage(program[0], leaves)
        _, step, out = program
        step.replay()
        self.stats["replays"] += 1
        return out

    @staticmethod
    def _stage(bufs: list, leaves: list) -> None:
        for buf, x in zip(bufs, leaves):
            if buf is not None:
                buf.copy_(x, non_blocking=True)

    def _capture(self, args: tuple, static: dict) -> tuple:
        """Warm-up and capture of fn on the staged buffers: (the
        CapturedStep, its outputs)."""
        t0 = time.perf_counter()
        with self._side():
            with set_apart(self.stats["warmup_launches"]):
                for _ in range(WARMUP_STEPS):
                    self.fn(*args, **static)
                    self.stats["warmup_calls"] += 1
            step, out = self._record(lambda: self.fn(*args, **static))
        self.stats["graphs"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0
        return step, out

    @contextlib.contextmanager
    def _side(self):
        """The block on the program's side stream, ordered after the
        current stream's work and before its next."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = capture_stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            yield
        main.wait_stream(self._stream)

    def _record(self, body) -> tuple[CapturedStep, object]:
        """Captures body(); returns (the CapturedStep, what body returned:
        the graph's outputs)."""
        out = []
        step, grew = record(lambda: out.append(body()), self.device,
                            self._pool, self._stream)
        self.stats["pool_bytes"] += grew
        return step, out[0]
