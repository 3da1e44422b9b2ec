"""CUDA graphs of the training step: capture with the launch counts and
the collectives carried over to every replay.

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

from nafae_torch.parallel import sharding as S


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
