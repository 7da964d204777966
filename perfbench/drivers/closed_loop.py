"""The closed loop on one host thread: ``World.update(dt, k)`` calls of
``substeps_per_call`` substeps back to back, with no host sync inside the
window; every ``restart_every`` substeps the state is put back to the
set-up's initial state by a device copy, so that every run simulates the
same stretch of the scene whatever its speed.

The window's first call is enqueued as 1 + (k − 1) substeps and its last
as (k − 1) + 1, with a copy of the state between the pieces, which the
judge reads. The host's clock around each ``World.update`` of the window
is summed into ``host_s``.
"""

from __future__ import annotations

import time

FIELDS = ("pos", "vel", "acc", "mass", "radius")


def snapshot(state) -> dict:
    return {f: getattr(state, f).clone() for f in FIELDS}


class Driver:
    def __init__(self, world, cfg: dict, traffic: dict, sync):
        self.world, self.dt, self.sync = world, float(cfg["dt"]), sync
        self.per_call = int(traffic["substeps_per_call"])
        self.restart_every = int(traffic["restart_every"])
        self.trace_calls = int(traffic["trace_calls"])
        self.init = snapshot(world.state)
        self.init["gm"] = world.gm.clone()
        self.init["mass_len"] = int(world.mass_len)
        self.since = 0
        self.host_s = 0.0
        self.traced_ends: list = []

    @property
    def trace_substeps(self) -> int:
        return self.trace_calls * self.per_call

    def reset(self) -> None:
        for f in FIELDS:
            getattr(self.world.state, f).copy_(self.init[f])
        self.since = 0

    def update(self, n: int) -> None:
        t = time.perf_counter()
        self.world.update(self.dt, n)
        self.host_s += time.perf_counter() - t

    def call(self, first: bool = False, last: bool = False, snaps=None) -> None:
        """One call of the traffic; ``first`` and ``last`` split it around
        a copy of the state for the judge."""
        if self.since >= self.restart_every:
            self.reset()
        n = self.per_call
        if first:
            self.update(1)
            snaps["first"] = snapshot(self.world.state)
            n -= 1
        if last:
            self.update(n - 1)
            snaps["prev"] = snapshot(self.world.state)
            self.update(1)
            snaps["end"] = snapshot(self.world.state)
        else:
            self.update(n)
        self.since += self.per_call

    def warm(self) -> None:
        """Every shape the window uses, then the initial state again."""
        self.call()
        self.reset()

    def window(self, seconds: float) -> dict:
        """Calls until ``seconds`` have passed on the host clock, then one
        more, then a sync: {"run_s", "substeps", "host_s", "snaps"}, where
        ``host_s`` is the host's time inside ``World.update`` and ``snaps``
        the states the judge reads."""
        snaps = {"init": self.init}
        t0 = time.perf_counter()
        self.reset()
        self.host_s = 0.0
        deadline = t0 + seconds
        calls = 0
        while True:
            last = time.perf_counter() >= deadline
            self.call(first=calls == 0, last=last, snaps=snaps)
            calls += 1
            if last:
                break
        self.sync()
        return {"run_s": time.perf_counter() - t0,
                "substeps": calls * self.per_call, "host_s": self.host_s,
                "snaps": snaps}

    def traced(self) -> None:
        """The traced window's calls; the positions before and after them
        go to ``traced_ends``."""
        if self.since >= self.restart_every:
            self.reset()
        self.traced_ends = [self.world.state.pos.clone()]
        for _ in range(self.trace_calls):
            self.call()
        self.traced_ends.append(self.world.state.pos.clone())
