"""Debug validation: numerical health (NaN/Inf) and the state's structural
invariants. Counterpart of ``nbody_tpu/utils/checks.py``. Opt-in; nothing
runs unless called.
"""

from __future__ import annotations

import numpy as np
import torch

from ..interop import FIELDS
from ..types import Particles


class SimulationDiverged(RuntimeError):
    pass


def _healthy(state: Particles) -> torch.Tensor:
    """One 0-dim bool on the state's device: every field finite."""
    ok = torch.ones((), dtype=torch.bool, device=state.pos.device)
    for name in FIELDS:
        ok = ok & torch.isfinite(getattr(state, name)).all()
    return ok


def check_state(state: Particles, context: str = "") -> None:
    """Raise SimulationDiverged if any field of ``state`` holds NaN or Inf.
    One device-to-host read of a flag; the fields are read back only to
    name the bad rows."""
    if bool(_healthy(state)):
        return
    where = []
    for name in FIELDS:
        arr = getattr(state, name).detach().cpu().numpy()
        bad = ~np.isfinite(arr)
        if bad.any():
            rows = np.unique(np.nonzero(bad)[0])[:8].tolist()
            where.append(f"{name}: {int(bad.sum())} bad at rows {rows}")
    ctx = f" ({context})" if context else ""
    raise SimulationDiverged(f"non-finite simulation state{ctx}: "
                             + "; ".join(where))


def validate_world_invariants(world) -> None:
    """Structural invariants of a World or ShardedWorld (a bundle of debug
    assertions). Under ``SimConfig.merge_collisions`` the massive-first
    partition weakens by design: absorbed bodies keep their row inside the
    prefix with mass 0 (``mass_len`` is an upper bound), and ``gm`` must
    track g·mass through every merge."""
    host = world.particles
    m = host.mass.numpy()
    assert world.total_len == host.pos.shape[0]
    merging = getattr(world.config, "merge_collisions", False)
    # World carries its gm row as .gm, ShardedWorld as .gm_src (src_len
    # rows); the prefix invariants are the same.
    gm = (world.gm if hasattr(world, "gm") else world.gm_src).cpu().numpy()
    if merging:
        assert np.all(m[: world.mass_len] >= 0), "negative mass in prefix"
        np.testing.assert_allclose(
            gm[: world.mass_len],
            world.config.g * m[: world.mass_len], rtol=1e-6,
            err_msg="gm row diverged from g*mass through a merge")
    else:
        assert np.all(m[: world.mass_len] > 0), \
            "massive-first partition violated"
    assert np.all(m[world.mass_len:] <= 0), "massive-first partition violated"
    assert np.all(gm[world.mass_len:] == 0), "gm mask leaks beyond mass_len"
    if hasattr(world, "n_pad"):
        assert world.n_pad >= world.src_len >= world.mass_len
    else:
        # a World has no padding rows and a gm of exactly mass_len rows,
        # where nbody_tpu's has n_pad >= src_len >= mass_len
        assert world.total_len >= world.mass_len == gm.shape[0]


class CheckedWorld:
    """Proxy that validates the state after every update: the debug
    build."""

    def __init__(self, world):
        self._world = world

    def update(self, dt, n=1, backend=None, **kwargs):
        # ShardedWorld.update has no backend keyword: pass it only when
        # given; other keywords (extra_force, ...) go straight through
        if backend is None:
            self._world.update(dt, n, **kwargs)
        else:
            self._world.update(dt, n, backend=backend, **kwargs)
        check_state(self._world.state, context=f"after update(dt={dt}, n={n})")
        return self

    def update_adaptive(self, t_span, **kwargs):
        n = self._world.update_adaptive(t_span, **kwargs)
        check_state(self._world.state,
                    context=f"after update_adaptive(t_span={t_span})")
        return n

    def __getattr__(self, name):
        return getattr(self._world, name)
