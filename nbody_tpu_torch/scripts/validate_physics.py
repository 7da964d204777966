"""Production-scale physics validation: conservation over thousands of
substeps.

Counterpart of ``scripts/validate_physics.py``: the two-galaxy scene
(seed 11037, dt 0.005) run for ``steps`` substeps with 4 checkpoints of
``diagnostics.summary``, printing the energy drift and the momentum
change over its scale, and asserting a finite state.

Usage: python -m nbody_tpu_torch.scripts.validate_physics [N] [steps]
       [backend] [integrator] [--device cpu]
Defaults N=65536, steps=2000, backend "cuda" (the direct kernel;
"torch", "pm" and "p3m" validate the other backends), integrator "euler"
("leapfrog" and "yoshida4" validate the symplectic compositions).

The module also holds the 10k-substep horizon cases of
``tests/test_physics_validation.py`` (``HORIZON_CASES``,
:func:`invariants`) and its parity rule against the reference binary's
own 10k-step state (:func:`robust_metrics`, :func:`reference_binary`),
which the port's tests and ``chip_smoke.py`` share.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

import nbody_tpu_torch as nt
from nbody_tpu_torch.diagnostics import summary
from nbody_tpu_torch.examples import take_device
from nbody_tpu_torch.types import DEFAULT_SIM_CONFIG, SimConfig

ROOT = Path(__file__).resolve().parents[2]
SEED = 11037
DT = 0.005
CHECKPOINTS = 4


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device) -> tuple[float, float]:
    """(wall seconds, device ms) of ``fn()``; the device ms from CUDA
    events on the card, nan on the CPU."""
    device = torch.device(device)
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0, float("nan")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return time.perf_counter() - t0, start.elapsed_time(end)


def energy_momentum(world) -> tuple[float, np.ndarray]:
    s = summary(world)
    return s["kinetic_energy"] + s["potential_energy"], np.array(s["momentum"])


def momentum_scale(scene) -> float:
    """sum |m| · max(1, max |v|) of the initial scene, in float64."""
    mass = scene.mass.detach().cpu().double().numpy()
    vel = scene.vel.detach().cpu().double().numpy()
    return float(np.abs(mass).sum() * max(1.0, np.abs(vel).max()))


def run(n: int, steps: int, backend: str, integrator: str, device,
        log=print) -> dict:
    """The script's run: :func:`invariants` over 4 checkpoints of
    ``steps // 4`` substeps of the two-galaxy scene, with its lines."""
    scene = nt.make_galaxies(n, 2, seed=SEED)
    world = nt.create_world(
        scene, config=dataclasses.replace(DEFAULT_SIM_CONFIG,
                                          integrator=integrator),
        default_backend=backend, device=device)
    log(f"N={n} massive={world.mass_len} dt={DT} steps={steps} "
        f"backend={backend} integrator={integrator}")

    def line(k, row):
        if k == 0:
            log(f"start: E={row['e']:.6e}  p={row['p']}")
        else:
            log(f"step {(k * steps) // CHECKPOINTS:6d}: E={row['e']:.6e} "
                f"(drift {row['drift']:.2e})  |dp|/scale={row['dp']:.2e}")

    r = invariants(world, scene, device, chunks=CHECKPOINTS,
                   substeps=steps // CHECKPOINTS, dt=DT, log=line)
    if not r["finite"]:
        raise AssertionError("NaN in positions")
    log("finite state: OK")
    return {**r, "n": n, "mass_len": world.mass_len, "steps": steps,
            "backend": backend, "integrator": integrator, "world": world}


def main(argv: list | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = take_device(argv)
    n = int(argv[0]) if len(argv) > 0 else 65536
    steps = int(argv[1]) if len(argv) > 1 else 2000
    backend = argv[2] if len(argv) > 2 else "cuda"
    integrator = argv[3] if len(argv) > 3 else "euler"
    return run(n, steps, backend, integrator, device)


# --- tests/test_physics_validation.py's 10k-substep horizon cases ---------

HORIZON_DT = 0.005
HORIZON_CHUNKS = 4
HORIZON_CHUNK = 2500
# tests/test_physics_validation.py:21
DEFAULT_MATH = SimConfig(tile_targets=128, tile_sources=128, precise=False)
# one galaxy of seed 11037 each; the bounds are the worst energy drift and
# |dp|/scale at every chunk (None: not bounded)
HORIZON_CASES = {
    # :31, "torch" and "cuda" (nbody_tpu's "jnp" and "pallas")
    "exact": {"n": 1024, "config": DEFAULT_MATH, "drift": 1e-3, "dp": 1e-6},
    # :110
    "pm": {"n": 1024, "config": SimConfig(tile_targets=128, pm_grid=128,
                                          pm_softening=2.0),
           "backend": "pm", "drift": 5e-3, "dp": 2e-4},
    # :182
    "leapfrog": {"n": 1024, "config": dataclasses.replace(
        DEFAULT_MATH, integrator="leapfrog"), "drift": 1e-3, "dp": None},
    "yoshida4": {"n": 1024, "config": dataclasses.replace(
        DEFAULT_MATH, integrator="yoshida4"), "drift": 1e-3, "dp": None},
    # :140 on 8 shards, "cuda_ring" for nbody_tpu's "jnp" ring
    "ring": {"n": 1024, "config": DEFAULT_MATH, "shards": 8,
             "backend": "cuda_ring", "drift": 1e-3, "dp": 1e-6},
    "sharded_p3m": {"n": 512, "config": SimConfig(
        tile_targets=64, tile_sources=128, precise=False, pm_grid=64,
        p3m_cell_capacity=32), "shards": 8, "backend": "p3m",
        "drift": 5e-3, "dp": 2e-4},
}


def horizon_world(case: str, device, backend: str | None = None):
    """(scene, world) of a horizon case on ``device`` (a sharded case puts
    its shards all on that device); ``backend`` overrides the case's."""
    from nbody_tpu_torch.parallel.sharding import ShardedWorld, make_mesh

    c = HORIZON_CASES[case]
    scene = nt.make_galaxies(c["n"], 1, seed=SEED)
    backend = backend or c.get("backend")
    if "shards" in c:
        mesh = make_mesh(devices=[torch.device(device)] * c["shards"])
        return scene, ShardedWorld(scene, mesh, config=c["config"],
                                   force_backend=backend)
    return scene, nt.create_world(scene, config=c["config"],
                                  default_backend=backend, device=device)


def invariants(world, scene, device, *, chunks: int = HORIZON_CHUNKS,
               substeps: int = HORIZON_CHUNK, dt: float = HORIZON_DT,
               log=None) -> dict:
    """``chunks`` x ``substeps`` substeps of ``dt``: after each chunk the
    total energy, its drift and |dp|/scale (``rows``; ``log(k, row)`` sees
    the start as chunk 0), the worst drift and |dp|/scale, whether the
    state stayed finite, and the wall and device ms a substep."""
    e0, p0 = energy_momentum(world)
    pscale = momentum_scale(scene)
    if log:
        log(0, {"e": e0, "p": p0})
    rows, wall, dev = [], 0.0, 0.0
    for k in range(chunks):
        w_s, d_ms = timed(lambda: world.update(dt, substeps), device)
        wall, dev = wall + w_s, dev + d_ms
        e, p = energy_momentum(world)
        rows.append({"step": (k + 1) * substeps, "e": e,
                     "drift": abs(e - e0) / abs(e0),
                     "dp": float(np.linalg.norm(p - p0) / pscale)})
        if log:
            log(k + 1, rows[-1])
    done = max(chunks * substeps, 1)
    return {"e0": e0, "p0": p0, "rows": rows,
            "drifts": [r["drift"] for r in rows],
            "dp": [r["dp"] for r in rows],
            "worst_drift": max(r["drift"] for r in rows),
            "worst_dp": max(r["dp"] for r in rows),
            "finite": bool(torch.isfinite(world.particles.pos).all()),
            "wall_ms": wall * 1e3 / done, "device_ms": dev / done}


def check_invariants(label: str, r: dict, drift: float, dp: float | None):
    """Raise unless ``r`` (of :func:`invariants`) is finite, its worst
    drift under ``drift`` and every chunk's |dp|/scale under ``dp``."""
    if not r["finite"]:
        raise AssertionError(f"{label}: non-finite state")
    if dp is not None and not r["worst_dp"] < dp:
        raise AssertionError(f"{label}: |dp|/scale {r['worst_dp']:.2e} "
                             f"(bound {dp:.0e})")
    if not r["worst_drift"] < drift:
        raise AssertionError(f"{label}: energy drift {r['worst_drift']:.2e} "
                             f"(bound {drift:.0e})")


def run_horizon(case: str, device, backend: str | None = None) -> dict:
    """A horizon case at full horizon, checked at its bounds."""
    c = HORIZON_CASES[case]
    scene, world = horizon_world(case, device, backend)
    r = invariants(world, scene, device)
    check_invariants(f"{case} {backend or c.get('backend', '')}".strip(), r,
                     c["drift"], c["dp"])
    return r


def oracle_horizon(backend: str, device, steps: int = 10_000) -> dict:
    """tests/test_physics_validation.py:78: the default math on
    ``backend`` against the native sqrt oracle (``utils.cpp_oracle``) over
    ``steps`` substeps of 0.005 from one galaxy of N=150 (seed 13): total
    momentum, center of mass and the 90% extent of the massive rows.
    Raises past the test's bounds."""
    from nbody_tpu_torch.utils import cpp_oracle

    w0 = nt.create_world(nt.make_galaxies(150, 1, seed=13), device="cpu")
    host, mass_len = w0.particles, w0.mass_len
    want = cpp_oracle.oracle_update(host, mass_len, HORIZON_DT, steps)
    world = nt.create_world(host, config=DEFAULT_MATH, device=device)
    wall, dev = timed(lambda: world.update(HORIZON_DT, steps,
                                           backend=backend), device)
    m = host.mass.double().numpy()

    def stats(p):
        pos, vel = p.pos.double().numpy(), p.vel.double().numpy()
        com = (m[:, None] * pos).sum(axis=0) / m.sum()
        extent = np.percentile(np.hypot(*(pos[m > 0] - com).T), 90)
        return (m[:, None] * vel).sum(axis=0), com, extent

    (mom_a, com_a, ext_a), (mom_b, com_b, ext_b) = (
        stats(want), stats(world.particles))
    scale_p = (m * np.abs(host.vel.double().numpy()).max()).sum()
    r = {"mom": float(np.abs(mom_a - mom_b).max() / scale_p),
         "com": float(np.abs(com_a - com_b).max() / ext_a),
         "extent": float(abs(ext_a - ext_b) / ext_a),
         "wall_ms": wall * 1e3 / steps, "device_ms": dev / steps}
    if not (r["mom"] <= 1e-3 and r["com"] <= 1e-2 and r["extent"] < 0.2):
        raise AssertionError(f"oracle at horizon on {backend}: {r}")
    return r


# --- the reference binary's own 10k-step state ----------------------------

REF_N, REF_GALAXIES, REF_DT, REF_STEPS = 2000, 2, 0.01, 10_000
GOLDEN = "tests/data/ref_traj_n2000_g2_seed11037_s{steps}_dt0.01.hex"
# the floors of each metric's self-noise (tests/test_physics_validation.py:
# 346-348): com, momentum, radial quantiles
SELF_FLOORS = (1e-3, 1e-2, 5e-2)
NOISE_FACTOR = 4.0


def particle_rows(p) -> np.ndarray:
    """(N, 6) float32 rows ``pos vel mass radius`` of host Particles."""
    return np.concatenate(
        [p.pos.numpy(), p.vel.numpy(), p.mass.numpy()[:, None],
         p.radius.numpy()[:, None]], axis=1)


def robust_metrics(rows: np.ndarray):
    """Aggregates that survive the Lyapunov horizon: the center of mass,
    the total momentum and the 10/50/90% quantiles of the radius about the
    center of mass, in float64."""
    pos = rows[:, :2].astype(np.float64)
    vel = rows[:, 2:4].astype(np.float64)
    m = rows[:, 4].astype(np.float64)
    com = (m[:, None] * pos).sum(0) / m.sum()
    mom = (m[:, None] * vel).sum(0)
    r = np.linalg.norm(pos - com, axis=1)
    return com, mom, np.quantile(r, [0.1, 0.5, 0.9])


def reference_goldens(perm, steps: int = REF_STEPS, root=ROOT):
    """The AVX and scalar builds' dumps after ``steps``, rows in world
    order (``perm`` of ``partition_massive_first``)."""
    from nbody_tpu_torch.utils.ref_dump import load_hex_dump

    name = GOLDEN.format(steps=steps)
    perm = np.asarray(perm)
    return tuple(load_hex_dump(Path(root) / name.replace(
        "ref_traj_", f"ref_traj_{flavor}"))[perm] for flavor in ("", "scalar_"))


def reference_deviation(rows: np.ndarray, avx: np.ndarray,
                        scalar: np.ndarray) -> dict:
    """Each metric's deviation from the AVX build, for ``rows`` and for the
    scalar build (the reference's own noise): com over the median radius,
    momentum over |momentum|, each radial quantile relative; ``ok`` when
    every one of ``rows``' is under 4x the noise, floored."""
    com_a, mom_a, rq_a = robust_metrics(avx)
    r_med, mom_scale = rq_a[1], np.linalg.norm(mom_a)

    def dev(metrics):
        com, mom, rq = metrics
        return (float(np.linalg.norm(com - com_a) / r_med),
                float(np.linalg.norm(mom - mom_a) / mom_scale),
                np.abs(rq - rq_a) / rq_a)

    got, noise = dev(robust_metrics(rows)), dev(robust_metrics(scalar))
    ok = (got[0] < NOISE_FACTOR * max(noise[0], SELF_FLOORS[0])
          and got[1] < NOISE_FACTOR * max(noise[1], SELF_FLOORS[1])
          and bool(np.all(got[2] < NOISE_FACTOR
                          * np.maximum(noise[2], SELF_FLOORS[2]))))
    return {"com": got[0], "mom": got[1], "rq": got[2].tolist(),
            "self_com": noise[0], "self_mom": noise[1],
            "self_rq": noise[2].tolist(), "ok": ok}


def reference_binary(backend: str, device, steps: int = REF_STEPS,
                     root=ROOT) -> dict:
    """tests/test_physics_validation.py:309: the bit-exact IC (N=2000, two
    galaxies, seed 11037), ``steps`` substeps of 0.01, precise, on
    ``backend``, against both builds' dumps. Raises if the mass is not
    bit-exact, the state is not finite or a metric is past its bound."""
    from nbody_tpu_torch.models.galaxy_ref import make_galaxies_libc

    ic = make_galaxies_libc(REF_N, REF_GALAXIES, seed=SEED)
    perm, _ = nt.partition_massive_first(ic.mass)
    avx, scalar = reference_goldens(perm, steps, root)
    world = nt.create_world(ic, config=SimConfig(precise=True), device=device)
    wall, dev = timed(lambda: world.update(REF_DT, steps, backend=backend),
                      device)
    rows = particle_rows(world.particles)
    if not np.isfinite(rows).all():
        raise AssertionError(f"reference binary {backend}: non-finite state")
    if not np.array_equal(rows[:, 4], avx[:, 4]):
        raise AssertionError(f"reference binary {backend}: mass not bit-exact")
    d = reference_deviation(rows, avx, scalar)
    if not d["ok"]:
        raise AssertionError(f"reference binary {backend} after {steps} "
                             f"substeps: {d}")
    return {**d, "wall_ms": wall * 1e3 / steps, "device_ms": dev / steps}


if __name__ == "__main__":
    main()
