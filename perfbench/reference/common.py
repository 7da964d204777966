"""What every configuration's reference shares: the world's start (the
massive-first partition and gm), the direct sum, and the Euler step that
the references of Euler configurations take.

The reference's semantics are those of Urist-McDeveloper/nbody
(``src/lib/world.c:33-46``, ``sim_cpu.c:156-194``): rows with mass > 0
first, each group in its original order; a massive source j pulls target
i with g·m_j·(x_j − x_i) / (r2·sqrt(r2)), r2 = |x_j − x_i|² + radius_i;
semi-implicit Euler v += a·dt; x += v·dt with dt rounded to float32.
"""

from __future__ import annotations

import numpy as np
import torch

G = 10.0
# Added to the target radius where r2 is formed (absorbed for any real
# radius; turns a zero-mass source on a zero-radius target into 0).
SOFTENING_FLOOR = 1e-18
# Elements of one (targets, sources) temporary of the direct sum: 2**24
# float64 is 128 MiB, and about ten are alive at once.
CHUNK_ELEMS = 1 << 24


def partition(scene: dict, device) -> dict:
    """The world's start as the reference forms it from the scene: every
    field in massive-first order (a stable sort), float32 on ``device``,
    acc 0, ``mass_len`` and gm = G·mass[:mass_len] formed in float32."""
    mass = np.asarray(scene["mass"], dtype=np.float32)
    order = np.argsort(mass <= 0, kind="stable")
    mass_len = int(np.count_nonzero(mass > 0))

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x, dtype=np.float32)[order])).to(device)

    state = {"pos": put(scene["pos"]), "vel": put(scene["vel"]),
             "mass": put(mass), "radius": put(scene["radius"])}
    state["acc"] = torch.zeros_like(state["pos"])
    state["gm"] = state["mass"][:mass_len] * torch.tensor(
        G, dtype=torch.float32, device=device)
    state["mass_len"] = mass_len
    return state


def direct_acc(tgt_pos, tgt_radius, src_pos, gm, dtype=torch.float64):
    """The exact direct sum on the targets, in ``dtype``, a block of
    targets at a time: (T, 2)."""
    tp, tr = tgt_pos.to(dtype), tgt_radius.to(dtype)
    sp, sg = src_pos.to(dtype), gm.to(dtype)
    out = torch.empty((tp.shape[0], 2), dtype=dtype, device=tp.device)
    block = max(1, CHUNK_ELEMS // max(sp.shape[0], 1))
    for t0 in range(0, tp.shape[0], block):
        t = slice(t0, t0 + block)
        dx = sp[None, :, 0] - tp[t, None, 0]
        dy = sp[None, :, 1] - tp[t, None, 1]
        r2 = dx * dx + dy * dy + (tr[t, None] + SOFTENING_FLOOR)
        f = sg[None, :] / (r2 * torch.sqrt(r2))
        out[t, 0] = (dx * f).sum(1)
        out[t, 1] = (dy * f).sum(1)
    return out


def dt32(dt: float) -> float:
    """dt as the program's float32 arithmetic sees it."""
    return float(np.float32(dt))


def euler(pos, vel, acc, dt: float, dtype=torch.float64):
    """Semi-implicit Euler from (pos, vel) with ``acc``: (pos', vel')."""
    d = dt32(dt)
    vel = vel.to(dtype) + d * acc.to(dtype)
    return pos.to(dtype) + d * vel, vel


def check_integrator(cfg: dict, integrators) -> None:
    """Refuses a configuration whose integrator the reference module does
    not step: its substep would be judged against another method."""
    name = cfg["sim"].get("integrator", "euler")
    if name not in integrators:
        raise ValueError(f"this reference steps {', '.join(integrators)}, "
                         f"not the configuration's {name!r}")


def euler_step(acc_fn, cfg: dict, ref: dict, pos, vel, dtype=torch.float64):
    """One reference substep from (pos, vel) with the force ``acc_fn``:
    {acc, vel, pos} in ``dtype``."""
    check_integrator(cfg, ("euler",))
    acc = acc_fn(pos, ref["radius"], ref["gm"], cfg, dtype)
    npos, nvel = euler(pos, vel, acc, cfg["dt"], dtype)
    return {"acc": acc, "vel": nvel, "pos": npos}


def euler_parts(cfg: dict, pos, vel, got: dict) -> dict:
    """The Euler update by the program's own force and velocity, each
    field as (base, increment), their sum exact in float64: v' = v + dt·a,
    x' = x + dt·v'."""
    check_integrator(cfg, ("euler",))
    d = dt32(cfg["dt"])
    return {"vel": (vel, d * got["acc"].double()),
            "pos": (pos, d * got["vel"].double())}
