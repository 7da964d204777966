"""The comparison that decides ``correct``.

The timed path's output is a state after many substeps of a chaotic
system: two correct summation orders drift apart within some hundred
substeps, so no reference can follow the window's whole stretch and land
on the same state. The reference therefore follows the program step by
step from the program's own state, at the window's close, and the start
and the first substep are checked by themselves:

* ``start_mismatch``: the world's state after ``create_world`` (every row
  of pos, vel, acc, mass, radius, gm and the count of massive rows)
  against the reference's own partition of the scene, and mass and radius
  at every snapshot: the elements that differ (limit 0).
* the first substep of the window, from the reference's own start, and the
  last, from the program's state one substep before the close, each the
  worse of the two: ``acc_err``, the program's ``acc`` after the substep
  against the reference's force at the pre-state's positions, the worst
  row of |program − reference| over max(|a|, the median |a|); and
  ``vel_ulp``, ``pos_ulp``, the program's ``vel`` and ``pos`` against the
  reference's update of the pre-state by the program's own force (the
  reference module owns its integrator), in float32 ulps of the values.
  The state itself is float32: a velocity of 1e5 is held to 0.008, more
  than a substep's increment of some rows, so the update is judged at the
  precision the state is stored in.
* where the configuration states a force error bound against the exact
  direct sum (``guarantee_vs_direct``), quantiles of the per-target error
  of the program's force on a sample of rows drawn from the seed, each
  under the name the configuration gives it (``p3m_err_median``,
  ``p3m_err_p95``); those without a limit are printed only.

Every limit sits in the configuration's file; ``PERF.md`` gives the
readings each was set from.
"""

from __future__ import annotations

import importlib
import sys

import numpy as np
import torch

from .reference import common

FIELDS = ("pos", "vel", "acc", "mass", "radius")


def reference_module(cfg: dict):
    return importlib.import_module(f"perfbench.reference.{cfg['reference']}")


def rel_rows(got, want, scale, what: str = "") -> float:
    """max over rows of |got − want| / max(scale, median(scale)); the worst
    row is described on standard error under ``what``."""
    d = (got.to(torch.float64) - want.to(torch.float64)).norm(dim=1)
    med = float(scale.median())
    r = d / torch.clamp(scale, min=med)
    i = int(torch.argmax(torch.nan_to_num(r, nan=float("inf"))))
    if what:
        print(f"  {what}: worst row {i}: |d| {float(d[i])!r}, scale "
              f"{float(scale[i])!r}, median scale {med!r}, got "
              f"{got[i].tolist()}, want {want[i].tolist()}",
              file=sys.stderr, flush=True)
    return float(r[i])


def mismatches(a, b) -> int:
    """Elements of two float32 tensors that are not bit-equal."""
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def start_mismatch(ref: dict, snaps: dict) -> int:
    init = snaps["init"]
    n = sum(mismatches(init[f], ref[f]) for f in FIELDS)
    n += mismatches(init["gm"], ref["gm"]) + abs(init["mass_len"] - ref["mass_len"])
    for key in ("first", "prev", "end"):
        n += sum(mismatches(snaps[key][f], ref[f]) for f in ("mass", "radius"))
    return n


def ulps(got, base, inc, what: str = "") -> float:
    """max over elements of |got − (base + inc)|, the sum exact in float64,
    in units of the float32 spacing at max(|base|, |got|): the rounding
    that a float32 update of ``base`` by ``inc`` may leave is below 3."""
    got, base = got.to(torch.float32), base.to(torch.float32)
    m = torch.maximum(base.abs(), got.abs())
    spacing = (torch.nextafter(m, torch.full_like(m, float("inf"))) - m).double()
    r = (got.double() - (base.double() + inc)).abs() / spacing
    flat = torch.nan_to_num(r, nan=float("inf")).reshape(-1)
    i = int(torch.argmax(flat))
    if what:
        row, col = divmod(i, got.shape[1])
        print(f"  {what}: worst element ({row}, {col}): got "
              f"{float(got[row, col])!r}, base {float(base[row, col])!r}, "
              f"increment {float(inc[row, col])!r}", file=sys.stderr, flush=True)
    return float(flat[i])


def step_errors(refmod, cfg: dict, want_acc, got: dict, pos, vel,
                label: str = "") -> dict:
    """The judged substep from (pos, vel): the program's force against the
    reference's (``acc_err``), and its update of each field against the
    reference's update by the program's own values, in float32 ulps
    (``vel_ulp``, ``pos_ulp``)."""
    out = {"acc_err": rel_rows(got["acc"], want_acc, want_acc.norm(dim=1),
                               label and label + " acc")}
    for f, (base, inc) in refmod.update_parts(cfg, pos, vel, got).items():
        out[f + "_ulp"] = ulps(got[f], base, inc, label and f"{label} {f}")
    return out


def sample_rows(n: int, k: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng([int(seed) % (1 << 64), 1])
    return torch.from_numpy(rng.choice(n, min(k, n), replace=False)).to(device)


def direct_errors(pos, acc, ref: dict, rows, quantiles: dict,
                  label: str = "") -> dict:
    """Quantiles of the per-target error of ``acc`` on ``rows`` against the
    exact direct sum at ``pos``, |a − a_exact| / (|a_exact| + 0.01·mean
    |a_exact|): {name: the error at that quantile}."""
    want = common.direct_acc(pos[rows], ref["radius"][rows],
                             pos[:ref["mass_len"]], ref["gm"])
    mag = want.norm(dim=1)
    err = (acc[rows].to(torch.float64) - want).norm(dim=1) / (mag + 0.01 * mag.mean())
    out = {k: float(torch.quantile(err, q)) for k, q in quantiles.items()}
    print(f"  {label}: per-target error against the direct sum on {rows.shape[0]}"
          f" rows: {out}, max {float(err.max())!r}, rows above 0.05: "
          f"{int((err > 0.05).sum())}", file=sys.stderr, flush=True)
    return out


def worst(a: dict, b: dict) -> dict:
    return {k: max(a[k], b[k]) if k in a else b[k] for k in b}


def numbers(cfg: dict, scene: dict, snaps: dict, seed: int, device,
            post=None) -> dict:
    """Every number compared, {name: value}. ``post(pre_pos, pre_vel,
    program_state)`` gives the state judged after each judged substep: the
    program's own by default; the control puts the reference in a lower
    precision there."""
    refmod = reference_module(cfg)
    ref = common.partition(scene, device)
    post = post or (lambda pos, vel, got: got)
    out = {"start_mismatch": start_mismatch(ref, snaps)}
    judged = ((ref["pos"], ref["vel"], snaps["first"]),
              (snaps["prev"]["pos"], snaps["prev"]["vel"], snaps["end"]))
    guarantee = cfg.get("guarantee_vs_direct")
    errs: dict = {}
    for label, (pos, vel, got) in zip(("first substep", "last substep"), judged):
        got = post(pos, vel, got)
        want = refmod.acc(pos, ref["radius"], ref["gm"], cfg)
        e = step_errors(refmod, cfg, want, got, pos, vel, label)
        if guarantee:
            rows = sample_rows(pos.shape[0], guarantee["sample_rows"], seed, device)
            e.update(direct_errors(pos, got["acc"], ref, rows,
                                   guarantee["quantiles"], label))
        errs = worst(errs, e)
    out.update(errs)
    return out


def control_post(cfg: dict, scene: dict, device, dtype=torch.bfloat16):
    """The control: the reference put in the program's place, computed in
    bfloat16 (the precision below the configuration's float32)."""
    refmod = reference_module(cfg)
    ref = common.partition(scene, device)

    def post(pos, vel, got):
        return refmod.step(cfg, ref, pos, vel, dtype)
    return post


def checks(cfg: dict, values: dict) -> dict:
    """{name: {"value", "limit"}} in the configuration's order of limits; a
    number that was not read is NaN and fails."""
    return {k: {"value": values.get(k, float("nan")), "limit": lim}
            for k, lim in cfg["limits"].items()}


def passed(check: dict) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in check.values())
