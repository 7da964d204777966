"""Set-up shared by the ablation modules: the bench scene's rows in the TPU
scripts' layouts, timing with CUDA events, and the direct-sum control.

Counterpart of the scripts' shared preambles (``make_inputs`` in
``scripts/ablations/tune_r2.py:116-124`` and the ``main`` bodies of
``tune_r2d.py:104-115``, ``tune_r2g.py:97-109``, ``tune_r2h.py:163-176``):
the N=65536 two-galaxy scene with seed 11037, through the port's own
``make_galaxies`` and ``create_world``, massive rows first.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass

import torch

from .. import forces
from ..galaxy import make_galaxies
from ..ops import direct_forces as df
from ..types import Particles, round_up
from ..world import World, create_world

SEED = 11037
N = 65536
# A configuration against its plain version, max|Δ|/max|ref|: the direct
# force's bound up to N=65536 (fp32 sums of S terms in another order, FMA
# contraction and the hardware rsqrt).
BOUND = 5e-6


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0])


def require_cuda() -> torch.device:
    """The CUDA device; the ablations measure the card and do not run on
    the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("the ablation modules run on a CUDA device; "
                           "torch.cuda.is_available() is False")
    return torch.device("cuda")


@dataclass
class Scene:
    """A world's state in partitioned order, with ``gm`` (N,) zero past the
    massive prefix."""

    particles: Particles
    world: World
    pos: torch.Tensor      # (N, 2)
    radius: torch.Tensor   # (N,)
    gm: torch.Tensor       # (N,)

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def mass_len(self) -> int:
        return self.world.mass_len

    @property
    def s128(self) -> int:
        """The scripts' source length: mass_len rounded up to 128."""
        return round_up(self.mass_len, 128)

    @property
    def pairs(self) -> int:
        """The scripts' real pairs: N * mass_len."""
        return self.n * self.mass_len

    def _rows(self, cols, length: int) -> torch.Tensor:
        """(len(cols), length) rows from (column, padding value) pairs; rows
        past N hold the padding value."""
        out = torch.empty((len(cols), length), dtype=torch.float32,
                          device=self.pos.device)
        k = min(length, self.n)
        for r, (col, pad) in enumerate(cols):
            out[r, :k] = col[:k]
            out[r, k:] = pad
        return out

    def src3(self, length: int, pos: torch.Tensor | None = None) -> torch.Tensor:
        """(3, length) sources x; y; gm (K5a, K5d, K5g), at ``pos`` if given."""
        pos = self.pos if pos is None else pos
        return self._rows([(pos[:, 0], 0.0), (pos[:, 1], 0.0), (self.gm, 0.0)],
                          length)

    def tgt3(self) -> torch.Tensor:
        """(3, N) targets x; y; r (K5d, K5g)."""
        return self._rows([(self.pos[:, 0], 0.0), (self.pos[:, 1], 0.0),
                           (self.radius, 1.0)], self.n)

    def tgt4(self) -> torch.Tensor:
        """(4, N) targets x; y; r; gm (K5h)."""
        return self._rows([(self.pos[:, 0], 0.0), (self.pos[:, 1], 0.0),
                           (self.radius, 1.0), (self.gm, 0.0)], self.n)

    def src4(self, length: int) -> torch.Tensor:
        """(4, length) sources x; y; gm; r (K5h)."""
        return self._rows([(self.pos[:, 0], 0.0), (self.pos[:, 1], 0.0),
                           (self.gm, 0.0), (self.radius, 1.0)], length)

    def control(self) -> torch.Tensor:
        """(N, 2): the plain direct sum over the massive prefix, rsqrt path,
        the scripts' jnp control."""
        return forces.direct_sum_acc(self.pos, self.radius,
                                     self.pos[:self.mass_len], self.world.gm,
                                     precise=False)

    def force_acc(self) -> torch.Tensor:
        """K1's ``force_acc`` on the same inputs."""
        return df.force_acc(self.pos, self.radius, self.pos[:self.mass_len],
                            self.world.gm)


def make_scene(n: int = N, seed: int = SEED, device="cuda") -> Scene:
    """The two-galaxy scene of n particles and its world on ``device``."""
    particles = make_galaxies(n, 2, seed=seed)
    world = create_world(particles, device=device)
    st = world.state
    gm = torch.zeros(n, dtype=torch.float32, device=world.device)
    gm[:world.mass_len] = world.gm
    return Scene(particles, world, st.pos, st.radius, gm)


def time_it(fn, reps: int = 20, repeats: int = 3) -> float:
    """Milliseconds per call of fn: one warm-up call, then the best of
    ``repeats`` runs of ``reps`` calls between CUDA events (the scripts'
    ``time_it``)."""
    fn()
    best = float("inf")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(repeats):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same bits, NaNs included (torch.equal fails on NaN)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def rel_finite(got: torch.Tensor, want: torch.Tensor) -> tuple[float, bool]:
    """(max|got - want| / max|want| over the entries where want is finite,
    whether got is finite exactly where want is). 0 error when want has no
    finite entry."""
    fin = torch.isfinite(want)
    same = torch.equal(torch.isfinite(got), fin)
    if not fin.any():
        return 0.0, same
    return rel(got[fin], want[fin]), same


def measure(name: str, call, as_acc, want: torch.Tensor, scene: Scene,
            k1_ms: float, log=print) -> dict:
    """Run ``call`` twice (the two results must be bit-equal), hold
    ``as_acc`` of its result, an (N, 2) acceleration, against ``want`` (the
    plain version's), time it, and log one line."""
    first, again = as_acc(call()), as_acc(call())
    torch.cuda.synchronize()
    same = torch.equal(first, again)
    err = rel(first, want)
    ms = time_it(call)
    ok = same and err < BOUND and bool(torch.isfinite(first).all())
    log(f"  {name:>24}: {ms * 1e3:9.1f} µs  {scene.pairs / (ms * 1e-3):.4e} "
        f"pairs/s  max|d|/max|ref| {err:.3e}  {ms / k1_ms:.3f}x force_acc  "
        f"bit-equal {same}{'' if ok else '  FAIL'}")
    return {"name": name, "ms": ms, "err": err, "ok": ok,
            "max_abs_err": float((first - want).abs().max())}


def finish(label: str, results: list) -> list:
    """Raise if any configuration failed its checks; else return them."""
    bad = [r["name"] for r in results if not r["ok"]]
    if bad:
        raise RuntimeError(f"{label}: out of bound, not finite or not "
                           f"bit-equal from run to run: {bad}")
    return results


def header(label: str, scene: Scene, log=print) -> float:
    """Log the scene and K1's force_acc time on it; return that time (ms)."""
    k1_ms = time_it(scene.force_acc)
    log(f"{label}: N={scene.n} mass_len={scene.mass_len} S128={scene.s128}; "
        f"force_acc (K1) {k1_ms * 1e3:.1f} µs, "
        f"{scene.pairs / (k1_ms * 1e-3):.4e} pairs/s")
    return k1_ms
