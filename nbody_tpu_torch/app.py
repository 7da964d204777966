"""Command-line application: run, render, gif and view, on the card by
default.

Counterpart of ``nbody_tpu/app.py`` with its flags, defaults, checks and
messages, under the port's names:

  python -m nbody_tpu_torch run    --n 6000 --galaxies 3 --steps 1000 [--traj out.npz]
  python -m nbody_tpu_torch render --state state.npz --out frame.ppm
  python -m nbody_tpu_torch gif    --n 6000 --frames 120 --out anim.npz
  python -m nbody_tpu_torch view   --n 6000 [--sdl]

``--backend`` takes the port's backends: "torch" (nbody_tpu's "jnp"),
"cuda" (its "pallas"), "pm", "p3m" and "auto". ``--platform`` is the
device: "cuda" (the default) or "cpu"; without a card, "cuda" exits with
an error and does not fall back to the CPU. ``--shard`` shards the run
over every visible card (a 1-device mesh on the CPU). ``--scene plummer``,
``kepler`` and ``cold`` draw their disk on that device with a
``torch.Generator`` seeded from ``--seed`` (a card's stream is not the
CPU's, so the two give different scenes of the same distribution); the
default ``--scene galaxies`` is the numpy generator on the host. ``view``
opens the matplotlib viewer, or with ``--sdl`` the pygame game loop; where
that viewer cannot run (no pygame, no interactive matplotlib backend) it
exits with an error and does not switch to the other. ``--compile-cache
[DIR]`` builds and loads the CUDA kernels' libraries in DIR (bare:
$NBODY_TPU_TORCH_CACHE_DIR or ~/.cache/nbody_tpu_torch/kernels), so that a
repeat launch loads them with no nvcc build. Not registered: the
remote-device probe.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from . import create_world, make_galaxies
from .render import fit_camera, render_frame, save_ppm
from .types import SimConfig
from .utils.checkpoint import load_particles, save_world_atomic, saved_config
from .viewer import PHYS_STEP, Viewer, export_animation

PROG = "nbody_tpu_torch"


def _add_scene_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--n", type=int, default=6000, help="particle count (main.c:13)")
    p.add_argument("--galaxies", type=int, default=3, help="galaxy count (main.c:44)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scene",
                   choices=["galaxies", "plummer", "kepler", "cold"],
                   default="galaxies",
                   help="model family: spiral galaxies (reference scene, "
                        "numpy on the host), or a Plummer, Kepler or cold-"
                        "collapse disk drawn on --platform's device")
    p.add_argument("--state", help="resume from a .npz checkpoint instead of generating")
    p.add_argument("--backend", choices=["torch", "cuda", "pm", "p3m", "auto"],
                   default=None,
                   help="force backend ('auto' = exact direct sum or p3m by "
                        "the pair count, the main.c:55 scale mux)")
    p.add_argument("--dt", type=lambda s: s if s == "auto" else float(s),
                   default=PHYS_STEP,
                   help="substep size, or 'auto' for the softening-"
                        "resolution criterion (diagnostics.suggest_dt: "
                        "0.1 · min sqrt(eps/|a|) on the initial state)")
    p.add_argument("--precise", action="store_true",
                   help="exact sqrt+divide force math (reference shader semantics)")
    p.add_argument("--integrator", choices=["euler", "leapfrog", "yoshida4"],
                   default="euler",
                   help="euler = reference-exact; leapfrog = 2nd-order "
                        "symplectic; yoshida4 = 4th-order symplectic "
                        "(3 force evals/substep)")
    p.add_argument("--pm-grid", default=512,
                   type=lambda s: s if s == "auto" else int(s),
                   help="particle-mesh resolution (backend=pm/p3m), or "
                        "'auto' for the sqrt(N) heuristic "
                        "(ops.pm_forces.suggest_grid)")
    p.add_argument("--pm-softening", type=float, default=2.0,
                   help="global Plummer softening length (backend=pm/p3m)")
    p.add_argument("--p3m-rc-cells", type=int, default=4,
                   help="p3m short-range cutoff in grid cells (wider = "
                        "smaller handoff error, more pair work)")
    p.add_argument("--p3m-cell-capacity", type=int, default=96,
                   help="p3m sources kept per cell (heaviest-first)")
    p.add_argument("--p3m-exact-targets", type=int, default=64,
                   help="p3m largest-radius targets computed by direct sum")
    p.add_argument("--p3m-rebin", type=int, default=1,
                   help="p3m: recompute cell sorts every this many substeps "
                        "(1 = exact; >1 trades a bounded rc-boundary error "
                        "for amortized sort cost at large N)")
    p.add_argument("--p3m-pp-chunk", type=int, default=64,
                   help="p3m: accepted for nbody_tpu's command lines; "
                        "changes nothing here")
    p.add_argument("--merge", nargs="?", const=1.0, type=float, default=None,
                   metavar="FACTOR",
                   help="inelastic collision merging: overlapping massive "
                        "bodies (|d| < FACTOR*(r_i+r_j), default 1.0) merge "
                        "lighter-into-heavier with exact mass/momentum "
                        "transfer (backends torch/cuda/pm)")


# CLI flag -> (SimConfig field, the flag's argparse default): on resume the
# checkpoint's saved config is the base and only a flag off its default
# overrides it (a flag passed at its default keeps the saved value).
_CONFIG_FLAG_DEFAULTS = {
    "precise": ("precise", False),
    "integrator": ("integrator", "euler"),
    "pm_grid": ("pm_grid", 512),
    "pm_softening": ("pm_softening", 2.0),
    "p3m_rc_cells": ("p3m_rc_cells", 4),
    "p3m_cell_capacity": ("p3m_cell_capacity", 96),
    "p3m_exact_targets": ("p3m_exact_targets", 64),
    "p3m_rebin": ("p3m_rebin_interval", 1),
    "p3m_pp_chunk": ("p3m_pp_chunk", 64),
}


def _make_world(args):
    """Build the world on ``args.device``; returns (world, start_step),
    start_step being the resumed checkpoint's substep counter (0 for a
    fresh scene)."""
    start = 0
    saved = None
    if args.state:
        particles, extra = load_particles(args.state)
        start = int(extra.get("step", 0))
        saved = saved_config(extra)
    else:
        scene = getattr(args, "scene", "galaxies")
        if scene == "galaxies":
            particles = make_galaxies(args.n, args.galaxies, seed=args.seed)
        else:
            from . import models

            maker = {"plummer": models.make_plummer_disk,
                     "kepler": models.make_kepler_disk,
                     "cold": models.make_cold_disk}[scene]
            gen = torch.Generator(device=args.device).manual_seed(args.seed)
            particles = maker(gen, args.n)
    pm_grid = args.pm_grid
    if pm_grid == "auto":
        from .ops.pm_forces import suggest_grid

        pm_grid = suggest_grid(particles.pos.shape[0])
        print(f"pm_grid auto -> {pm_grid}", file=sys.stderr)
    if saved is not None:
        overrides = {}
        for flag, (field, default) in _CONFIG_FLAG_DEFAULTS.items():
            value = pm_grid if flag == "pm_grid" else getattr(args, flag)
            if getattr(args, flag) != default:
                overrides[field] = value
        if args.merge is not None:
            overrides["merge_collisions"] = True
            overrides["merge_factor"] = args.merge
        config = dataclasses.replace(saved, **overrides)
    else:
        config = SimConfig(precise=args.precise, integrator=args.integrator,
                           pm_grid=pm_grid, pm_softening=args.pm_softening,
                           p3m_rc_cells=args.p3m_rc_cells,
                           p3m_cell_capacity=args.p3m_cell_capacity,
                           p3m_exact_targets=args.p3m_exact_targets,
                           p3m_rebin_interval=args.p3m_rebin,
                           p3m_pp_chunk=args.p3m_pp_chunk,
                           merge_collisions=args.merge is not None,
                           merge_factor=(1.0 if args.merge is None
                                         else args.merge))
    if config.merge_collisions and getattr(args, "backend", None) == "p3m":
        # checked on the resolved config, so that a resumed merging
        # checkpoint is caught too, not only an explicit --merge
        sys.exit(f"{PROG}: error: merging is not supported with "
                 "--backend p3m (frozen cell blocks); use torch, cuda, or pm")
    if getattr(args, "shard", False):
        # every visible card; the CPU is one device
        from .parallel.sharding import ShardedWorld, make_mesh

        mesh = (make_mesh() if args.device.type == "cuda"
                else make_mesh(devices=[args.device]))
        backend = {"cuda": "cuda_ring"}.get(args.backend, args.backend)
        return ShardedWorld(particles, mesh, config=config,
                            force_backend=backend), start
    return (create_world(particles, config=config,
                         default_backend=args.backend, device=args.device),
            start)


def _resolve_dt(args, w) -> None:
    """``--dt auto``: the softening-resolution criterion
    (diagnostics.suggest_dt, eta=0.1) on the initial accelerations, which
    one dt = 0 substep stores without moving anything."""
    if args.dt != "auto":
        return
    from .diagnostics import suggest_dt

    w.update(0.0, 1)
    dt = float(suggest_dt(w.particles))
    # dt == 0.0 happens too: a zero-radius particle under nonzero force
    # has eps = sqrt(radius) = 0
    if not np.isfinite(dt) or dt <= 0.0:
        raise SystemExit("--dt auto: world has no resolvable orbital "
                         "timescale (force-free, or a zero-radius particle "
                         "under force); pass an explicit --dt")
    args.dt = dt
    print(f"dt auto -> {dt:.6g}", file=sys.stderr)


def cmd_run(args) -> None:
    if args.checkpoint_every < 0:
        raise SystemExit(f"--checkpoint-every must be >= 0, "
                         f"got {args.checkpoint_every}")
    if args.checkpoint_every and args.traj:
        print("warning: --checkpoint-every is ignored with --traj "
              "(trajectory capture runs as one capture loop)", file=sys.stderr)
    if args.adaptive is not None and args.adaptive <= 0:
        raise SystemExit(f"--adaptive T_SPAN must be > 0, "
                         f"got {args.adaptive}")
    w, start = _make_world(args)
    if args.adaptive is None:
        # --adaptive re-evaluates the criterion itself every substep, so
        # --dt auto there only means "the default dt ceiling"
        _resolve_dt(args, w)
    sharded = getattr(args, "shard", False)
    backend = (f"{w.force_backend} x{w.n_devices}dev" if sharded
               else w.default_backend)
    print(f"N={w.total_len} massive={w.mass_len} backend={backend}",
          file=sys.stderr)

    if args.adaptive is not None:
        if args.traj or args.checkpoint_every:
            raise SystemExit("--adaptive runs the whole span as one device "
                             "while_loop; it does not compose with --traj "
                             "or --checkpoint-every")
        dt_max = args.dt if isinstance(args.dt, float) else 1.0
        kwargs = {} if sharded else {"backend": args.backend}
        t0 = time.perf_counter()
        k = w.update_adaptive(args.adaptive, dt_max=dt_max, **kwargs)
        w.block_until_ready()
        dt_wall = time.perf_counter() - t0
        print(f"t_span={args.adaptive} in {k} adaptive substeps, "
              f"{dt_wall:.2f}s", file=sys.stderr)
        if args.save:
            save_world_atomic(args.save, w, step=start + k)
            print(f"saved {args.save}", file=sys.stderr)
        return

    def advance(k):
        if sharded:
            w.update(args.dt, k)
        else:
            w.update(args.dt, k, backend=args.backend)
    # a resumed run continues the checkpoint's step counter
    t0 = time.perf_counter()
    saved_at = None
    ran = args.steps  # substeps actually run (--traj may round down)
    if args.traj:
        from .trajectory import record_trajectory, save_trajectory

        spf = max(1, args.steps // max(1, args.frames))
        frames = args.steps // spf
        if sharded:
            traj = w.record(args.dt, frames, spf)
        else:
            traj = record_trajectory(w, args.dt, frames, spf,
                                     backend=args.backend)
        save_trajectory(args.traj, traj, dt=np.float32(args.dt),
                        steps_per_frame=np.int64(spf))
        print(f"wrote {traj.shape} trajectory to {args.traj}", file=sys.stderr)
        ran = frames * spf
    elif args.checkpoint_every and args.save:
        # preemption-safe long runs: an atomic checkpoint every K substeps
        done = 0
        while done < args.steps:
            k = min(args.checkpoint_every, args.steps - done)
            advance(k)
            w.block_until_ready()
            done += k
            save_world_atomic(args.save, w, step=start + done)
            saved_at = done
            print(f"checkpoint @ step {start + done} -> {args.save}",
                  file=sys.stderr)
    else:
        advance(args.steps)
        w.block_until_ready()
    dt_wall = time.perf_counter() - t0
    print(f"{args.steps} steps in {dt_wall:.2f}s "
          f"({args.steps / dt_wall:.1f} steps/s, "
          f"{w.total_len * w.mass_len * args.steps / dt_wall:.3e} pairs/s)",
          file=sys.stderr)
    if args.save and saved_at != args.steps:
        save_world_atomic(args.save, w, step=start + ran)
        print(f"checkpoint -> {args.save}", file=sys.stderr)


def cmd_render(args) -> None:
    particles, _ = load_particles(args.state)
    cam = fit_camera(particles.pos, args.width, args.height)
    img = render_frame(particles.to(args.device), cam)
    save_ppm(args.out, img)
    print(f"wrote {img.shape} -> {args.out}", file=sys.stderr)


def cmd_gif(args) -> None:
    w, _ = _make_world(args)
    _resolve_dt(args, w)
    export_animation(
        w, args.out, frames=args.frames, steps_per_frame=args.steps_per_frame,
        dt=args.dt, width=args.width, height=args.height, backend=args.backend)
    print(f"wrote {args.frames} frames -> {args.out}", file=sys.stderr)


def cmd_view(args) -> None:
    try:  # the viewer's own library: there is no switch to the other one
        __import__("pygame" if args.sdl else "matplotlib")
    except ImportError as e:
        sys.exit(f"{PROG}: error: view{' --sdl' if args.sdl else ''} needs "
                 f"{'pygame' if args.sdl else 'matplotlib'} ({e})")
    w, _ = _make_world(args)
    _resolve_dt(args, w)
    if args.sdl:
        from .viewer_sdl import SdlViewer

        SdlViewer(w, phys_step=args.dt,
                  video_driver=args.video_driver).run(max_frames=args.max_frames)
        return
    try:
        Viewer(w, phys_step=args.dt).run()
    except RuntimeError as e:  # no interactive matplotlib backend
        sys.exit(f"{PROG}: error: {e}")


def _device(platform: str | None) -> torch.device:
    """The device ``--platform`` names: "cuda" unless given. Without a
    card, "cuda" exits with an error: there is no fallback to the CPU."""
    try:
        device = torch.device(platform or "cuda")
    except RuntimeError:
        sys.exit(f"{PROG}: error: --platform must be 'cuda', 'cuda:N' or "
                 f"'cpu', got {platform!r}")
    if device.type not in ("cpu", "cuda"):
        sys.exit(f"{PROG}: error: --platform must be 'cuda', 'cuda:N' or "
                 f"'cpu', got {platform!r}")
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"{PROG}: error: no CUDA device "
                 "(torch.cuda.is_available() is False); pass --platform cpu "
                 "to run on the CPU")
    return device


_SUBCOMMANDS = ("run", "render", "gif", "view")


def _fix_bare_compile_cache(argv):
    """Let the bare form ``--compile-cache run ...`` parse.

    With ``nargs='?'`` argparse would take the subcommand's name as DIR;
    an explicit empty DIR is inserted where the next token is a
    subcommand or another option. ``--platform``'s value is skipped, so
    that ``--platform cpu --compile-cache run`` parses too."""
    argv = list(argv)
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok == "--compile-cache":
            nxt = argv[i + 1] if i + 1 < len(argv) else None
            if nxt is None or nxt in _SUBCOMMANDS or nxt.startswith("-"):
                argv.insert(i + 1, "")
            break
        if tok == "--platform":
            i += 2
            continue
        if tok in _SUBCOMMANDS:
            break  # the subcommand's own flags follow
        i += 1
    return argv


def _report_builds(cache: str) -> None:
    """One line on stderr: the libraries this process built in the cache
    and their nvcc seconds (none when it loaded them all)."""
    from .ops import _build
    from .utils.compile_cache import cache_entries

    built = ", ".join(f"{k} {s:.2f} s" for k, s in _build.BUILT.items())
    print(f"compile cache {cache}: {cache_entries(cache)} libraries; built "
          f"in this process: {built or 'none'}", file=sys.stderr)


def main(argv=None) -> None:
    if argv is None:
        argv = sys.argv[1:]
    argv = _fix_bare_compile_cache(argv)
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--compile-cache", nargs="?", const="", default=None,
                    metavar="DIR",
                    help="build and load the CUDA kernels' libraries in DIR "
                         "(bare flag: $NBODY_TPU_TORCH_CACHE_DIR or "
                         "~/.cache/nbody_tpu_torch/kernels), so that repeat "
                         "launches skip nvcc (utils.enable_compile_cache). A "
                         "DIR that collides with a subcommand name needs "
                         "--compile-cache=DIR")
    ap.add_argument("--platform", default=None, metavar="P",
                    help="the device: 'cuda' (default, the card), 'cuda:N' "
                         "or 'cpu'")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="headless simulation")
    _add_scene_args(p)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--adaptive", type=float, default=None, metavar="T_SPAN",
                   help="integrate a PHYSICAL time span with per-substep "
                        "adaptive dt instead of --steps fixed substeps "
                        "(World/ShardedWorld.update_adaptive; a numeric "
                        "--dt becomes the dt ceiling)")
    p.add_argument("--save", help="write final state checkpoint (.npz)")
    p.add_argument("--shard", action="store_true",
                   help="shard the run over every visible card "
                        "(ShardedWorld: cuda maps to the ring kernel, pm, "
                        "p3m and auto to the collective mesh solvers; a "
                        "1-device mesh on one card or on the CPU)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="with --save: atomically rewrite the checkpoint "
                        "every K substeps (crash/preemption-safe; resume "
                        "with --state <save>); 0 = only at the end")
    p.add_argument("--traj", help="record trajectory to .npz")
    p.add_argument("--frames", type=int, default=100, help="trajectory frame count")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("render", help="rasterize a saved state to .ppm")
    p.add_argument("--state", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("gif", help="headless animation (.gif through PIL, "
                                   "or raw frames to .npz)")
    _add_scene_args(p)
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--steps-per-frame", type=int, default=4)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.set_defaults(fn=cmd_gif)

    p = sub.add_parser("view", help="interactive viewer (needs a display, "
                                    "or --sdl --video-driver dummy)")
    _add_scene_args(p)
    p.add_argument("--sdl", action="store_true",
                   help="windowed pygame/SDL game loop instead of matplotlib")
    p.add_argument("--video-driver", default=None,
                   help="force an SDL video driver (e.g. 'dummy' for no "
                        "display)")
    p.add_argument("--max-frames", type=int, default=None,
                   help="stop the SDL loop after N frames")
    p.set_defaults(fn=cmd_view)

    args = ap.parse_args(argv)
    cache = None
    if args.compile_cache is not None:
        from .utils.compile_cache import enable_compile_cache

        cache = enable_compile_cache(args.compile_cache or None)
    args.device = _device(args.platform)
    args.fn(args)
    if cache is not None:
        _report_builds(cache)


if __name__ == "__main__":
    main()
