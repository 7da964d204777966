"""Interactive viewer (matplotlib) and headless animation export.
Counterpart of ``nbody_tpu/viewer.py``, with the reference raylib app's
control semantics (``src/main.c``):

  SPACE  pause/unpause                 (main.c:129-137)
  TAB    toggle "torch" and the world's fast backend (main.c:112-116)
  LEFT/RIGHT  sim speed /2, x2          (SPEEDS, main.c:25)
  UP/DOWN     step multiplier           (STEPS, main.c:26)
  Q      quit                           (main.c:64)
  O      toggle overlay                 (ALT in the reference, main.c:65-67)
  E      physics panel                  (energy/momentum/L/dt*)
  W/A/S/D     pan the camera            (main.c:71-85)
  wheel       zoom to the pointer       (main.c:88-94, 104-110)
  middle-drag pan                       (main.c:97-101)

The camera follows main.c:71-110: WASD pans CAMERA_SPEED_DELTA/zoom world
units per second (here per key-repeat event at a nominal event rate), the
wheel multiplies zoom by 1 +- CAMERA_ZOOM_DELTA about the pointer. Each
drawn frame advances the world by the fixed-timestep accumulator with its
frame-skip guard (main.c:140-163): SPEED substeps of PHYS_STEP*step_mult a
tick, capped at MAX_OVERWORK*speed. The substeps run on the world's device
through ``World.update``; on "cuda" each is one launch of the fused
direct-sum kernel. matplotlib is imported only in :meth:`Viewer.run`.

:func:`export_animation` simulates and rasterizes on the world's device;
only the uint8 frames reach the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .render import (BG_COLOR, CC_COLOR, EP_COLOR, NP_COLOR, Camera,
                     fit_camera, rasterize)
from .types import DEFAULT_GALAXY_CONFIG, DTYPE

# The reference's timing constants (main.c:13-15, 25-33).
PHYS_STEP = 0.01
MAX_OVERWORK = 3
SPEEDS = [1, 2, 4, 8, 16, 32, 64, 128]
STEPS = [0.1, 0.25, 0.5, 1.0, 2.0, 4.0]
DEF_STEP_IDX = 3

# The reference's camera constants (main.c:17-18).
CAMERA_SPEED_DELTA = 800.0  # px/s of pan at 1x zoom
CAMERA_ZOOM_DELTA = 0.1     # zoom factor change per wheel notch
# matplotlib delivers key-repeat events rather than per-frame key polling;
# one event is treated as 1/NOMINAL_KEY_FPS seconds of held key
NOMINAL_KEY_FPS = 30.0

# Above this many pairs (total_len * mass_len) the physics panel estimates
# the potential on the mesh instead of summing it exactly.
EXACT_PE_PAIRS = 64_000_000

# matplotlib backends that draw no window
_NON_INTERACTIVE = ("agg", "pdf", "svg", "ps", "pgf", "template", "cairo")


def _rgb(c):
    return tuple(v / 255.0 for v in c)


def device_name(device: torch.device) -> str:
    """What the overlay calls the world's device: the card's name, or
    "CPU"."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "CPU"


class ControlState:
    """Front-end-agnostic control state: pause, backend, speed and step
    toggles and the fixed-timestep accumulator (main.c:58-60, 129-163).
    Shared by the matplotlib :class:`Viewer` and the SDL loop
    (:class:`nbody_tpu_torch.viewer_sdl.SdlViewer`); a front-end maps its
    events onto the ``cmd_*`` methods."""

    def __init__(self, world, phys_step: float = PHYS_STEP):
        self.world = world
        self.phys_step = phys_step
        self.pause = False
        self.overlay = True
        self.diagnostics = False  # E key: the physics panel (opt-in)
        # TAB toggles "torch" and the world's fast backend ("cuda", "pm" or
        # "p3m"), keeping the world's default
        self.accel_backend = (world.default_backend
                              if world.default_backend != "torch" else "cuda")
        self.use_gpu = world.default_backend != "torch"
        self.speed_idx = 0
        self.step_idx = DEF_STEP_IDX
        # the fixed-timestep accumulator (main.c:58-60, 140-163)
        self.phys_time = 0.0
        self.skipped_frames = 0
        self._last_t: float | None = None
        self._diag_next = 0.0
        self._diag_text = ""

    # -- control semantics (main.c:112-137) ------------------------------
    def cmd_pause(self) -> None:
        self.pause = not self.pause
        # pausing resets the accumulator (main.c:129-137)
        self.phys_time = 0.0
        self.skipped_frames = 0

    def cmd_toggle_backend(self) -> None:
        self.use_gpu = not self.use_gpu
        self.phys_time = 0.0
        self.skipped_frames = 0

    def cmd_speed(self, delta: int) -> None:
        self.speed_idx = min(max(self.speed_idx + delta, 0), len(SPEEDS) - 1)

    def cmd_step(self, delta: int) -> None:
        self.step_idx = min(max(self.step_idx + delta, 0), len(STEPS) - 1)

    def cmd_overlay(self) -> None:
        self.overlay = not self.overlay

    def cmd_diagnostics(self) -> None:
        """Toggle the physics panel (E key): energy, momentum, angular
        momentum and the suggested dt under the overlay. Opt-in because the
        exact potential is O(N·M); above EXACT_PE_PAIRS pairs the panel
        takes the mesh estimate (``diagnostics.potential_energy_pm``).
        Values refresh at most every 0.5 s of wall time."""
        self.diagnostics = not self.diagnostics
        self._diag_next = 0.0

    def diag_text(self) -> str:
        now = time.perf_counter()
        if now >= self._diag_next:
            from .diagnostics import (angular_momentum, kinetic_energy,
                                      potential_energy, potential_energy_pm,
                                      suggest_dt, total_momentum)

            w = self.world
            cfg = w.config
            st = w.state.slice_to(w.total_len)
            ke = float(kinetic_energy(st))
            if w.total_len * w.mass_len <= EXACT_PE_PAIRS:
                pe = float(potential_energy(st, w.mass_len, g=cfg.g))
                tag = ""
            else:
                # the world's own mesh and softening, so the panel measures
                # drift in the model the forces integrate
                pe = float(potential_energy_pm(
                    st, w.mass_len, grid=cfg.pm_grid,
                    softening=cfg.pm_softening, g=cfg.g))
                tag = " (mesh est.)"
            px, py = (float(x) for x in total_momentum(st))
            self._diag_text = (
                f"E = {ke + pe:.4e}{tag}  (K {ke:.3e} / U {pe:.3e})\n"
                f"|P| = {np.hypot(px, py):.3e}  L = "
                f"{float(angular_momentum(st)):.3e}\n"
                f"dt* = {float(suggest_dt(st)):.2e}"
            )
            self._diag_next = now + 0.5
        return self._diag_text

    def _colors(self, mass: np.ndarray) -> np.ndarray:
        min_core = DEFAULT_GALAXY_CONFIG.min_gc_mass
        out = np.empty((len(mass), 3))
        out[:] = _rgb(NP_COLOR)
        out[mass <= 0] = _rgb(EP_COLOR)
        out[mass >= min_core] = _rgb(CC_COLOR)
        return out

    def overlay_text(self, fps: float) -> str:
        mode = (f"{self.accel_backend} ({device_name(self.world.device)})"
                if self.use_gpu else "torch")
        state = " (paused)" if self.pause else ""
        warn = "\nSKIPPING FRAMES" if self.skipped_frames > MAX_OVERWORK else ""
        diag = "\n" + self.diag_text() if self.diagnostics else ""
        return (
            f"{mode} simulation{state}\n"
            f"step x{STEPS[self.step_idx]:.2f}  speed x{SPEEDS[self.speed_idx]}\n"
            f"{fps:.0f} FPS"
            f"{warn}"
            f"{diag}"
        )

    def advance(self, frame_time: float | None = None) -> None:
        """Advance the world by the accumulator rule (main.c:140-163): bank
        speed*frame_time seconds, run floor(banked/PHYS_STEP) substeps of
        size PHYS_STEP*step_mult, capped at MAX_OVERWORK*speed (the excess
        dropped and counted as a skipped frame). ``frame_time`` None is the
        wall time since the last call; 0 (the first frame) banks one
        tick."""
        if self.pause:
            return
        now = time.perf_counter()
        if frame_time is None:
            frame_time = 0.0 if self._last_t is None else now - self._last_t
        self._last_t = now

        speed = SPEEDS[self.speed_idx]
        if frame_time == 0.0:
            self.phys_time += speed * self.phys_step
        else:
            self.phys_time += speed * frame_time
        max_overwork = speed * self.phys_step * MAX_OVERWORK
        if self.phys_time > max_overwork:
            self.phys_time = max_overwork
            self.skipped_frames += 1
        else:
            self.skipped_frames = 0

        updates = int(self.phys_time // self.phys_step)
        self.phys_time -= updates * self.phys_step
        if updates == 0:
            return
        step = self.phys_step * STEPS[self.step_idx]
        backend = self.accel_backend if self.use_gpu else "torch"
        self.world.update(step, updates, backend=backend)


class Viewer(ControlState):
    """The matplotlib viewer. Needs an interactive matplotlib backend; for
    a machine without a display use :func:`export_animation`, for a game
    loop :class:`nbody_tpu_torch.viewer_sdl.SdlViewer`."""

    def __init__(self, world, phys_step: float = PHYS_STEP):
        super().__init__(world, phys_step)
        self.ax = None
        self._drag_px: tuple[float, float] | None = None

    def on_key(self, event) -> None:
        k = (event.key or "").lower()
        if k == " ":
            self.cmd_pause()
        elif k == "tab":
            self.cmd_toggle_backend()
        elif k == "left":
            self.cmd_speed(-1)
        elif k == "right":
            self.cmd_speed(+1)
        elif k == "down":
            self.cmd_step(-1)
        elif k == "up":
            self.cmd_step(+1)
        elif k == "o":
            self.cmd_overlay()
        elif k == "e":
            self.cmd_diagnostics()
        elif k in ("w", "a", "s", "d"):
            self.pan_key(k)
        elif k == "q":
            # quit (main.c:64): closing every figure ends plt.show()
            import matplotlib.pyplot as plt

            plt.close("all")

    # -- camera (main.c:71-110 on matplotlib's view limits) ---------------
    def zoom(self) -> float:
        """Pixels per world unit of the attached axes (raylib's
        camera.zoom)."""
        if self.ax is None:
            return 1.0
        x0, x1 = self.ax.get_xlim()
        width_px = self.ax.get_window_extent().width or 1.0
        return float(width_px / max(x1 - x0, 1e-12))

    def pan_key(self, k: str) -> None:
        """WASD pan: CAMERA_SPEED_DELTA / zoom world units per second of
        held key (main.c:71-85), one key-repeat event = 1/NOMINAL_KEY_FPS s.
        W pans the view up."""
        if self.ax is None:
            return
        d = CAMERA_SPEED_DELTA / (self.zoom() * NOMINAL_KEY_FPS)
        dx = {"a": -d, "d": d}.get(k, 0.0)
        dy = {"s": -d, "w": d}.get(k, 0.0)
        x0, x1 = self.ax.get_xlim()
        y0, y1 = self.ax.get_ylim()
        self.ax.set_xlim(x0 + dx, x1 + dx)
        self.ax.set_ylim(y0 + dy, y1 + dy)

    def on_scroll(self, event) -> None:
        """Wheel zoom about the pointer (main.c:88-94, 104-110): zoom *=
        1 +- CAMERA_ZOOM_DELTA, the world point under the pointer stays
        under it."""
        if self.ax is None or event.xdata is None or event.ydata is None:
            return
        if event.step > 0:
            factor = 1.0 + CAMERA_ZOOM_DELTA   # zoom in: the span shrinks
        elif event.step < 0:
            factor = 1.0 - CAMERA_ZOOM_DELTA
        else:
            return
        px, py = event.xdata, event.ydata
        x0, x1 = self.ax.get_xlim()
        y0, y1 = self.ax.get_ylim()
        self.ax.set_xlim(px - (px - x0) / factor, px + (x1 - px) / factor)
        self.ax.set_ylim(py - (py - y0) / factor, py + (y1 - py) / factor)

    def on_press(self, event) -> None:
        if getattr(event, "button", None) == 2:  # middle (main.c:97)
            self._drag_px = (event.x, event.y)

    def on_release(self, event) -> None:
        if getattr(event, "button", None) == 2:
            self._drag_px = None

    def on_motion(self, event) -> None:
        """Middle-drag pan: target -= pixel_delta / zoom (main.c:97-101)."""
        if self.ax is None or self._drag_px is None:
            return
        z = self.zoom()
        dx = (event.x - self._drag_px[0]) / z
        dy = (event.y - self._drag_px[1]) / z
        self._drag_px = (event.x, event.y)
        x0, x1 = self.ax.get_xlim()
        y0, y1 = self.ax.get_ylim()
        self.ax.set_xlim(x0 - dx, x1 - dx)
        self.ax.set_ylim(y0 - dy, y1 - dy)

    def attach(self, fig, ax) -> None:
        """Wire the control handlers to a figure and its axes."""
        self.ax = ax
        fig.canvas.mpl_connect("key_press_event", self.on_key)
        fig.canvas.mpl_connect("scroll_event", self.on_scroll)
        fig.canvas.mpl_connect("button_press_event", self.on_press)
        fig.canvas.mpl_connect("button_release_event", self.on_release)
        fig.canvas.mpl_connect("motion_notify_event", self.on_motion)

    def run(self, interval_ms: int = 10):
        """Open the window and animate until it closes. Raises RuntimeError
        where matplotlib has no interactive backend."""
        import matplotlib
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation

        backend = matplotlib.get_backend().lower()
        if any(b in backend for b in _NON_INTERACTIVE):
            raise RuntimeError(
                f"no interactive matplotlib backend (got {backend!r}; no "
                "display?): use `python -m nbody_tpu_torch gif`, "
                "nbody_tpu_torch.viewer.export_animation, or `view --sdl`")

        host = self.world.particles
        fig, ax = plt.subplots(figsize=(12.8, 7.2))
        fig.patch.set_facecolor(_rgb(BG_COLOR))
        ax.set_facecolor(_rgb(BG_COLOR))
        ax.set_aspect("equal")
        pos = host.pos.numpy()
        scat = ax.scatter(pos[:, 0], pos[:, 1], s=1.5,
                          c=self._colors(host.mass.numpy()))
        pad = 0.05 * (pos.max(0) - pos.min(0) + 1)
        ax.set_xlim(pos[:, 0].min() - pad[0], pos[:, 0].max() + pad[0])
        ax.set_ylim(pos[:, 1].min() - pad[1], pos[:, 1].max() + pad[1])
        text = ax.text(0.01, 0.99, "", transform=ax.transAxes, va="top",
                       color="lime", family="monospace")
        self.attach(fig, ax)

        fps_state = {"t": time.perf_counter(), "frames": 0, "fps": 0.0}

        def frame(_):
            self.advance()
            scat.set_offsets(self.world.particles.pos.numpy())
            fps_state["frames"] += 1
            now = time.perf_counter()
            if now - fps_state["t"] >= 0.5:
                fps_state["fps"] = fps_state["frames"] / (now - fps_state["t"])
                fps_state["t"] = now
                fps_state["frames"] = 0
            text.set_text(self.overlay_text(fps_state["fps"])
                          if self.overlay else "")
            return scat, text

        anim = FuncAnimation(fig, frame, interval=interval_ms,
                             cache_frame_data=False)
        plt.show()
        return anim


def export_animation(world, path: str, frames: int = 100,
                     steps_per_frame: int = 4, dt: float = PHYS_STEP,
                     width: int = 640, height: int = 360,
                     camera: Camera | None = None, backend: str | None = None,
                     fps: int = 25) -> None:
    """Simulate and rasterize on the world's device, frame by frame; the
    uint8 frames are stacked there and read back once. ``path`` ending in
    .npz saves the raw frames (``frames``: (F, H, W, 3) uint8); any other
    path writes an animated GIF through PIL, imported only then."""
    if camera is None:
        camera = fit_camera(world.particles.pos, width, height)
    device = world.state.pos.device
    center = torch.tensor([camera.center_x, camera.center_y], dtype=DTYPE,
                          device=device)
    zoom = torch.tensor(camera.zoom, dtype=DTYPE, device=device)
    images = []
    for _ in range(frames):
        world.update(dt, steps_per_frame, backend=backend)
        st = world.state.slice_to(world.total_len)
        images.append(rasterize(st.pos, st.radius, st.mass, center, zoom,
                                width=camera.width, height=camera.height))
    arr = torch.stack(images).cpu().numpy()
    if path.endswith(".npz"):
        np.savez_compressed(path, frames=arr)
        return
    from PIL import Image

    pil = [Image.fromarray(im) for im in arr]
    pil[0].save(path, save_all=True, append_images=pil[1:],
                duration=int(1000 / fps), loop=0)
