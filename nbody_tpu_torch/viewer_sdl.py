"""Windowed render loop on pygame/SDL, the raylib app's counterpart.
Counterpart of ``nbody_tpu/viewer_sdl.py``.

Where :class:`nbody_tpu_torch.viewer.Viewer` maps the reference's controls
onto matplotlib's callbacks, this runs a game loop like
``src/main.c:63-192``: a window, a frame clock targeting 100 FPS (one frame
a ``PHYS_STEP``, main.c:13), held keys polled each frame (raylib's
``IsKeyDown``, main.c:71-85), and a blit of the frame that
``render.render_frame`` rasterizes on the world's device: only the uint8
frame crosses to the host.

Controls (the reference's map, as in the matplotlib viewer):
  SPACE pause · TAB backend toggle · LEFT/RIGHT speed · UP/DOWN step mult
  O overlay · E physics panel · Q/ESC/close quit
  WASD pan (held) · wheel zoom to the pointer · middle-drag pan

Screen space is y-down (as raylib's): W pans the view up, i.e. the camera
target's y decreases (main.c:74-77). pygame is imported only where it is
used; ``video_driver="dummy"`` runs the loop with no display.
"""

from __future__ import annotations

import os
from dataclasses import replace

from .render import fit_camera, render_frame
from .viewer import (CAMERA_SPEED_DELTA, CAMERA_ZOOM_DELTA, PHYS_STEP,
                     ControlState)

TARGET_FPS = 100  # SetTargetFPS(100): one frame ~= one PHYS_STEP


class SdlViewer(ControlState):
    """The windowed game-loop viewer on pygame/SDL. The window is the
    reference's 1280x720 (main.c:37); ``video_driver`` forces an SDL video
    driver ("dummy" on a machine without a display)."""

    def __init__(self, world, phys_step: float = PHYS_STEP,
                 width: int = 1280, height: int = 720, fps: int = TARGET_FPS,
                 video_driver: str | None = None):
        super().__init__(world, phys_step)
        self.fps = fps
        self.camera = fit_camera(world.particles.pos, width, height)
        self.video_driver = video_driver
        self._dragging = False
        self._font_cache = None
        self.frames_drawn = 0

    # -- camera (render.Camera is frozen; every op replaces it) -----------
    def pan_world(self, dx: float, dy: float) -> None:
        self.camera = replace(self.camera,
                              center_x=self.camera.center_x + dx,
                              center_y=self.camera.center_y + dy)

    def zoom_at(self, px: float, py: float, factor: float) -> None:
        """Zoom about window pixel (px, py): the world point under the
        pointer stays under it (main.c:104-110)."""
        cam = self.camera
        # the world point under the pixel (render.rasterize's map inverted)
        wx = cam.center_x + (px - cam.width / 2.0) / cam.zoom
        wy = cam.center_y + (py - cam.height / 2.0) / cam.zoom
        z = cam.zoom * factor
        self.camera = replace(cam, zoom=z,
                              center_x=wx - (px - cam.width / 2.0) / z,
                              center_y=wy - (py - cam.height / 2.0) / z)

    # -- events ------------------------------------------------------------
    def handle_event(self, ev) -> bool:
        """Process one pygame event; returns False when the loop should
        end."""
        import pygame

        if ev.type == pygame.QUIT:
            return False
        if ev.type == pygame.KEYDOWN:
            k = ev.key
            if k in (pygame.K_q, pygame.K_ESCAPE):
                return False
            if k == pygame.K_SPACE:
                self.cmd_pause()
            elif k == pygame.K_TAB:
                self.cmd_toggle_backend()
            elif k == pygame.K_LEFT:
                self.cmd_speed(-1)
            elif k == pygame.K_RIGHT:
                self.cmd_speed(+1)
            elif k == pygame.K_DOWN:
                self.cmd_step(-1)
            elif k == pygame.K_UP:
                self.cmd_step(+1)
            elif k == pygame.K_o:
                self.cmd_overlay()
            elif k == pygame.K_e:
                self.cmd_diagnostics()
        elif ev.type == pygame.MOUSEWHEEL and ev.y != 0:
            factor = (1.0 + CAMERA_ZOOM_DELTA if ev.y > 0
                      else 1.0 - CAMERA_ZOOM_DELTA)
            mx, my = pygame.mouse.get_pos()
            self.zoom_at(mx, my, factor)
        elif ev.type == pygame.MOUSEBUTTONDOWN and ev.button == 2:
            self._dragging = True
        elif ev.type == pygame.MOUSEBUTTONUP and ev.button == 2:
            self._dragging = False
        elif ev.type == pygame.MOUSEMOTION and self._dragging:
            # target -= pixel_delta / zoom (main.c:97-101)
            self.pan_world(-ev.rel[0] / self.camera.zoom,
                           -ev.rel[1] / self.camera.zoom)
        return True

    def poll_held_keys(self, pressed, frame_time: float) -> None:
        """raylib's held-key pan (main.c:71-85): CAMERA_SPEED_DELTA/zoom
        world units per second of held key; W pans the view up (y-down)."""
        import pygame

        d = CAMERA_SPEED_DELTA / self.camera.zoom * frame_time
        dx = d * (pressed[pygame.K_d] - pressed[pygame.K_a])
        dy = d * (pressed[pygame.K_s] - pressed[pygame.K_w])
        if dx or dy:
            self.pan_world(dx, dy)

    # -- drawing -----------------------------------------------------------
    def frame(self):
        """The (H, W, 3) uint8 frame of the world's state, rasterized on
        its device."""
        return render_frame(self.world.state.slice_to(self.world.total_len),
                            self.camera)

    def draw(self, screen, fps: float) -> None:
        import pygame

        # render_frame is (H, W, 3); surfarray wants (W, H, 3)
        pygame.surfarray.blit_array(screen, self.frame().transpose(1, 0, 2))
        if self.overlay:
            font = self._font()
            y = 4
            for line in self.overlay_text(fps).splitlines():
                screen.blit(font.render(line, True, (0, 255, 0)), (6, y))
                y += font.get_linesize()

    def _font(self):
        import pygame

        if not pygame.font.get_init():
            pygame.font.init()
            self._font_cache = None  # fonts die with pygame.font.quit()
        if self._font_cache is None:
            self._font_cache = pygame.font.Font(None, 22)
        return self._font_cache

    # -- the loop ----------------------------------------------------------
    def run(self, max_frames: int | None = None) -> None:
        """Run the windowed loop until quit (or ``max_frames`` frames)."""
        saved_driver = os.environ.get("SDL_VIDEODRIVER")
        if self.video_driver is not None:
            os.environ["SDL_VIDEODRIVER"] = self.video_driver
        import pygame

        pygame.init()
        try:
            screen = pygame.display.set_mode((self.camera.width,
                                              self.camera.height))
            pygame.display.set_caption("nbody-tpu (PyTorch)")
            clock = pygame.time.Clock()
            running = True
            while running and (max_frames is None
                               or self.frames_drawn < max_frames):
                frame_time = clock.tick(self.fps) / 1000.0
                for ev in pygame.event.get():
                    running = self.handle_event(ev) and running
                self.poll_held_keys(pygame.key.get_pressed(), frame_time)
                self.advance(frame_time if self.frames_drawn else 0.0)
                self.draw(screen, clock.get_fps())
                pygame.display.flip()
                self.frames_drawn += 1
        finally:
            pygame.quit()
            # SDL reads the variable at init: do not leak a "dummy" driver
            # into a later viewer of the same process
            if self.video_driver is not None:
                if saved_driver is None:
                    os.environ.pop("SDL_VIDEODRIVER", None)
                else:
                    os.environ["SDL_VIDEODRIVER"] = saved_driver
