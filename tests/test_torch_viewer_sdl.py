"""The port's SDL game loop (nbody_tpu_torch/viewer_sdl.py) under SDL's
"dummy" video driver: the loop runs, advances the world and blits the
frame that ``render.render_frame`` rasterizes on the world's device, byte
for byte; its camera follows nbody_tpu's SdlViewer exactly on the same
events; and the CLI's ``view --sdl`` runs a few frames."""

import os
from dataclasses import astuple

os.environ["SDL_VIDEODRIVER"] = "dummy"

import jax  # noqa: F401,E402  (tests/conftest.py pins it to the CPU)
import numpy as np  # noqa: E402
import pytest  # noqa: E402

pygame = pytest.importorskip("pygame")

import nbody_tpu as nb  # noqa: E402
import nbody_tpu.viewer_sdl as jsdl  # noqa: E402
import nbody_tpu_torch as nt  # noqa: E402
from nbody_tpu_torch import app  # noqa: E402
from nbody_tpu_torch.render import render_frame  # noqa: E402
from nbody_tpu_torch.viewer import SPEEDS, STEPS  # noqa: E402
from nbody_tpu_torch.viewer_sdl import SdlViewer  # noqa: E402

W, H = 320, 180


def _world():
    return nt.create_world(nt.make_galaxies(200, 1, seed=6), device="cpu")


def make_sdl_viewer(cls=SdlViewer, **kw):
    return cls(_world(), video_driver="dummy", width=W, height=H, **kw)


def post(ev_type, **kw):
    # posting needs the video subsystem up; run() re-inits and reads them
    if not pygame.display.get_init():
        pygame.display.init()
    pygame.event.post(pygame.event.Event(ev_type, **kw))


def test_loop_blits_render_frame_byte_for_byte():
    """Each drawn frame (overlay off) is render_frame of the world's state
    after that frame's advance, byte for byte on the window surface; the
    loop advances the world."""
    shots = []

    class Capturing(SdlViewer):
        def draw(self, screen, fps):
            super().draw(screen, fps)
            want = render_frame(self.world.state.slice_to(
                self.world.total_len), self.camera)
            shots.append((pygame.surfarray.array3d(screen).copy(), want))

    v = make_sdl_viewer(Capturing, fps=250)
    v.cmd_overlay()
    before = v.world.particles.pos.clone()
    v.run(max_frames=4)
    assert v.frames_drawn == 4 and len(shots) == 4
    for got, want in shots:
        assert got.shape == (W, H, 3)
        np.testing.assert_array_equal(got, want.transpose(1, 0, 2))
    assert not np.array_equal(v.world.particles.pos.numpy(), before.numpy())
    assert (shots[-1][1] != shots[-1][1][0, 0]).any()


def test_posted_events_drive_the_controls():
    """Real SDL events through the loop's event queue flip the controls as
    in nbody_tpu's SdlViewer."""
    v = make_sdl_viewer()
    for k in (pygame.K_SPACE, pygame.K_TAB, pygame.K_RIGHT, pygame.K_RIGHT,
              pygame.K_UP, pygame.K_o, pygame.K_e):
        post(pygame.KEYDOWN, key=k)
    before = v.world.particles.pos.clone()
    v.run(max_frames=2)
    assert v.pause is True and v.use_gpu is True
    assert SPEEDS[v.speed_idx] == 4 and STEPS[v.step_idx] == STEPS[4]
    assert v.overlay is False
    assert v.diagnostics is True and "E = " in v.diag_text()
    # paused from the first frame: nothing moved
    np.testing.assert_array_equal(v.world.particles.pos.numpy(),
                                  before.numpy())


def test_quit_key_ends_the_loop():
    v = make_sdl_viewer()
    post(pygame.KEYDOWN, key=pygame.K_ESCAPE)
    v.run(max_frames=100)
    assert v.frames_drawn <= 1


def test_camera_matches_nbody_tpu():
    """The same zooms, held keys and middle-drag events give the same
    camera in both packages: fit_camera of the same positions, then host
    float math, exactly."""
    jw = nb.create_world(nb.make_galaxies(200, 1, seed=6),
                         default_backend="jnp")
    a = jsdl.SdlViewer(jw, video_driver="dummy", width=W, height=H)
    b = make_sdl_viewer()
    start = astuple(b.camera)
    assert astuple(a.camera) == start

    class Held(dict):
        def __init__(self, keys):
            super().__init__()
            self.keys = keys

        def __getitem__(self, k):
            return int(k in self.keys)

    pygame.display.init()
    try:
        for v in (a, b):
            v.zoom_at(70.0, 120.0, 1.1)
            v.poll_held_keys(Held({pygame.K_d, pygame.K_w}), 0.05)
            v.zoom_at(10.0, 3.0, 0.9)
            v.handle_event(pygame.event.Event(pygame.MOUSEBUTTONDOWN, button=2,
                                              pos=(100, 100)))
            v.handle_event(pygame.event.Event(pygame.MOUSEMOTION, rel=(10, -4),
                                              pos=(110, 96), buttons=(0, 1, 0)))
            v.handle_event(pygame.event.Event(pygame.MOUSEBUTTONUP, button=2,
                                              pos=(110, 96)))
            v.handle_event(pygame.event.Event(pygame.MOUSEMOTION, rel=(50, 50),
                                              pos=(160, 146), buttons=(0, 0, 0)))
            v.poll_held_keys(Held({pygame.K_a, pygame.K_s}), 0.011)
    finally:
        pygame.display.quit()
    assert astuple(a.camera) == astuple(b.camera)
    assert astuple(b.camera) != start


def test_view_cli_runs_the_sdl_loop(capsys):
    """``python -m nbody_tpu_torch --platform cpu view --sdl --max-frames
    3`` runs the loop on the CPU and returns."""
    app.main(["--platform", "cpu", "view", "--sdl", "--video-driver", "dummy",
              "--max-frames", "3", "--n", "200", "--galaxies", "1"])
