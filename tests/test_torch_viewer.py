"""The port's viewer (nbody_tpu_torch/viewer.py) against nbody_tpu's: the
same frame times and key and mouse events through both ControlStates and
Viewers give the same substep counts and control state, and the same
camera limits (host float math, exact); the state after ``advance``
within the World tolerance; the overlay's lines equal apart from the
backend and device names; the physics panel's energy the port's
``diagnostics.total_energy``. No display is needed: matplotlib's Agg
backend takes the camera's events, and ``Viewer.run`` refuses it."""

import ast
import re
import sys
import types
from pathlib import Path

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import numpy as np
import pytest
from torch_helpers import rel_err

import nbody_tpu as nb
import nbody_tpu.viewer as jv
import nbody_tpu_torch as nt
import nbody_tpu_torch.viewer as tv
from nbody_tpu_torch import app, diagnostics

ROOT = Path(__file__).resolve().parent.parent
# tests/test_torch_world.py:142
WORLD_TOL = {"pos": 1e-6, "vel": 2e-6, "acc": 5e-6}
# the port's backend names for nbody_tpu's
NAMES = {"jnp": "torch", "pallas": "cuda", "pm": "pm", "p3m": "p3m"}

# (event, frame time): a key, or None, then one advance of that frame time
SCRIPT = [(None, 0.0), ("right", 0.004), ("right", 0.011), (None, 0.0167),
          ("up", 10.0), (None, 0.01), ("down", 0.0333), ("down", 0.02),
          (" ", 0.5), (" ", 0.003), ("tab", 0.09), ("left", 0.07),
          ("tab", 0.0), ("down", 0.013), ("down", 0.041), ("right", 3.0),
          (None, 0.0049), ("up", 0.025)]


def _worlds(n=200, backend=("jnp", "torch")):
    jw = nb.create_world(nb.make_galaxies(n, 1, seed=6),
                         default_backend=backend[0])
    tw = nt.create_world(nt.make_galaxies(n, 1, seed=6),
                         default_backend=backend[1], device="cpu")
    return jw, tw


def key(name):
    return types.SimpleNamespace(key=name)


def _recorded(world):
    """Record the world's update calls instead of running them."""
    calls = []

    def update(dt, n=1, backend=None, **kw):
        calls.append((dt, n, backend))
        return world
    world.update = update
    return calls


def _control(v):
    return (v.pause, v.use_gpu, v.speed_idx, v.step_idx, v.skipped_frames,
            v.phys_time, v.overlay)


@pytest.mark.parametrize("backends", [("jnp", "torch"), ("pm", "pm"),
                                      ("pallas", "cuda")])
def test_controls_and_substeps_match(backends):
    """The scripted keys and frame times give the same substep calls (dt,
    count, backend under the port's name) and the same control state after
    every frame, TAB toggling the world's fast backend and "torch"."""
    jw, tw = _worlds(backend=backends)
    if backends[1] == "cuda":  # a card World's backends, on CPU tensors
        tw.default_backend = "cuda"
    jc, tc = _recorded(jw), _recorded(tw)
    a, b = jv.Viewer(jw), tv.Viewer(tw)
    assert b.accel_backend == NAMES[a.accel_backend]
    for event, frame_time in SCRIPT:
        if event is not None:
            a.on_key(key(event))
            b.on_key(key(event))
        a.advance(frame_time)
        b.advance(frame_time)
        assert _control(a) == _control(b), event
    assert [(dt, n, NAMES[x]) for dt, n, x in jc] == tc
    assert sum(n for _, n, _ in tc) > len(SCRIPT)
    assert {x for *_, x in tc} == {"torch", NAMES[a.accel_backend]}


def test_advance_state_matches_nbody_tpu():
    """The substeps advance runs: the port's World on "torch" against
    nbody_tpu's on "jnp" after the same frames."""
    jw, tw = _worlds()
    a, b = jv.ControlState(jw), tv.ControlState(tw)
    for c in (a, b):
        c.cmd_speed(+2)  # 4 substeps a tick
    for frame_time in (0.0, 0.013, 0.021, 10.0):
        a.advance(frame_time)
        b.advance(frame_time)
    got, want = tw.particles, jw.particles
    for name, tol in WORLD_TOL.items():
        err = rel_err(getattr(got, name), np.asarray(getattr(want, name)))
        assert err < tol, (name, err)


def test_paused_advance_runs_nothing():
    _, tw = _worlds()
    calls = _recorded(tw)
    c = tv.ControlState(tw)
    c.cmd_pause()
    for frame_time in (0.0, 0.5, 10.0):
        c.advance(frame_time)
    assert calls == [] and c.phys_time == 0.0


def _attached(viewer_module, world):
    import matplotlib
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    v = viewer_module.Viewer(world)
    fig, ax = plt.subplots(figsize=(8, 6), dpi=100)
    ax.set_xlim(-100.0, 100.0)
    ax.set_ylim(-75.0, 75.0)
    fig.canvas.draw()  # realize the window extent for zoom()
    v.attach(fig, ax)
    return v, fig, ax


def test_camera_math_matches_nbody_tpu():
    """WASD pans, wheel zoom about the pointer and middle-drag give the
    same view limits in both packages, exactly."""
    import matplotlib.pyplot as plt

    jw, tw = _worlds()
    (a, fa, xa), (b, fb, xb) = _attached(jv, jw), _attached(tv, tw)
    ns = types.SimpleNamespace
    events = [("key", key("d")), ("key", key("w")), ("key", key("w")),
              ("scroll", ns(step=1, xdata=40.0, ydata=-30.0)),
              ("key", key("a")),
              ("scroll", ns(step=-1, xdata=-12.5, ydata=7.0)),
              ("scroll", ns(step=0, xdata=1.0, ydata=1.0)),
              ("press", ns(button=2, x=400.0, y=300.0)),
              ("motion", ns(x=410.0, y=296.0)),
              ("motion", ns(x=371.0, y=333.0)),
              ("release", ns(button=2)),
              ("motion", ns(x=500.0, y=300.0)),
              ("press", ns(button=1, x=0.0, y=0.0)),
              ("motion", ns(x=50.0, y=0.0)), ("key", key("s"))]
    try:
        for kind, ev in events:
            getattr(a, f"on_{kind}")(ev)
            getattr(b, f"on_{kind}")(ev)
            assert xa.get_xlim() == xb.get_xlim(), (kind, ev)
            assert xa.get_ylim() == xb.get_ylim(), (kind, ev)
        assert a.zoom() == b.zoom()
    finally:
        plt.close(fa)
        plt.close(fb)


def _normalized(text, names):
    first, *rest = text.splitlines()
    for name in names:
        first = first.replace(name, "<backend>")
    return [first] + rest


def test_overlay_lines_match_but_for_backend_and_device():
    """The overlay's lines in both packages, with nbody_tpu's "pallas
    (TPU)" / "jnp" and the port's "cuda (CPU)" / "torch" as the only
    difference; the port names the world's device."""
    jw, tw = _worlds()
    _recorded(jw), _recorded(tw)
    a, b = jv.ControlState(jw), tv.ControlState(tw)
    assert b.overlay_text(60.0).splitlines()[0] == "torch simulation"
    jnames, tnames = ("pallas (TPU)", "jnp"), ("cuda (CPU)", "torch")
    for cmd in ("cmd_toggle_backend", "cmd_pause", "cmd_speed", "cmd_step",
                "cmd_pause", "cmd_toggle_backend"):
        for c in (a, b):
            method = getattr(c, cmd)
            method(+1) if cmd in ("cmd_speed", "cmd_step") else method()
        for fps in (0.0, 59.6, 143.2):
            assert _normalized(a.overlay_text(fps), jnames) == \
                _normalized(b.overlay_text(fps), tnames)
    for c in (a, b):  # a saturated accumulator warns
        for _ in range(tv.MAX_OVERWORK + 1):
            c.advance(10.0)
    assert "SKIPPING FRAMES" in b.overlay_text(1.0)
    assert _normalized(a.overlay_text(1.0), jnames) == \
        _normalized(b.overlay_text(1.0), tnames)
    b.cmd_toggle_backend()
    assert b.overlay_text(1.0).startswith("cuda (CPU) simulation")


def _panel(text):
    return {k: float(v) for k, v in
            re.findall(r"(E|K|U|\|P\||L|dt\*) (?:= )?([-+0-9.e]+|inf)", text)}


@pytest.mark.parametrize("mesh", [False, True])
def test_diag_panel(mesh, monkeypatch):
    """E shows the physics panel: its energy is the port's
    diagnostics.total_energy of the world's state, or above the pair
    threshold the mesh estimate, tagged; the exact panel's every value
    agrees with nbody_tpu's on the same world."""
    jw, tw = _worlds()
    a, b = jv.ControlState(jw), tv.ControlState(tw)
    for c in (a, b):
        c.advance(0.0)  # stores acc, so dt* is finite
        c.cmd_diagnostics()
    if mesh:
        monkeypatch.setattr(tv, "EXACT_PE_PAIRS", 0)
    text = b.overlay_text(30.0)
    assert ("(mesh est.)" in text) == mesh
    st = tw.state.slice_to(tw.total_len)
    if mesh:
        e = float(diagnostics.kinetic_energy(st) + diagnostics.potential_energy_pm(
            st, tw.mass_len, grid=tw.config.pm_grid,
            softening=tw.config.pm_softening, g=tw.config.g))
    else:
        e = float(diagnostics.total_energy(st, tw.mass_len))
    assert f"E = {e:.4e}" in text
    if not mesh:
        got, want = _panel(text), _panel(a.overlay_text(30.0))
        assert set(want) == set(got) == {"E", "K", "U", "|P|", "L", "dt*"}
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-6), k
    b.cmd_diagnostics()
    assert "E = " not in b.overlay_text(30.0)


def test_run_refuses_a_non_interactive_backend():
    """Viewer.run raises on matplotlib's Agg backend, as nbody_tpu's
    does."""
    import matplotlib
    matplotlib.use("Agg", force=True)
    _, tw = _worlds()
    with pytest.raises(RuntimeError, match="no interactive matplotlib"):
        tv.Viewer(tw).run()


def test_view_cli_exits_without_a_viewer(monkeypatch, capsys):
    """``view`` exits with an error that names what is missing: an
    interactive matplotlib backend, matplotlib itself, or pygame under
    --sdl; it does not switch to the other viewer."""
    import matplotlib
    matplotlib.use("Agg", force=True)
    base = ["--platform", "cpu", "view", "--n", "200", "--galaxies", "1"]
    with pytest.raises(SystemExit) as e:
        app.main(base)
    assert "no interactive matplotlib" in str(e.value.code)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit) as e:
        app.main(base)
    assert "needs matplotlib" in str(e.value.code)
    monkeypatch.setitem(sys.modules, "pygame", None)
    with pytest.raises(SystemExit) as e:
        app.main(base + ["--sdl", "--video-driver", "dummy"])
    assert "view --sdl needs pygame" in str(e.value.code)


@pytest.mark.parametrize("module", ["viewer.py", "viewer_sdl.py"])
def test_gui_libraries_imported_only_where_used(module):
    """Neither matplotlib nor pygame is imported when the module is."""
    tree = ast.parse((ROOT / "nbody_tpu_torch" / module).read_text())
    for node in tree.body:
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        for name in names:
            assert name.split(".")[0] not in ("matplotlib", "pygame"), name


def test_constants_match_nbody_tpu():
    for name in ("PHYS_STEP", "MAX_OVERWORK", "SPEEDS", "STEPS",
                 "DEF_STEP_IDX", "CAMERA_SPEED_DELTA", "CAMERA_ZOOM_DELTA",
                 "NOMINAL_KEY_FPS"):
        assert getattr(tv, name) == getattr(jv, name), name
