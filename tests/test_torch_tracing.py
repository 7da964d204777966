"""The port's tracer (nbody_tpu_torch.utils.profiling: span, count,
enable, collect) on the CPU: off it records nothing and enters no
profiler range; on it nests world.update > substep > the stages with
their substep indices; under torch.profiler the stages' names, and only
theirs, appear as events, on the clock the anchor maps to; device
counters wait for collect(); the P3M counters of rows past a full cell
match a count from the bins."""

import ast
import statistics
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import nbody_tpu_torch as nt
from nbody_tpu_torch import world as world_mod
from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.ops import direct_forces as df
from nbody_tpu_torch.ops import p3m_forces
from nbody_tpu_torch.parallel import ShardedWorld, make_mesh
from nbody_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
P3M_STAGES = ["p3m.bins", "p3m.cic_scatter", "p3m.fft_solve",
              "p3m.cic_gather", "p3m.pack", "p3m.pair_kernel", "p3m.unpack",
              "p3m.exact_rows"]
# each backend's stages under a substep on the CPU ("cuda": the plain
# version of the fused substep, which launches nothing here)
STAGES = {"torch": [], "pm": [], "cuda": [], "p3m": P3M_STAGES}
SMALL_P3M = {"pm_grid": 64, "p3m_cell_capacity": 8}
# the layers' spans, which the tracer alone sees: no profiler range
LAYERS = {"world.update", "substep", "k1.launch"}


def substep():
    return profiling.span(profiling.SUBSTEP, profiled=False)


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    profiling.disable()
    profiling.collect()
    yield
    profiling.disable()
    profiling.collect()


@pytest.fixture
def spy(monkeypatch):
    """Calls of record_function made through the tracer."""
    calls = []
    real = profiling.record_function

    def record(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", record)
    return calls


def small_world(backend: str, monkeypatch, n: int = 600):
    if backend == "cuda":  # the plain fused substep on CPU tensors
        monkeypatch.setattr(world_mod, "_check_backend", lambda b, d: None)
    cfg = nt.SimConfig(**(SMALL_P3M if backend == "p3m" else {}))
    return nt.create_world(nt.make_galaxies(n, 2, seed=3), config=cfg,
                           default_backend=backend, device="cpu")


@pytest.mark.parametrize("backend", sorted(STAGES))
def test_off_records_nothing_and_enters_no_profiler_range(backend, spy,
                                                          monkeypatch):
    w = small_world(backend, monkeypatch)
    profiling.count("p3m.targets", 5)
    w.update(0.01, 2)
    assert spy == []
    rec = profiling.collect()
    assert rec["spans"] == [] and rec["counts"] == {}
    assert profiling.span("anything") is profiling.span(None)


@pytest.mark.parametrize("backend", sorted(STAGES))
def test_on_nests_world_update_substep_and_stages(backend, spy, monkeypatch):
    w = small_world(backend, monkeypatch)
    profiling.enable()
    w.update(0.01, 3)
    w.update(0.01, 2)
    profiling.disable()
    spans = profiling.collect()["spans"]
    assert spy == []  # no profiler window: no range entered
    updates = [i for i, s in enumerate(spans) if s.name == "world.update"]
    assert len(updates) == 2
    steps = [i for i, s in enumerate(spans) if s.name == "substep"]
    assert [spans[i].step for i in steps] == list(range(5))
    assert [spans[i].parent for i in steps] == (
        [updates[0]] * 3 + [updates[1]] * 2)
    for i in updates:
        s = spans[i]
        assert s.parent == -1 and s.step == -1
        assert s.start_ns <= s.end_ns
    for i in steps:
        kids = [s for s in spans if s.parent == i]
        assert [s.name for s in kids] == STAGES[backend]
        for s in kids:
            assert s.step == spans[i].step
            assert (spans[i].start_ns <= s.start_ns <= s.end_ns
                    <= spans[i].end_ns)


def test_substep_indices_restart_at_enable_and_collect_clears():
    profiling.enable()
    for _ in range(3):
        with substep():
            with profiling.span("inner"):
                pass
    first = profiling.collect()
    assert [s.step for s in first["spans"]] == [0, 0, 1, 1, 2, 2]
    assert [s.parent for s in first["spans"]] == [-1, 0, -1, 2, -1, 4]
    assert profiling.collect()["spans"] == []
    profiling.enable()
    with substep():
        pass
    with profiling.span("outside"):
        pass
    profiling.disable()
    with profiling.span("after"):
        pass
    assert [(s.name, s.step) for s in profiling.collect()["spans"]] == [
        ("substep", 0), ("outside", -1)]


def test_span_closes_when_the_block_raises():
    profiling.enable()
    with pytest.raises(ValueError):
        with profiling.span("outer"):
            with substep():
                raise ValueError("inside")
    with profiling.span("next"):
        pass
    spans = profiling.collect()["spans"]
    assert [(s.name, s.parent, s.step) for s in spans] == [
        ("outer", -1, -1), ("substep", 0, 0), ("next", -1, -1)]
    assert all(s.end_ns >= s.start_ns > 0 for s in spans)


def test_k1_launch_span_around_the_kernel_call(monkeypatch):
    """_launch's span holds the C call (a stub library here: the CPU has
    no kernel)."""
    seen = []

    class Lib:
        def nbody_direct_forces(self, *args):
            seen.append(profiling._open[:])
            return 0

    monkeypatch.setattr(df, "_lib", Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: profiling.span(None))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    x = torch.zeros((4, 2))
    r, gm = torch.ones(4), torch.ones(4)
    before = df.LAUNCHES
    profiling.enable()
    with substep():
        df._launch(x, x, r, x, gm, 0.01, 1.0, False, x, x, x,
                   plan=df.Plan(1, 1))
    spans = profiling.collect()["spans"]
    assert [(s.name, s.parent, s.step) for s in spans] == [
        ("substep", -1, 0), ("k1.launch", 0, 0)]
    assert seen == [[0, 1]] and df.LAUNCHES == before + 1


def test_kernel_load_is_recorded_whatever_the_flag(monkeypatch, tmp_path):
    """_build.load times itself into LOADED, tracer on or off, and opens
    no span."""
    class Fn:
        pass

    class Lib:
        def __getattr__(self, name):
            fn = Fn()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "build_all",
                        lambda names: {names[0]: (tmp_path / "lib.so", 0.0)})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    monkeypatch.setattr(_build, "LOADED", {})
    load = _build.load.__wrapped__  # past the process's cache
    load("direct_vjp")
    assert list(_build.LOADED) == ["direct_vjp"]
    assert _build.LOADED["direct_vjp"] >= 0.0
    profiling.enable()
    load("ring_forces")
    assert profiling.collect()["spans"] == []
    assert list(_build.LOADED) == ["direct_vjp", "ring_forces"]
    assert _build.LOADED["ring_forces"] >= 0.0


def test_profiler_sees_the_same_names_on_the_anchored_clock(monkeypatch):
    """Under torch.profiler the stages' spans are ranges of the same names
    and the layers' spans are none, and the anchor maps each stage span's
    start onto the profile's event clock: the median distance over the
    spans is at most 50 µs."""
    from torch.profiler import ProfilerActivity, profile

    w = small_world("p3m", monkeypatch, n=400)
    w.update(0.01, 1)
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        w.update(0.01, 3)
    profiling.disable()
    rec = profiling.collect()
    spans = [s for s in rec["spans"] if s.name not in LAYERS]
    assert {s.name for s in rec["spans"]} - set(P3M_STAGES) == {
        "world.update", "substep"}
    assert len(spans) >= 20
    start = prof.profiler.kineto_results.trace_start_ns()
    events: dict = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        events.setdefault(e.name, []).append(e.time_range.start)
    assert not LAYERS & set(events)
    dist = []
    for name in {s.name for s in spans}:
        mine = [(profiling.wall_ns(s.start_ns, rec["anchor"]) - start) / 1e3
                for s in spans if s.name == name]
        assert len(events.get(name, [])) == len(mine), name
        dist += [abs(a - b) for a, b in zip(sorted(mine), events[name])]
    assert statistics.median(dist) <= 50.0


@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("backend", sorted(STAGES))
def test_profiler_ranges_are_the_stages_alone(backend, on, spy,
                                              monkeypatch):
    """Under a profiler window, tracer on or off, a World's update enters
    the ranges of its stages, as before the tracer, and none for
    world.update, substep or k1.launch."""
    from torch.profiler import ProfilerActivity, profile

    w = small_world(backend, monkeypatch)
    if on:
        profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]):
        w.update(0.01, 2)
    profiling.disable()
    assert spy == STAGES[backend] * 2
    assert len(profiling.collect()["spans"]) == (
        3 + 2 * len(STAGES[backend]) if on else 0)


class Watched(torch.Tensor):
    """A tensor that counts the reads of its value on the host."""

    reads = 0
    READS = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.__bool__,
             torch.Tensor.__int__, torch.Tensor.__float__,
             torch.Tensor.__index__, torch.Tensor.numpy}

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in cls.READS:
            Watched.reads += 1
        return super().__torch_function__(func, types, args, kwargs or {})


def test_count_adds_device_tensors_without_reading_them_back():
    Watched.reads = 0
    profiling.enable()
    for v in (3, 4):
        profiling.count("rows", torch.tensor(v).as_subclass(Watched))
    profiling.count("calls", 1)
    profiling.count("calls", 2)
    assert Watched.reads == 0
    counts = profiling.collect()["counts"]
    assert counts == {"rows": 7, "calls": 3}
    assert Watched.reads >= 1
    assert all(type(v) is int for v in counts.values())


def brute_past(counts, cap: int) -> int:
    return sum(max(c - cap, 0) for c in counts.tolist())


@pytest.mark.parametrize("cap", [8, 16, 96])
def test_p3m_counters_match_a_count_from_the_bins(cap):
    """One substep of a small P3M World with full cells: the counters of
    rows past capacity equal a count from the bins built on the same
    positions (a force evaluation a substep with Euler)."""
    cfg = nt.SimConfig(pm_grid=64, p3m_cell_capacity=cap)
    w = nt.create_world(nt.make_galaxies(1500, 2, seed=5), config=cfg,
                        default_backend="p3m", device="cpu")
    st = w.state
    mesh_gm = world_mod._mesh_sources(w.gm)
    s = mesh_gm.shape[0]
    bins = p3m_forces.p3m_bins(st.pos, st.radius, st.pos[:s], mesh_gm,
                               grid=cfg.pm_grid, rc_cells=cfg.p3m_rc_cells,
                               exact_targets=cfg.p3m_exact_targets)
    profiling.enable()
    w.update(0.01, 1)
    counts = profiling.collect()["counts"]
    assert counts["p3m.targets"] == w.total_len
    assert counts["p3m.sources"] == s
    assert counts["p3m.dropped_targets"] == brute_past(bins["counts_t"], cap)
    assert counts["p3m.dropped_sources"] == brute_past(bins["counts_s"], cap)
    if cap == 8:
        assert counts["p3m.dropped_targets"] > 0
        assert counts["p3m.dropped_sources"] > 0
    if cap == 96:
        assert counts["p3m.dropped_sources"] == 0


def test_sharded_p3m_counters_match_the_world():
    """Four CPU shards: the global-rank rule drops the same rows as one
    World does (targets and sources past each cell's capacity). N is a
    multiple of 8 · D, so the shards hold no padding row (a padding row is
    binned and counted too)."""
    cfg = nt.SimConfig(pm_grid=64, p3m_cell_capacity=8)
    p = nt.make_galaxies(1216, 2, seed=7)
    got = {}
    for key, w in (("world", nt.create_world(p, config=cfg, device="cpu")),
                   ("sharded", ShardedWorld(p, make_mesh(devices=["cpu"] * 4),
                                            config=cfg,
                                            force_backend="p3m"))):
        profiling.enable()
        w.update(0.01, 1, **({"backend": "p3m"} if key == "world" else {}))
        profiling.disable()
        got[key] = profiling.collect()["counts"]
    for name in ("p3m.dropped_targets", "p3m.dropped_sources"):
        assert got["sharded"][name] == got["world"][name] > 0, name
    assert got["sharded"]["p3m.sources"] == got["world"]["p3m.sources"]
    assert got["sharded"]["p3m.targets"] == got["world"]["p3m.targets"] == 1216


def _uses_record_function(path: Path) -> bool:
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and any(
                a.name == "record_function" for a in node.names):
            return True
        if isinstance(node, ast.Attribute) and node.attr == "record_function":
            return True
    return False


def test_only_the_tracer_uses_record_function():
    users = sorted(p.relative_to(ROOT).as_posix()
                   for p in (ROOT / "nbody_tpu_torch").rglob("*.py")
                   if _uses_record_function(p))
    assert users == ["nbody_tpu_torch/utils/profiling.py"]
