"""The port's profiling helpers (nbody_tpu_torch.utils.profiling) against
nbody_tpu.utils.profiling: StepTimer's counts and summary format, and a
torch.profiler trace with its annotations, on the CPU."""

import json
import re
import time

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import pytest
import torch

import nbody_tpu_torch as nt
from nbody_tpu.utils import profiling as jax_profiling
from nbody_tpu_torch.utils import StepTimer, annotate, profiling, trace

SUMMARY = re.compile(r"^(\d+) calls, mean (\d+\.\d) µs, best (\d+\.\d) µs$")


def _run(timer, sleeps, block=None):
    for s in sleeps:
        with timer.measure(block):
            time.sleep(s)


@pytest.mark.parametrize("sleeps", [[], [0.001], [0.001, 0.002, 0.001]])
def test_step_timer_matches_nbody_tpu(sleeps):
    ours, theirs = StepTimer(), jax_profiling.StepTimer()
    _run(ours, sleeps)
    _run(theirs, sleeps)
    assert len(ours.times_s) == len(theirs.times_s) == len(sleeps)
    a, b = SUMMARY.match(ours.summary()), SUMMARY.match(theirs.summary())
    assert a and b and a.group(1) == b.group(1) == str(len(sleeps))
    if sleeps:
        assert ours.mean_us >= 1000 and ours.best_us <= ours.mean_us
    else:
        assert ours.mean_us == theirs.mean_us == 0.0
        assert ours.best_us == theirs.best_us == 0.0


def test_step_timer_formats_its_own_numbers():
    t = StepTimer(times_s=[0.001, 0.003])
    j = jax_profiling.StepTimer(times_s=[0.001, 0.003])
    assert t.summary() == j.summary() == "2 calls, mean 2000.0 µs, best 1000.0 µs"


def test_measure_takes_trees_of_cpu_tensors():
    """CPU tensors need no wait; a tree may hold Particles, lists, tuples
    and dicts."""
    p = nt.make_galaxies(200, 1, seed=3)
    w = nt.create_world(p, device="cpu")
    t = StepTimer()
    for tree in (p, [p.pos, {"v": p.vel}], (w.state, torch.zeros(3))):
        with t.measure(tree):
            w.update(0.01, 1)
    assert len(t.times_s) == 3 and "3 calls" in t.summary()


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    p = nt.make_galaxies(200, 1, seed=3)
    w = nt.create_world(p, device="cpu")
    with trace(tmp_path) as log_dir:
        assert log_dir == tmp_path
        with annotate("nbody-test-region"):
            w.update(0.01, 2)
    files = list(tmp_path.glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "nbody-test-region" for e in events)


def test_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError):
        with trace(tmp_path):
            with annotate("before-the-error"):
                torch.ones(4).sum()
            raise RuntimeError("inside the traced block")
    assert len(list(tmp_path.glob("trace-*.json"))) == 1


def test_default_trace_dir_is_inside_the_checkout():
    root = profiling.DEFAULT_TRACE_DIR.parents[1]
    assert (root / "nbody_tpu_torch").is_dir()
