"""On the card: a short run of the direct cell through the command, and the
control at the cell's own size. Marked ``cuda``; the ``card`` fixture
skips them where PyTorch sees no CUDA card. Run on the card with
``python -m pytest perfbench/tests -q -m cuda``."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from perfbench import harness, judge


@pytest.mark.cuda
def test_command_prints_a_correct_result_line(card):
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "direct-65k.run",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and list(out)[-1] == "checks"
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.cuda
@pytest.mark.parametrize("work", ["direct-65k.run", "p3m-1m.run"])
def test_control_is_not_correct_at_the_cells_size(work, card):
    cell = harness.load_cell(work)
    for seed in (7, 2**31 + 11, 2**32 + 3):
        sc, snaps, _ = harness.simulate(cell, seed, 1.0, False, card,
                                        time.perf_counter())
        got = cell.numbers()(cell.config, sc, snaps, seed, card,
                             post=judge.control_post(cell.config, sc, card))
        assert not judge.passed(judge.checks(cell.config, got)), (seed, got)
