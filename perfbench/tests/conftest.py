"""Shared fixtures of the benchmark's own tests: cells cut to a size the
CPU runs in seconds, and the card, decided inside a fixture."""

from __future__ import annotations

import copy

import pytest

from perfbench import harness

# Cut sizes of each configuration for CPU runs: (particles, sim overrides,
# substeps a call). The P3M size is one at which its force error against
# the direct sum stays inside the configuration's bound (chip_smoke.py's
# [9] case); its plain pair correction takes ~1 s a substep on the CPU.
SMALL = {
    "galaxies2-65k-direct": (1000, {}, 4),
    "galaxies2-1m-p3m": (2048, {"pm_grid": 256, "p3m_cell_capacity": 96}, 2),
}


def small_cell(name: str, restart: int = 12) -> harness.Cell:
    """The cell ``name`` at SMALL's size, with short calls."""
    cell = harness.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    n, sim, per_call = SMALL[cfg["name"]]
    cfg["scene"]["particles"] = n
    cfg["sim"].update(sim)
    if "guarantee_vs_direct" in cfg:
        cfg["guarantee_vs_direct"]["sample_rows"] = 500
    cell.config = cfg
    cell.traffic = dict(cell.traffic, substeps_per_call=per_call,
                        restart_every=restart)
    return cell


@pytest.fixture
def cpu_cuda_backend(monkeypatch):
    """Let a CPU world take the "cuda" backend: the kernels' wrappers then
    run their plain versions on CPU tensors."""
    import nbody_tpu_torch.world as world

    monkeypatch.setattr(world, "_check_backend", lambda backend, device: None)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
