"""Runnable examples of the port's public API, one module a script, the
counterparts of the repository's ``examples/*.py``:

    python -m nbody_tpu_torch.examples.<name> [arguments] [--device cpu]

Each takes its JAX script's arguments and defaults and prints its lines.
It runs on the card ("cuda") unless ``--device cpu`` is given, and raises
without a card: no example falls back to the CPU. ``sharded`` and
``multihost_pod`` take ``--cpu-demo`` for 8 CPU shards. A script's
``main(argv)`` returns the names its run leaves behind (``traj``,
``parts``, ...), and running it as ``__main__`` binds them as the module's
globals, as the JAX scripts' top-level names are. See README.md here.
"""

from __future__ import annotations

import torch


def take_flag(argv: list, name: str) -> bool:
    """Whether ``name`` is in ``argv``, removing it."""
    if name not in argv:
        return False
    argv.remove(name)
    return True


def take_device(argv: list, default: str = "cuda") -> torch.device:
    """The device of ``--device <cuda|cpu>`` (removed from ``argv``), else
    ``default``. "cuda" without a card raises."""
    name = default
    if "--device" in argv:
        i = argv.index("--device")
        name = argv[i + 1]
        del argv[i:i + 2]
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "False); pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    return device
