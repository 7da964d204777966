"""Plain references of the benchmark's configurations: PyTorch operations
only, in float64 unless a caller asks for another dtype. They import
nothing of the program, and work out again whatever the program derives
from the inputs (the massive-first partition, gm, cell bins, exact rows).
Each configuration names its reference module (``"reference"`` in its
file); the module owns the substep it judges, its integrator included:
``acc(pos, radius, gm, cfg, dtype)``, ``step(cfg, ref, pos, vel, dtype)``
and ``update_parts(cfg, pos, vel, got)``."""
