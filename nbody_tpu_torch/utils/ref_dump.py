"""Reader for the reference's particle dumps (scripts/ref_scene_dump.c):
one particle per line, ``pos.x pos.y vel.x vel.y mass radius`` as C ``%a``
hex floats, as in tests/data/ref_scene_*.hex and ref_traj_*.hex."""

from __future__ import annotations

import numpy as np


def load_hex_dump(path) -> np.ndarray:
    """Parse a dump into an (N, 6) float32 array, in file order."""
    with open(path) as f:
        rows = [[np.float32(float.fromhex(tok)) for tok in line.split()]
                for line in f]
    return np.array(rows, np.float32)
