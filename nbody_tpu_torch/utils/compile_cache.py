"""Persistent kernel cache: repeat launches load the CUDA libraries that an
earlier process built.

Counterpart of ``nbody_tpu/utils/compile_cache.py``, whose persistent XLA
cache spares a launch the 20-40 s cold jit. The port's compile step is
``nvcc``: each ``csrc/<name>.cu`` becomes ``lib<name>-<key>.so``
(``ops/_build.py``), where the key hashes the source, the headers beside
it, the flags and ``nvcc --version``'s output, so a stale library is never
loaded, only left unused. This module chooses the directory those
libraries live in:

    from nbody_tpu_torch.utils import enable_compile_cache
    enable_compile_cache()              # ~/.cache/nbody_tpu_torch/kernels
                                        # (or $NBODY_TPU_TORCH_CACHE_DIR)
    enable_compile_cache("/fast/ssd")   # an explicit directory

or from the command line: ``python -m nbody_tpu_torch --compile-cache
[DIR] run ...``.

Without it, ``ops/_build`` resolves the directory itself:
$NBODY_TPU_TORCH_CACHE_DIR, else ``build/kernels`` of a source checkout,
else :func:`default_cache_dir` (an installed package). Call it before the
first kernel launch it should capture: a library already loaded stays
loaded, as JAX's earlier compiles simply miss its cache. The last call
wins. Concurrent writers are safe: each build writes a file of its own
process and renames it into place.
"""

from __future__ import annotations

import os
from pathlib import Path

# nbody_tpu's floor for persisting a compile; see enable_compile_cache
_MIN_COMPILE_TIME_SECS = 1.0


def default_cache_dir() -> str:
    """$NBODY_TPU_TORCH_CACHE_DIR, else $XDG_CACHE_HOME (or ~/.cache)
    /nbody_tpu_torch/kernels."""
    env = os.environ.get("NBODY_TPU_TORCH_CACHE_DIR")
    if env:
        return env
    xdg = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(xdg, "nbody_tpu_torch", "kernels")


def enable_compile_cache(
    cache_dir: str | None = None,
    *,
    min_compile_time_secs: float = _MIN_COMPILE_TIME_SECS,
) -> str:
    """Build and load the CUDA kernels' libraries in ``cache_dir`` and
    return it.

    Args:
      cache_dir: the directory; :func:`default_cache_dir` if None. Created
        if absent.
      min_compile_time_secs: accepted for nbody_tpu's signature; changes
        nothing here: every nvcc build is persisted (a build takes
        seconds, and a library is small).

    Returns:
      The directory in use.
    """
    from ..ops import _build

    del min_compile_time_secs
    path = Path(cache_dir or default_cache_dir())
    path.mkdir(parents=True, exist_ok=True)
    _build.set_build_dir(path)
    return str(path)


def cache_entries(cache_dir: str | None = None) -> int:
    """Number of kernel libraries in ``cache_dir`` (the directory in use
    if None); 0 if the directory is absent."""
    if cache_dir is None:
        from ..ops import _build

        cache_dir = _build.build_dir()
    path = Path(cache_dir)
    if not path.is_dir():
        return 0
    return sum(1 for f in path.glob("lib*.so") if f.is_file())
