"""Build and load the port's CUDA kernels.

The sources in ``nbody_tpu_torch/csrc/*.cu`` have a plain C interface. At
first use they are compiled by ``nvcc`` for ``sm_90a`` into one shared
library, ``build/kernels/libnbody_kernels-<sha>.so`` under the repository
root, where ``<sha>`` hashes the sources and the flags; the library is then
loaded with ctypes. A library already built from the same sources and flags
is loaded as it is. No PyTorch header is compiled, so a build takes seconds.

``nvcc`` is looked up in ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
then on ``PATH``; if none has it, loading raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
DEFAULT_CUDA_HOME = "/usr/local/cuda"

# No --use_fast_math: the precise path relies on IEEE sqrtf and division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    homes = [os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME]
    for home in homes:
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found in $CUDA_HOME/bin, /usr/local/cuda/bin or PATH: "
        "the CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnbody_kernels-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources unless the library exists. Returns (path, seconds
    spent compiling). nvcc's output (``-Xptxas -v``: registers, shared memory
    and spills per kernel) is kept next to the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out, 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out, seconds


_vp, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# nbody_direct_forces: every pointer and the stream as c_void_p, so that
# ctypes does not cut them to 32 bits.
ARGTYPES = [_vp, _vp, _vp, _vp, _vp,   # tgt pos/vel/radius, src pos/gm
            _i32, _i32, _f32, _f32,    # n_tgt, n_src, dt, pos_dt
            _i32, _i32,                # precise, integrate
            _vp, _vp, _vp, _vp]        # acc/pos/vel out, stream


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load the library, and declare its C signatures."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.nbody_direct_forces.argtypes = ARGTYPES
    lib.nbody_direct_forces.restype = _i32
    return lib
