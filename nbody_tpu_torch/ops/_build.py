"""Build and load the port's CUDA kernels.

Each source ``nbody_tpu_torch/csrc/<name>.cu`` has a plain C interface. At
first use it is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library, ``build/kernels/lib<name>-<sha>.so`` under the repository root,
where ``<sha>`` hashes the source, the headers beside it (``csrc/*.cuh``)
and the flags; the library is then loaded
with ctypes. A library already built from the same source and flags is
loaded as it is. No PyTorch header is compiled, so a build takes seconds,
and :func:`build_all` runs one ``nvcc`` per source, all at once.

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

# No --use_fast_math: the precise paths rely on IEEE sqrtf and division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of each library's entry points: every pointer and the stream
# as c_void_p, so that ctypes does not cut them to 32 bits.
SIGNATURES = {
    "direct_forces": {
        "nbody_direct_forces": [
            _vp, _vp, _vp, _vp, _vp,   # tgt pos/vel/radius, src pos/gm
            _i32, _i32, _f32, _f32,    # n_tgt, n_src, dt, pos_dt
            _i32, _i32,                # precise, integrate
            _i32, _i32,                # plan: p, n_split
            _vp,                       # partial scratch or NULL
            _vp, _vp, _vp, _vp],       # acc/pos/vel out, stream
        "nbody_sm_count": [_vp],       # int* out
    },
    "direct_vjp": {
        "nbody_direct_vjp": [
            _vp, _vp, _vp, _vp, _vp,   # tgt pos/radius, src pos/gm, g
            _i32, _i32, _i32,          # n_tgt, n_src, precise
            _i32, _i32, _i32,          # plan: own targets, p, n_split
            _vp, _vp,                  # own partials or NULL, other partials
            _vp, _vp, _vp, _vp,        # d_tgt_pos/radius, d_src_pos/gm
            _vp],                      # stream
    },
    "ring_forces": {
        "nbody_ring_hop": [
            _vp, _vp, _vp, _vp,        # tgt pos/radius, src pos/gm
            _i32, _i32,                # n_tgt, n_src
            _vp, _i32, _i32,           # acc_run, accumulate, last
            _vp, _vp, _f32, _f32,      # tgt vel, valid, dt, pos_dt
            _i32,                      # precise
            _i32, _i32,                # plan: p, n_split
            _vp, _vp, _vp, _vp],       # acc/pos/vel out, stream
    },
    "ptile_forces": {
        "nbody_ptile_forces": [
            _vp, _vp,                  # tgt (3, T), src (3, S)
            _i32, _i32, _i32, _i32,    # n_tgt, n_src, p, block
            _i32, _i32, _i32,          # chunk, stage, n_split
            _vp, _vp, _vp],            # partials, out (2, T), stream
    },
    "stationary_forces": {
        "nbody_stationary_forces": [
            _vp, _vp,                  # tgt (3, T), src (3, S)
            _i32, _i32, _i32, _i32,    # n_tgt, n_src, p, threads
            _i32, _i32, _i32,          # chunk, n_slabs, precise
            _vp, _vp, _vp],            # partials, out (2, T), stream
    },
    "newton_forces": {
        "nbody_newton_forces": [
            _vp, _vp,                  # tgt (4, T), src (4, S)
            _i32, _i32, _i32, _i32,    # n_tgt, n_src, mass_len, tile
            _vp, _i32, _i32,           # plan (int4 tasks), tasks, group
            _vp, ctypes.c_longlong,    # scratch, its float2 count
            _vp, _vp],                 # out (2, T), stream
    },
    "flavor_forces": {
        "nbody_flavor_forces": [
            _vp, _vp,                  # tgt (3, T), src (3, S)
            _i32, _i32,                # n_tgt, n_src
            _i32, _i32, _i32,          # variant, p, block
            _i32, _i32, _i32,          # chunk, stage, n_split
            _vp, _vp, _vp],            # partials, out (2, T), stream
    },
    "v2_forces": {
        "nbody_v2_forces": [
            _vp, _vp, _vp,             # tgt rows or pos, radius, src (3, S)
            _i32, _i32,                # n_tgt, n_src
            _i32, _i32, _i32, _i32,    # rows, variant, p, block
            _i32, _i32,                # chunk, n_split
            _vp, _vp, _vp],            # partials, out, stream
    },
    "op_probe": {
        "nbody_op_probe": [
            _vp, _vp, _i32,            # x, y, n
            _i32, _i32,                # expression, loops
            _vp, _vp],                 # out, stream
    },
    "bcast_probe": {
        "nbody_bcast_probe": [
            _vp, _vp,                  # tgt (3, T), src (3, S)
            _i32, _i32,                # n_tgt, n_src
            _i32, _i32, _i32,          # variant, reps, n_split
            _vp, _vp, _vp, _vp],       # packed scratch, partials, out, stream
    },
    "p3m_pp": {
        "nbody_p3m_pp": [
            _vp, _i32, _vp, _i32,      # trows (n_t, 4), n_t, srows (n_s, 4), n_s
            _vp, _vp, _vp, _vp,        # start_t, counts_t, start_s, counts_s (gc*gc,) int32
            _vp,                       # tile_end (gc*gc,) int32
            _i32, _i32, _i32, _i32,    # gc, cap_t, cap_s, max_tasks
            _vp,                       # (rc, eps2, 1/rc) fp32 on the device
            _i32, _vp, _vp],           # precise, out (n_t, 2), stream
    },
    "p3m_pp_vjp": {
        "nbody_p3m_pp_vjp": [
            _vp, _i32, _vp, _i32,      # trows (n_t, 4), n_t, srows (n_s, 4), n_s
            _vp, _vp, _vp, _vp,        # start_t, counts_t, start_s, counts_s
            _i32, _i32, _i32,          # gc, cap_t, cap_s
            _vp, _i32,                 # (rc, eps2, 1/rc) fp32, precise
            _vp,                       # g (n_t, 2) cotangent
            _vp, _vp, _i32,            # plan: ranges (gc*gc,), ends (2, gc*gc), R
            _vp,                       # task counter (one int32, 0)
            _vp, _vp,                  # scratch: target and source partials
            _vp, _vp, _vp],            # d_t (n_t, 4), d_s (n_s, 4), stream
    },
    "merge_contacts": {
        "nbody_contact_grid": [
            _vp, _vp, _vp,             # pos (m, 2), radius, live (bytes)
            _i32, _f32, _i32,          # m, factor, k
            _vp, _vp, _vp, _vp,        # out: keys, big rows, counts, scalars
            _vp],                      # stream
        "nbody_merge_contacts": [
            _vp, _vp, _vp, _vp,        # pos (m, 2), radius, mass, live (bytes)
            _i32, _f32,                # m, factor
            _vp, _vp, _vp, _vp,        # grid: order, keys, big rows, counts
            _vp, _vp,                  # scratch: packed (m, 4), big keys
            _vp, _vp],                 # winner (m,) int64, stream
    },
}


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


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    """Where the library for the current source, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, tuple[Path, float]]:
    """Compile every named source (all of ``SIGNATURES`` by default) whose
    library does not exist, one nvcc process per source, all started at
    once. Returns {name: (path, seconds that source's nvcc took)}; a library
    found built reports 0 s. nvcc's output (``-Xptxas -v``: registers,
    shared memory and spills per kernel) is kept next to each library as
    ``.log``. Raises if any build fails."""
    names = list(SIGNATURES if names is None else names)
    out = {n: (library_path(n), 0.0) for n in names}
    todo = [n for n in names if not out[n][0].exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = out[n][0].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(n))]
        procs[n] = (cmd, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (cmd, tmp, t0, proc) in procs.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        log = f"$ {' '.join(cmd)}\n{text}"
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {n} ({proc.returncode}):\n{log}")
            continue
        path = out[n][0]
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)  # atomic: a concurrent build never loads a partial file
        out[n] = (path, seconds)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed, load it, and declare its C
    signatures."""
    path, _ = build_all([name])[name]
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _i32
    return lib
