"""Build the native C++ libraries of ``cpp/`` for the port, outside ``cpp/``.

``nbody_tpu``'s wrappers build ``cpp/*.so`` in place with ``make``; the
port builds its own copies from the same tracked sources and the same
``cpp/Makefile`` (its flags: ``-O2 -mavx -ffp-contract=off -fopenmp``)
into ``build/cpp/`` under the repository root, so that the two never
write the same file. Each library is ``build/cpp/lib<name>-<sha>.so``,
where ``<sha>`` hashes the Makefile and the source; ``make`` runs in a
temporary directory of its own and the result is moved into place with
``os.replace``, so a process never loads a partial file and two processes
building at once both load a whole library.

Where the compiler has no OpenMP runtime (``-fopenmp`` fails, as with a
g++ installed without libgomp), the library is built with the Makefile's
flags less ``-fopenmp``, as ``lib<name>-<sha>-serial.so``. OpenMP only
spreads ``nbody_oracle.cpp``'s targets over threads (its one ``#pragma
omp parallel for``); each target's sum is the same code, so the serial
library gives the same bits on one thread.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CPP_DIR = ROOT / "cpp"
BUILD_DIR = ROOT / "build" / "cpp"
SOURCES = {"nbody_oracle": "nbody_oracle.cpp", "nbody_galaxy": "galaxy_gen.cpp"}


class NativeBuildError(RuntimeError):
    """``make`` or the compiler is missing or failed."""


def library_path(name: str, openmp: bool = True) -> Path:
    digest = hashlib.sha256()
    for part in ("Makefile", SOURCES[name]):
        digest.update((CPP_DIR / part).read_bytes())
    tail = "" if openmp else "-serial"
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}{tail}.so"


def _run(args, cwd=None) -> str:
    try:
        return subprocess.run(args, cwd=cwd, check=True, capture_output=True,
                              text=True, timeout=120).stdout
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            OSError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise NativeBuildError(f"{' '.join(map(str, args))}: {detail}") from e


def _make(name: str, path: Path, cxxflags: list | None) -> Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f".{name}-", dir=BUILD_DIR))
    target = f"lib{name}.so"
    # -B: a library that nbody_tpu built in cpp/ would otherwise be found
    # through VPATH and taken as up to date
    args = ["make", "-s", "-B", "-f", str(CPP_DIR / "Makefile"),
            f"VPATH={CPP_DIR}"]
    if cxxflags is not None:
        args.append("CXXFLAGS=" + " ".join(cxxflags))
    try:
        _run([*args, target], cwd=tmp)
        os.replace(tmp / target, path)
    except OSError as e:
        raise NativeBuildError(f"failed to move {target} into place: {e}") from e
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return path


def makefile_flags() -> list:
    """CXXFLAGS as ``cpp/Makefile`` sets them."""
    return _run(["make", "-s", "-f", str(CPP_DIR / "Makefile"), "--eval",
                 "print-cxxflags: ; @echo $(CXXFLAGS)",
                 "print-cxxflags"]).split()


def build(name: str) -> Path:
    """The path of ``lib<name>.so``, built by ``cpp/Makefile`` unless a
    library of the same Makefile and source is there already: with its
    flags, or, where those fail, with its flags less ``-fopenmp``."""
    try:
        paths = [library_path(name, openmp) for openmp in (True, False)]
    except OSError as e:
        raise NativeBuildError(f"cannot read the sources of {name}: {e}") from e
    for path in paths:
        if path.exists():
            return path
    try:
        return _make(name, paths[0], None)
    except NativeBuildError as first:
        try:
            flags = [f for f in makefile_flags() if f != "-fopenmp"]
            return _make(name, paths[1], flags)
        except NativeBuildError as e:
            raise NativeBuildError(f"failed to build lib{name}.so: {first}\n"
                                   f"{e}") from e
