"""Read the SASS of a built kernel library with ``cuobjdump -sass``: each
kernel's instructions, its loops, and whether two builds compiled a kernel
to the same code.

A loop is the range from a backward branch's target to the branch; its
length counts the instructions in that range, branch included. The
innermost loops contain no other; the largest of them is a kernel's pair
loop (or the op probe's pass of 8 expressions). ``cuobjdump`` comes with
the CUDA toolkit beside ``nvcc`` (``ops/_build.find_nvcc``).

    python -m nbody_tpu_torch.ops.sass loops LIB.so
    python -m nbody_tpu_torch.ops.sass diff LIB_A.so LIB_B.so
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;")
_BRANCH = re.compile(r"\bBRA\b[^;]*?(0x[0-9a-f]+)\s*$")
# nvcc names a file's anonymous namespace after the file and a hash of it
_ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def _tool() -> str:
    from ._build import find_nvcc

    path = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.access(path, os.X_OK):
        raise RuntimeError(f"cuobjdump not found beside nvcc ({path})")
    return path


def functions(lib: Path | str) -> dict[str, list[tuple[int, str]]]:
    """{mangled kernel name: [(address, instruction), ...]} of the library's
    sm_90a code."""
    return parse(subprocess.run([_tool(), "-sass", str(lib)],
                                capture_output=True, text=True, check=True,
                                timeout=300).stdout)


def parse(text: str) -> dict[str, list[tuple[int, str]]]:
    """{kernel: [(address, instruction), ...]} from cuobjdump's text."""
    out: dict[str, list[tuple[int, str]]] = {}
    current = None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def loops(instrs: list[tuple[int, str]]) -> list[tuple[int, int, int]]:
    """(first address, branch address, instructions) of every loop."""
    index = {addr: k for k, (addr, _) in enumerate(instrs)}
    out = []
    for k, (addr, ins) in enumerate(instrs):
        m = _BRANCH.search(ins)
        if m:
            target = int(m.group(1), 16)
            if target <= addr and target in index:
                out.append((target, addr, k - index[target] + 1))
    return out


def innermost(found: list[tuple[int, int, int]]) -> list[tuple[int, int, int]]:
    """The loops that hold no other loop."""
    return [a for a in found
            if not any(b != a and a[0] <= b[0] and b[1] <= a[1] for b in found)]


def pair_loop(instrs: list[tuple[int, str]], opcode: str = "LDS") -> tuple[int, int]:
    """(instructions, those whose opcode starts with ``opcode``) in the
    largest innermost loop; (0, 0) if there is none. With one shared-memory
    read a source, the LDS count is the sources a pass of the loop takes,
    however far nvcc unrolled it."""
    inner = innermost(loops(instrs))
    if not inner:
        return 0, 0
    first, last, n = max(inner, key=lambda lp: lp[2])
    body = [ins for addr, ins in instrs if first <= addr <= last]
    ops = [ins.split()[1] if ins.startswith("@") else ins.split()[0] for ins in body]
    return n, sum(op.startswith(opcode) for op in ops)


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_usage(log: str) -> dict[str, dict[str, int]]:
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from nvcc's
    ``-Xptxas -v`` output (the ``.log`` that ``_build`` keeps beside each
    library)."""
    out: dict[str, dict[str, int]] = {}
    current = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = out.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = _SPILL.search(line)
        if m:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = _REGS.search(line)
        if m:
            current["registers"] = int(m.group(1))
    return out


def find(funcs: dict, pattern: str) -> str:
    """The one kernel whose mangled name matches ``pattern`` (re.search)."""
    hits = [name for name in funcs if re.search(pattern, name)]
    if len(hits) != 1:
        raise LookupError(f"{len(hits)} kernels match {pattern!r}: {hits[:4]}")
    return hits[0]


def diff(lib_a, lib_b) -> dict[str, bool]:
    """{kernel: same code in both} over the kernels of lib_a, matched by
    name with the anonymous namespace's per-file tag left out; a kernel
    that lib_b lacks counts as different."""
    a, b = ({_ANON.sub("_GLOBAL__N_", name): [i for _, i in code]
             for name, code in functions(lib).items()} for lib in (lib_a, lib_b))
    return {name: code == b.get(name) for name, code in a.items()}


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "loops":
        for name, code in functions(argv[1]).items():
            inner = innermost(loops(code))
            print(f"{name}: {len(code)} instructions, innermost loops "
                  f"{[n for _, _, n in inner]}")
        return 0
    if len(argv) == 3 and argv[0] == "diff":
        same = diff(argv[1], argv[2])
        for name, ok in same.items():
            print(f"{'same' if ok else 'DIFFERENT'} {name}")
        return 0 if all(same.values()) else 1
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
