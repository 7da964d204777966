"""Bit-exact clone of glibc ``rand()`` — the reference's RNG stream.

The reference seeds libc with ``srand(11037)`` (``src/bench.c:42``) or
``srand(time(NULL))`` (``src/main.c:42``) and draws every scene parameter
through ``rand()`` (``src/lib/galaxy.c:18-29``). glibc's ``rand()`` is not
magic: it is the documented TYPE_3 additive-feedback generator —

  1. Park-Miller seeding of a 31-word table:
     ``r[0] = seed; r[i] = 16807 * r[i-1] mod (2^31 - 1)`` for i = 1..30
     (computed via Schrage's method, exactly as glibc does);
  2. a lagged-Fibonacci stream over that table:
     ``r[i] = (r[i-31] + r[i-3]) mod 2^32``, output ``r[i] >> 1``;
  3. the first 310 outputs discarded at seeding time.

Reimplementing it makes the reference's exact scenes reproducible here
(``models/galaxy_ref.py``) — closing the "bit-exact reference scenes are
impossible portably" deviation recorded in PARITY.md. Validated against the
real glibc both by an embedded known-answer table and, when a compiler and
the reference's source tree are present, by tests/test_libc_scene.py's
live dump.
"""

from __future__ import annotations

_MERSENNE31 = 2147483647  # 2^31 - 1


class LibcRand:
    """glibc ``srand(seed)`` + ``rand()``, bit-exact.

    >>> r = LibcRand(1)
    >>> r.rand()
    1804289383
    """

    __slots__ = ("_table", "_f", "_r")

    def __init__(self, seed: int):
        seed = int(seed) & 0xFFFFFFFF
        word = seed - 0x100000000 if seed >= 0x80000000 else seed  # int32 view
        if word == 0:
            word = 1  # glibc: "We must make sure the seed is not 0"
        table = [0] * 31
        table[0] = word & 0xFFFFFFFF
        for i in range(1, 31):
            # Schrage's method, as glibc writes it; for positive words this
            # equals 16807 * word mod (2^31 - 1).  C's `/` and `%` truncate
            # toward zero — Python's divmod floors — so for the negative
            # int32 words produced by seeds >= 2^31 we must divide on the
            # magnitude and restore the signs (C99 6.5.5: quotient truncates,
            # remainder takes the dividend's sign).
            q, m = divmod(abs(word), 127773)
            hi, lo = (-q, -m) if word < 0 else (q, m)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += _MERSENNE31
            table[i] = word
        self._table = table
        self._f, self._r = 3, 0  # fptr/rptr start rand_sep = 3 apart
        for _ in range(310):  # glibc discards 10 * rand_deg outputs
            self.rand()

    def rand(self) -> int:
        """One ``rand()`` draw in [0, 2^31)."""
        table = self._table
        f = self._f
        v = (table[f] + table[self._r]) & 0xFFFFFFFF
        table[f] = v
        self._f = f + 1 if f < 30 else 0
        self._r = self._r + 1 if self._r < 30 else 0
        return v >> 1

    def draw(self, n: int) -> list[int]:
        """``n`` consecutive draws (convenience for tests)."""
        return [self.rand() for _ in range(n)]
