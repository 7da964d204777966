"""Where the shards of a sharded world meet: the seam between the
single-controller world and one spread over processes.

A sharded world has D shards in a global order. One process may drive all
of them (the single controller, :data:`LOCAL`), or each of P processes of a
``torch.distributed`` group drives L = D / P of them (:class:`ShardGroup`):
rank r owns shards r·L … r·L + L − 1, as ``jax.devices()`` orders the
devices of its processes.

Every collective of the port is written as "gather every shard's piece onto
one device, in shard order, then reduce there in that order". The single
controller gathers by ``.to(device)``; a group by one ``all_gather`` of the
local pieces, after which every rank runs the same reduction on its own
device. So every rank holds the same bits, and they are the single
controller's. No float is summed by ``all_reduce``: NCCL's and Gloo's
reduction orders are not shard order.
"""

from __future__ import annotations

import torch

from ..types import DTYPE


class Local:
    """The single controller: this process holds every shard, and a gather
    is a copy of each shard's piece to the device asked for."""

    pg = None
    size = 1
    rank = 0

    def n_shards(self, n_local: int) -> int:
        """D, the number of shards over every process."""
        return n_local * self.size

    def first(self, n_local: int) -> int:
        """The global index of this process's first shard."""
        return self.rank * n_local

    def gather(self, xs: list, device, rows: list | None = None) -> list:
        """Every shard's piece on ``device``, in shard order. ``xs`` holds
        one tensor for each of this process's shards; ``rows`` (one count
        for every shard of every process) gives the length of dim 0 where
        the pieces differ in it."""
        return [x.to(device) for x in xs]

    def gather_where(self, xs: list, device, keep: list, shape: tuple) -> list:
        """The pieces of the shards whose ``keep`` (one flag for every shard
        of every process) is set, in shard order, on ``device``. ``xs`` holds
        one entry for each of this process's shards: an fp32 tensor of
        ``shape`` where its flag is set, else None."""
        return [x.to(device) for x, k in zip(xs, keep) if k]

    def source_rows(self, src: list) -> list[int]:
        """The number of source rows of every shard (``src``: this process's
        shards' sources)."""
        return [s.shape[0] for s in src]


LOCAL = Local()


class ShardGroup(Local):
    """A world's shards over the processes of ``pg``, L = ``n_local`` on
    each. ``src_rows``, which the world sets: the mesh solvers' source rows
    of every shard, fixed by the world's layout (a process cannot see
    another's shapes without a host round trip)."""

    def __init__(self, pg, n_local: int):
        import torch.distributed as dist

        self.pg = pg
        self.size = dist.get_world_size(pg)
        self.rank = dist.get_rank(pg)
        self.n_local = n_local
        self.src_rows: list | None = None

    def _all_gather(self, block: torch.Tensor) -> list:
        import torch.distributed as dist

        out = [torch.empty_like(block) for _ in range(self.size)]
        dist.all_gather(out, block.contiguous(), group=self.pg)
        return [piece for part in out for piece in part.unbind(0)]

    def gather(self, xs: list, device, rows: list | None = None) -> list:
        if len(xs) != self.n_local:
            raise ValueError(f"{len(xs)} pieces for {self.n_local} local shards")
        if xs[0].dim() == 0:
            return self._all_gather(torch.stack([x.to(device) for x in xs]))
        first = self.first(self.n_local)
        if rows is None:
            rows = [xs[0].shape[0]] * self.n_shards(self.n_local)
        for k, x in enumerate(xs):
            if x.shape[0] != rows[first + k]:
                raise ValueError(f"shard {first + k} has {x.shape[0]} rows, "
                                 f"expected {rows[first + k]}")
        tail = tuple(xs[0].shape[1:])
        m = max(rows)
        if m == 0:  # nothing to send: every process knows it from rows
            return [xs[0].new_zeros((0,) + tail, device=device) for _ in rows]
        block = xs[0].new_zeros((len(xs), m) + tail, device=device)
        for k, x in enumerate(xs):
            block[k, :x.shape[0]] = x
        return [p[:r] for p, r in zip(self._all_gather(block), rows)]

    def gather_where(self, xs: list, device, keep: list, shape: tuple) -> list:
        # a process may hold no kept piece: it joins with zeros of ``shape``
        filled = [torch.zeros(shape, dtype=DTYPE, device=device) if x is None
                  else x for x in xs]
        return [x for x, k in zip(self.gather(filled, device), keep) if k]

    def source_rows(self, src: list) -> list[int]:
        first = self.first(self.n_local)
        for k, s in enumerate(src):
            if s.shape[0] != self.src_rows[first + k]:
                raise ValueError(f"shard {first + k} has {s.shape[0]} source "
                                 f"rows, the layout {self.src_rows[first + k]}")
        return list(self.src_rows)


def group_of(group) -> Local:
    """``group``, or the single controller where it is None."""
    return LOCAL if group is None else group
