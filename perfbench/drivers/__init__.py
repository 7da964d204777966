"""One driver a kind of traffic: ``perfbench/drivers/<driver>.py``, named by
the ``"driver"`` key of a traffic's data file, holds ``Driver(world, cfg,
traffic, sync)``. A new mix of an existing kind is a data file alone; a new
kind of traffic (a gradient rollout, a sharded loop) adds a driver."""
