"""One reader a metric: ``perfbench/metrics/<metric>.py`` holds
``read(ctx) -> float | None`` (``ctx``: ``harness.simulate``'s namespace), None where it finds
nothing to read. ``roofline.py`` holds the peaks and the kernels'
operation and byte counts."""
