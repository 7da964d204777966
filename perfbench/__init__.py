"""The benchmark of nbody_tpu_torch, the PyTorch and CUDA port: its
harness, traffic, configurations, metric readers and plain references.
``python3 perfbench/run.py --help``; ``PERF.md`` says what each cell and
metric is for."""
