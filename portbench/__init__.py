"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command
runs one cell once (``run.py``).  Cells, configurations, traffic mixes,
per-layer metric readers, limits and references are files found by the
names in the repository's ``BENCHMARK.json``."""
