"""The benchmark of the PyTorch and CUDA port: served SSB queries.

``bench/run.py`` is the command; ``BENCHMARK.json`` at the repository's
root names the cells, metrics and files this package reads.
"""
