"""Benchmark of the PyTorch/CUDA port of ACORN (``repro_torch``): hybrid
search through ``HybridIndex.search`` on the card, driven by the cells of
``BENCHMARK.json``.  See ``chipbench/README.md``."""
