"""Wrappers of the hand-written CUDA kernels (sources in ``csrc/``).

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs its
plain PyTorch version on a CPU tensor; ``_lib.launches`` counts the
launches of each C entry."""
