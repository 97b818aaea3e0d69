"""Wrappers of the hand-written CUDA kernels (sources in ``csrc/``).

Each wrapper launches its kernel on a CUDA tensor (or raises), runs its
plain PyTorch version on a CPU tensor, and counts its launches in the
module's ``launches`` integer."""
