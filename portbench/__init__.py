"""The benchmark of ``qpsk_tpu_torch``, the PyTorch and CUDA port, on one
NVIDIA H100 (see ``README.md``)."""
