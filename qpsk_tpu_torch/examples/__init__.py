"""Walkthroughs of the port, one module each, twins of the JAX package's
``examples/``: ``python -m qpsk_tpu_torch.examples.<name> [--device cpu]``
with ``end_to_end``, ``modulation_family`` or ``streaming_receiver``."""
