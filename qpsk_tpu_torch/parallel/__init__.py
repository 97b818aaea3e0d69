"""Parallel execution of one stream on one card (port of the single-card
part of ``qpsk_tpu.parallel``).

``blocks``: one long stream's decimated symbols split into overlapping
blocks that ride the Costas kernel's channel axis, each block
re-acquiring the carrier and running its own loop.  Scale-out over
several cards (the JAX package's ``channels``, ``stream`` and
``multihost``) is not ported yet.
"""

from qpsk_tpu_torch.parallel.blocks import rx_stream_blockparallel
