"""Parallel execution of the modem (port of ``qpsk_tpu.parallel``).

* ``blocks``: one long stream's decimated symbols split into overlapping
  blocks that ride the Costas kernel's channel axis on one card.
* ``channels``: data parallel over independent channels, each rank (one
  process a card) receiving its block of the channel axis.
* ``stream``: sequence parallel over time blocks of one long stream,
  with a neighbour exchange of the FIR's ``ntaps-1``-sample halo.
* ``multihost``: the process group and the ``DeviceMesh`` the other two
  run on (``torch.distributed``: NCCL on the card, gloo on the CPU).
"""

from qpsk_tpu_torch.parallel.blocks import rx_stream_blockparallel
from qpsk_tpu_torch.parallel.channels import (make_channel_demod,
                                              shard_channel_state)
from qpsk_tpu_torch.parallel.stream import rx_stream_timeparallel
