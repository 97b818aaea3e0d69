"""Data parallelism over independent channels (port of
``qpsk_tpu.parallel.channels``).

Channels are a batch axis on every modem operation, so a channel-sharded
receive is ``modem.rx_stream`` on each rank's contiguous block of the
channel axis: one process a card, each running the front-end and Costas
kernels on its own block, as the JAX package's ``shard_map`` body launches
its Pallas kernels per device.  Channels are independent, so there are no
collectives in steady state; a caller that wants a metric over all
channels reduces it (``multihost.aggregate_metrics``).

The mesh, input, output, device and backend conventions are the scale-out
layer's (``parallel/multihost.py``): inputs have the global shapes, every
rank holds the same input, and each rank returns its own block.
"""

from __future__ import annotations

import torch

from qpsk_tpu_torch.config import ModemConfig
from qpsk_tpu_torch.modem import rx_stream
from qpsk_tpu_torch.parallel.multihost import (axis_rank, axis_size,
                                               global_mesh, mesh_device,
                                               to_mesh)
from qpsk_tpu_torch.state import RxState, rx_init, tree_map

__all__ = ["ModemConfig", "RxState", "rx_init", "rx_stream", "default_mesh",
           "shard_channel_state", "make_channel_demod", "init_channels"]


def default_mesh(axis: str = "dp"):
    """One axis over every rank of the group."""
    return global_mesh((axis,))


def _block(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s leading (channel) axis;
    ValueError unless the axis size divides the channel count."""
    n, c = axis_size(mesh, axis), x.shape[0]
    if c % n:
        raise ValueError(f"{c} channels do not divide over the {n} ranks of "
                         f"mesh axis {axis!r}")
    k = c // n
    r = axis_rank(mesh, axis)
    return x[r * k:(r + 1) * k]


def shard_channel_state(state: RxState, mesh, axis: str = "dp") -> RxState:
    """This rank's block of a (channels, ...) state, on its device
    (ValueError for a state on the card and a CPU mesh)."""
    return tree_map(lambda v: to_mesh(_block(v, mesh, axis), mesh)
                    .contiguous(), state)


def make_channel_demod(cfg: ModemConfig, mesh, axis: str = "dp"):
    """``fn(state, pcm) -> (state, RxOut)``: ``pcm`` the global (channels,
    frames, frame_size) int16 PCM (every rank holds the same), ``state``
    this rank's block (``shard_channel_state`` / ``init_channels``).  Each
    rank runs ``modem.rx_stream`` on its block of the channels and returns
    its block of the outputs: on the card, the front-end and Costas
    kernels of the main path, one launch each a call.  PCM on the card
    given to a CPU mesh raises ValueError."""

    def fn(state: RxState, pcm: torch.Tensor):
        block = _block(pcm, mesh, axis)
        nchan = state.costas.freq.shape[0]
        if block.shape[0] != nchan:
            raise ValueError(f"this rank's state holds {nchan} channels, its "
                             f"block of the PCM {block.shape[0]}")
        return rx_stream(cfg, state, to_mesh(block, mesh).contiguous())
    return fn


def init_channels(cfg: ModemConfig, nchannels: int, mesh,
                  axis: str = "dp") -> RxState:
    """This rank's block of a cold ``nchannels``-channel receiver."""
    return shard_channel_state(
        rx_init(cfg, (nchannels,), device=mesh_device(mesh)), mesh, axis)
