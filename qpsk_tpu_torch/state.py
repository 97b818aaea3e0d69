"""Explicit modem state (port of ``qpsk_tpu.state``, uncoded QPSK slice).

All cross-call state is carried in these tuples and threaded through the
pure ``(state, block) -> (state', out)`` functions of ``modem``.  The field
names and layouts are the JAX package's, so ``from_numpy`` / ``to_numpy``
convert a state in either direction by field name without importing jax.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qpsk_tpu_torch.config import ModemConfig
from qpsk_tpu_torch.ops.costas import CostasState, costas_init
from qpsk_tpu_torch.ops.cplx import CF32, czeros
from qpsk_tpu_torch.ops.nco import nco_init
from qpsk_tpu_torch.ops.rrc import fir_init_tail


class TxState(NamedTuple):
    fir_tail: CF32    # (..., ntaps-1) zero-stuffed TX delay line
    nco_phase: CF32   # (...,) unit phasor


class RxState(NamedTuple):
    fir_tail: CF32         # (..., ntaps-1) mixed-domain RX delay line
    nco_phase: CF32        # (...,) unit phasor
    costas: CostasState    # (...,) phase/freq
    decim_delay: CF32      # (..., nsym) previous frame's picks


def tx_init(cfg: ModemConfig, batch_shape=(), device=None) -> TxState:
    return TxState(fir_tail=fir_init_tail(cfg.ntaps, batch_shape, device),
                   nco_phase=nco_init(batch_shape, device))


def rx_init(cfg: ModemConfig, batch_shape=(), acq_freq=0.0,
            device=None) -> RxState:
    batch_shape = tuple(batch_shape)
    return RxState(
        fir_tail=fir_init_tail(cfg.ntaps, batch_shape, device),
        nco_phase=nco_init(batch_shape, device),
        costas=costas_init(batch_shape, freq=acq_freq, device=device),
        decim_delay=czeros(batch_shape + (cfg.symbols_per_frame,), device))


_TUPLES = {cls.__name__: cls for cls in (TxState, RxState, CostasState, CF32)}


def from_numpy(tree, device=None):
    """A JAX ``RxState`` / ``TxState`` whose leaves are numpy arrays
    (``jax.tree.map(np.asarray, st)``) -> the port's state on ``device``.

    Fields are matched by name.  A field the port does not carry (the
    differential, tracking-timing, equalizer, AGC or gear-shift state) must
    be None, or the state belongs to a configuration off the port's slice
    and ``NotImplementedError`` is raised.
    """
    cls = _TUPLES[type(tree).__name__]
    extra = [f for f in tree._fields
             if f not in cls._fields and getattr(tree, f) is not None]
    if extra:
        raise NotImplementedError(
            f"{type(tree).__name__} fields {extra} belong to modes the "
            "port does not implement")
    vals = []
    for f in cls._fields:
        v = getattr(tree, f)
        if hasattr(v, "_fields"):
            vals.append(from_numpy(v, device))
        else:
            vals.append(torch.from_numpy(np.array(v, np.float32)).to(device))
    return cls(*vals)


def to_numpy(state):
    """The port's state -> the same tuples with numpy leaves, whose field
    names match the JAX package's state tuples."""
    return type(state)(*[to_numpy(v) if hasattr(v, "_fields")
                         else v.detach().cpu().numpy() for v in state])
