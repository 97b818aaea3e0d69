"""Explicit modem state (port of ``qpsk_tpu.state``).

All cross-call state is carried in these tuples and threaded through the
pure ``(state, block) -> (state', out)`` functions of ``modem``.  The field
names and layouts are the JAX package's, so ``from_numpy`` / ``to_numpy``
convert a state in either direction by field name without importing jax.

The state is built on the card unless the caller passes ``device``; on a
machine without one, a call without ``device="cpu"`` raises.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from qpsk_tpu_torch.config import ModemConfig
from qpsk_tpu_torch.ops.agc import agc_init
from qpsk_tpu_torch.ops.costas import CostasState, costas_init
from qpsk_tpu_torch.ops.cplx import CF32, czeros
from qpsk_tpu_torch.ops.differential import diff_rx_init, diff_tx_init
from qpsk_tpu_torch.ops.equalizer import eq_init
from qpsk_tpu_torch.ops.nco import nco_init
from qpsk_tpu_torch.ops.rrc import fir_init_tail
from qpsk_tpu_torch.ops.timing import timing_track_init


class TxState(NamedTuple):
    fir_tail: CF32    # (..., ntaps-1) zero-stuffed TX delay line
    nco_phase: CF32   # (...,) unit phasor
    diff_phase: Any = None  # (...,) int32 DQPSK phase index (differential)


class RxState(NamedTuple):
    fir_tail: CF32         # (..., ntaps-1) mixed-domain RX delay line
    nco_phase: CF32        # (...,) unit phasor
    costas: CostasState    # (...,) phase/freq[/lev/locked]
    decim_delay: CF32      # (..., nsym) previous frame's picks
    diff_prev: Any = None  # (...,) CF32 previous DQPSK symbol (differential)
    timing: Any = None     # (tau, dtau) timing PLL (timing_mode="tracking")
    eq: Any = None         # (w, hist) CMA equalizer taps (cfg.eq_taps > 0)
    agc: Any = None        # (...,) smoothed symbol RMS (cfg.agc)


def tx_init(cfg: ModemConfig, batch_shape=(), device="cuda") -> TxState:
    batch_shape = tuple(batch_shape)
    return TxState(fir_tail=fir_init_tail(cfg.ntaps, batch_shape, device),
                   nco_phase=nco_init(batch_shape, device),
                   diff_phase=(diff_tx_init(batch_shape, device)
                               if cfg.differential else None))


def rx_init(cfg: ModemConfig, batch_shape=(), acq_freq=0.0,
            device="cuda") -> RxState:
    batch_shape = tuple(batch_shape)
    return RxState(
        fir_tail=fir_init_tail(cfg.ntaps, batch_shape, device),
        nco_phase=nco_init(batch_shape, device),
        costas=costas_init(batch_shape, freq=acq_freq,
                           gear=cfg.loop_bw_track > 0, device=device),
        decim_delay=czeros(batch_shape + (cfg.symbols_per_frame,), device),
        diff_prev=(diff_rx_init(batch_shape, device) if cfg.differential
                   else None),
        timing=(timing_track_init(batch_shape, device)
                if cfg.timing_mode == "tracking" else None),
        eq=(eq_init(cfg.eq_taps, batch_shape, device) if cfg.eq_taps > 0
            else None),
        agc=agc_init(batch_shape, device) if cfg.agc else None)


_TUPLES = {cls.__name__: cls for cls in (TxState, RxState, CostasState, CF32)}


def _leaf(v, device):
    """A numpy leaf, a plain tuple of them (the equalizer's ``(w, hist)``,
    the timing PLL's ``(tau, dtau)``) or None -> the same on ``device``;
    an integer leaf (DQPSK's phase index) stays int32, every other one is
    float32."""
    if v is None:
        return None
    if hasattr(v, "_fields"):
        return from_numpy(v, device)
    if isinstance(v, tuple):
        return tuple(_leaf(x, device) for x in v)
    a = np.asarray(v)
    dtype = np.int32 if a.dtype.kind in "iu" else np.float32
    return torch.from_numpy(np.array(a, dtype)).to(device)


def from_numpy(tree, device="cuda"):
    """A JAX ``RxState`` / ``TxState`` whose leaves are numpy arrays
    (``jax.tree.map(np.asarray, st)``) -> the port's state on ``device``,
    fields matched by name."""
    cls = _TUPLES[type(tree).__name__]
    return cls(*[_leaf(getattr(tree, f, None), device) for f in cls._fields])


def flatten(tree) -> list:
    """The tensors of a state tuple in the JAX package's leaf order
    (``jax.tree.leaves`` of the same state): fields in order, None fields
    vanishing, CF32 as (re, im), ``CostasState`` as (phase, freq, lev,
    locked), the timing PLL's ``(tau, dtau)`` as tau then dtau, the
    equalizer's ``(w, hist)`` as w's then hist's."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in flatten(v)]
    return [tree]


def unflatten(like, leaves):
    """The state tuple of ``like``'s structure with ``leaves`` (in
    ``flatten`` order) in place of its tensors, each a tensor on the
    device and of the dtype of the leaf it replaces.  Raises ValueError
    if the count differs."""
    leaves = list(leaves)
    n = len(flatten(like))
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a state of {n}")
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, tuple):
            vals = [build(v) for v in t]
            return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)
        v = next(it)
        v = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        return v.to(device=t.device, dtype=t.dtype)
    return build(like)


def tree_map(fn, tree):
    """``fn`` on every leaf of a tree of dicts, lists, tuples and named
    tuples (a state, a metric tree); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return fn(tree)


def to_numpy(state):
    """The port's state -> the same tuples with numpy leaves, whose field
    names match the JAX package's state tuples."""
    return tree_map(lambda v: v.detach().cpu().numpy(), state)
