"""Differential QPSK (DQPSK) encoding and decoding (port of
``qpsk_tpu.ops.differential``).

Each dibit is sent as a phase *change*: the reference constellation
``{1, +j, -j, -1}`` indexed by ``(b1 << 1) | b0`` maps index -> quarter
turns ``P = [0, 1, 3, 2]`` (its own inverse), the transmitter accumulates
``a_k = (a_{k-1} + P[d_k]) mod 4`` (a ``cumsum`` mod 4) and sends
``exp(j*pi/2*a_k)``, still the reference constellation on air.

The receiver decodes coherently: each Costas-locked symbol is rotated by a
fixed -45 degrees (the loop locks on the diagonals), sliced to its quarter
turn by sign and magnitude tests, and the dibit is the difference of
consecutive turns mod 4.  A constant k*90-degree lock rotation shifts
every turn alike and cancels; a cycle slip costs one symbol.  The carries
are one int32 phase index (TX) and one CF32 symbol (RX) per channel.  The
first symbol after ``diff_rx_init`` measures against 1+0j, which the
channel's rotation does not multiply: it is a coin toss, as in the JAX
package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from qpsk_tpu_torch.ops.cplx import CF32, cmul

# index <-> quarter-turn permutation (an involution), and exp(j*pi/2*a)
_IDX_TO_TURN = (0, 1, 3, 2)
_TURN_RE = (1.0, 0.0, -1.0, 0.0)
_TURN_IM = (0.0, 1.0, 0.0, -1.0)
_COS45 = float(np.float32(np.cos(np.pi / 4)))


def _table(values, like: torch.Tensor, dtype) -> torch.Tensor:
    """``values`` as a tensor on ``like``'s device, made once a device."""
    return _cached(values, dtype, like.device)


@functools.lru_cache(maxsize=None)
def _cached(values, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def diff_tx_init(batch_shape=(), device="cuda") -> torch.Tensor:
    """TX carry: the absolute phase index, 0 (-> 1+0j)."""
    return torch.zeros(tuple(batch_shape), dtype=torch.int32, device=device)


def diff_rx_init(batch_shape=(), device="cuda") -> CF32:
    """RX carry: the previous received symbol, 1+0j."""
    shape = tuple(batch_shape)
    return CF32(torch.ones(shape, dtype=torch.float32, device=device),
                torch.zeros(shape, dtype=torch.float32, device=device))


def diff_encode_indices(indices: torch.Tensor, carry: torch.Tensor):
    """Dibit indices (..., n) + carry (...,) -> (absolute phase indices
    (..., n) int32 in [0, 4), new carry (...,))."""
    turns = _table(_IDX_TO_TURN, indices, torch.int32)[indices.long()]
    acc = carry[..., None] + torch.cumsum(turns, dim=-1, dtype=torch.int32)
    abs_idx = torch.remainder(acc, 4).to(torch.int32)
    return abs_idx, abs_idx[..., -1].contiguous()


def diff_encode_bits(bits: torch.Tensor, carry: torch.Tensor):
    """Bits (..., 2n) -> (symbols CF32 (..., n), new carry), with the
    reference dibit packing ``index = (bits[2i] << 1) | bits[2i+1]``."""
    b = bits.reshape(bits.shape[:-1] + (-1, 2)).to(torch.int32)
    abs_idx, carry = diff_encode_indices((b[..., 0] << 1) | b[..., 1], carry)
    i = abs_idx.long()
    return (CF32(_table(_TURN_RE, bits, torch.float32)[i],
                 _table(_TURN_IM, bits, torch.float32)[i]), carry)


def quantize_turns(z: CF32) -> torch.Tensor:
    """Nearest quarter turn of each phasor, argmax_m Re{z e^{-j pi/2 m}},
    by sign and magnitude tests."""
    axis_major = z.re.abs() >= z.im.abs()
    m_axis = torch.where(z.re >= 0, 0, 2)
    m_diag = torch.where(z.im >= 0, 1, 3)
    return torch.where(axis_major, m_axis, m_diag).to(torch.int32)


def diff_decode_symbols(symbols: CF32, carry: CF32):
    """Received symbols (..., n) + previous-symbol carry -> (bits (..., 2n)
    int32, new carry = the last symbol): rotate by -45 degrees, slice to
    quarter turns, difference mod 4."""
    full = CF32(torch.cat([carry.re[..., None], symbols.re], dim=-1),
                torch.cat([carry.im[..., None], symbols.im], dim=-1))
    rot = cmul(full, CF32(_COS45, -_COS45))       # e^{-j pi/4}, unnormalized
    m = quantize_turns(rot)
    d = torch.remainder(m[..., 1:] - m[..., :-1], 4)
    idx = _table(_IDX_TO_TURN, d, torch.int32)[d.long()]
    bits = torch.stack([(idx >> 1) & 1, idx & 1], dim=-1)
    new_carry = CF32(symbols.re[..., -1].contiguous(),
                     symbols.im[..., -1].contiguous())
    return bits.reshape(symbols.shape[:-1] + (-1,)), new_carry
