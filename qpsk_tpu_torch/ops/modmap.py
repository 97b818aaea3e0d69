"""Gray-coded QPSK mapping and slicing (port of ``qpsk_tpu.ops.modmap``).

Constellation {1, +j, -j, -1} indexed by ``(bits[2i] << 1) | bits[2i+1]``;
the diagonal slicer ``b1 = Im < 0, b0 = Re < 0`` inverts it under the
Costas loop's diagonal lock (the 4-fold ambiguity is resolved by
``qpsk_tpu_torch.sync``); ``demod_bits_reference`` is the C reference's
rotate-45 slicer.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qpsk_tpu_torch import tracing
from qpsk_tpu_torch.ops.cplx import CF32, cmul

TAU = 2.0 * math.pi
ROTATE45 = math.pi / 4.0
# e^{j pi/4} as float32 values (the reference's ROTATE45)
ROT45_RE = float(np.float32(math.cos(ROTATE45)))
ROT45_IM = float(np.float32(math.sin(ROTATE45)))

# constellation[(b1 << 1) | b0] (qpsk.c:58-63)
CONSTELLATION = np.array([1.0 + 0.0j, 0.0 + 1.0j, 0.0 - 1.0j, -1.0 + 0.0j],
                         dtype=np.complex64)


def mod_symbols(indices: torch.Tensor) -> CF32:
    """Constellation lookup for integer indices in [0, 4)."""
    idx = torch.as_tensor(indices).long()
    table = torch.from_numpy(np.stack([CONSTELLATION.real, CONSTELLATION.imag
                                       ]).astype(np.float32)).to(idx.device)
    return CF32(table[0][idx], table[1][idx])


def bits_to_symbols(bits: torch.Tensor) -> CF32:
    """(..., 2n) bits -> n QPSK symbols: for dibit (u, v), sign
    ``s = 1 - 2u`` and axis select ``d = u XOR v`` give
    ``re = (1-d)*s, im = d*s``."""
    b = bits.reshape(bits.shape[:-1] + (-1, 2)).to(torch.float32)
    u, v = b[..., 0], b[..., 1]
    s = 1.0 - 2.0 * u
    d = u + v - 2.0 * u * v
    return CF32((1.0 - d) * s, d * s)


def demod_bits(symbols: CF32) -> torch.Tensor:
    """Slice symbols (..., n) to bits (..., 2n) int32, [b1, b0] per symbol."""
    bits = torch.stack([symbols.im < 0.0, symbols.re < 0.0], dim=-1)
    return bits.to(torch.int32).reshape(symbols.shape[:-1] + (-1,))


def demod_soft(symbols: CF32, scale: float = 1.0) -> torch.Tensor:
    """Soft twin of ``demod_bits``: LLRs (..., 2n), positive = bit 0,
    aligned with the hard bits: ``llr(b1) = scale*im``, ``llr(b0) =
    scale*re``.  Max-sum decoding is invariant to positive scaling."""
    with tracing.span("packet.soft"):
        llr = torch.stack([symbols.im, symbols.re], dim=-1) * scale
        return llr.reshape(symbols.shape[:-1] + (-1,))


def demod_bits_reference(symbols: CF32) -> torch.Tensor:
    """The C reference's slicer, defect included (qpsk.c:74-79): rotate by
    +45 degrees, then ``b0 = Re < 0``, ``b1 = Im < 0``, stream order
    [b1, b0].  Under the diagonal lock this puts the symbols on the axes,
    where one of the two sign tests is decided by noise; it is kept for
    parity with the C modem (``config_parity()``)."""
    rot = cmul(symbols, CF32(ROT45_RE, ROT45_IM))
    bits = torch.stack([rot.im < 0.0, rot.re < 0.0], dim=-1)
    return bits.to(torch.int32).reshape(symbols.shape[:-1] + (-1,))


def upsample_zero_stuff(symbols: CF32, cycles: int) -> CF32:
    """Zero-stuff by ``cycles``: each symbol lands on phase 0 of its group."""
    def one(plane):
        out = torch.zeros(plane.shape + (cycles,), dtype=plane.dtype,
                          device=plane.device)
        out[..., 0] = plane
        return out.reshape(plane.shape[:-1] + (plane.shape[-1] * cycles,))
    return CF32(one(symbols.re), one(symbols.im))
