"""DVB additive bit scrambler, 1 + X^14 + X^15, seed 0x4A80 (port of
``qpsk_tpu.packet.scramble``).  The keystream does not depend on the input,
so it is computed once on the host and applied as one XOR; scrambling is
its own inverse."""

from __future__ import annotations

import functools

import numpy as np
import torch

from qpsk_tpu_torch import tracing


@functools.lru_cache(maxsize=None)
def keystream(nbits: int, seed: int = 0x4A80) -> np.ndarray:
    """First ``nbits`` LFSR output bits from ``seed``."""
    out = np.zeros(nbits, dtype=np.int32)
    mem = seed
    for i in range(nbits):
        s = ((mem >> 1) & 1) ^ (mem & 1)
        out[i] = s
        mem = (mem >> 1) | (s << 14)
    return out


def scramble_bits(bits: torch.Tensor, seed: int = 0x4A80) -> torch.Tensor:
    """XOR a (..., nbits) bit stream with the frame keystream."""
    tracing.count("sync.scramble.keystream")
    ks = torch.from_numpy(keystream(int(bits.shape[-1]), seed)).to(bits.device)
    return bits.to(torch.int32) ^ ks
