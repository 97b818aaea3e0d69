"""Golden-prime bit interleaver (port of ``qpsk_tpu.packet.interleave``).

Bit ``i`` moves to ``(b * i) mod nbits``, with ``b`` the largest prime below
``nbits`` from the reference's 69-entry table.  The permutation depends only
on ``nbits``, so it is built once on the host and applied as one gather.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from qpsk_tpu_torch import tracing

_PRIMES = np.array([
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29,
    31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
    73, 79, 83, 89, 97, 101, 103, 107, 109, 113,
    127, 131, 137, 139, 149, 151, 157, 163, 167, 173,
    179, 181, 191, 193, 197, 199, 211, 223, 227, 229,
    233, 239, 241, 251, 257, 263, 269, 271, 277, 281,
    283, 293, 307, 311, 313, 317, 331, 337, 347], dtype=np.int64)


def golden_prime(nbits: int) -> int:
    """Largest table prime < nbits (saturating at 347)."""
    index = 1
    while index < len(_PRIMES) and _PRIMES[index] < nbits:
        index += 1
    return int(_PRIMES[index - 1])


def _mapping(nbits: int) -> np.ndarray:
    b = golden_prime(nbits)
    if math.gcd(b, nbits) != 1:
        raise ValueError(
            f"golden prime {b} divides frame size {nbits} bits — the "
            f"interleaver permutation would not be invertible; choose a "
            f"frame size coprime with {b}")
    return (b * np.arange(nbits, dtype=np.int64)) % nbits


@functools.lru_cache(maxsize=None)
def interleave_permutation(nbits: int) -> np.ndarray:
    """``perm`` with ``out = in[perm]``: out[(b*i) % nbits] = in[i]."""
    perm = np.zeros(nbits, dtype=np.int64)
    perm[_mapping(nbits)] = np.arange(nbits)
    return perm


@functools.lru_cache(maxsize=None)
def deinterleave_permutation(nbits: int) -> np.ndarray:
    """out[i] = in[(b*i) % nbits]."""
    return _mapping(nbits)


def interleave_bits(bits: torch.Tensor) -> torch.Tensor:
    perm = torch.from_numpy(interleave_permutation(int(bits.shape[-1])))
    tracing.count("sync.interleave.perm")
    return bits[..., perm.to(bits.device)]


def deinterleave_bits(bits: torch.Tensor) -> torch.Tensor:
    perm = torch.from_numpy(deinterleave_permutation(int(bits.shape[-1])))
    tracing.count("sync.interleave.perm")
    return bits[..., perm.to(bits.device)]
