"""Plain reference of the coded link's receive side, from its published
semantics: soft bits of the derotated symbols, the golden-prime
deinterleaver, the DVB descrambler, the K=7 (133, 171) soft Viterbi decoder
and the CRC-16/CCITT-FALSE check.  Nothing of the program is imported; the
tables are built here.

* LLRs: ``[Im, Re]`` of each symbol, positive meaning bit 0.
* Interleaver over an ``n``-bit frame: received bit ``i`` is frame bit
  ``(b i) mod n``, ``b`` the largest prime below ``min(n, 348)``.
* Scrambler: the keystream of ``1 + X^14 + X^15`` from the seed 0x4A80,
  restarted each frame; descrambling flips the LLR's sign where it is 1.
* Viterbi: states pack the last six input bits, newest in the low bit;
  the branch metric is ``0.5 (s0 l0 + s1 l1)`` with ``s = 1 - 2 out``;
  path metrics start at -1e9 with 0 in state 0, keep the larger candidate
  (the second only where strictly larger), are reduced by their maximum
  after each step, and are traced back from state 0.  Every operation is
  float32 and rounds once, so a decode is fixed by its LLRs, ties
  included.
* CRC: poly 0x1021, init 0xFFFF, no reflection, over the payload bytes
  (most significant bit first), the 16 check bits after them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

K, POLYS = 7, (0o133, 0o171)


def soft_bits(symbols: torch.Tensor) -> torch.Tensor:
    """(..., n) complex symbols -> (..., 2n) float LLRs."""
    return torch.stack([symbols.imag, symbols.real], dim=-1).reshape(
        symbols.shape[:-1] + (-1,))


def golden_prime(n: int) -> int:
    """The largest prime below ``min(n, 348)``."""
    top = min(n, 348)
    sieve = np.ones(top, bool)
    sieve[:2] = False
    for p in range(2, int(top ** 0.5) + 1):
        sieve[p * p::p] = False
    return int(np.nonzero(sieve)[0][-1])


@functools.lru_cache(maxsize=None)
def deinterleave_index(n: int) -> np.ndarray:
    """``frame = received[idx]``: frame bit ``i`` is received bit
    ``(b i) mod n``."""
    return (golden_prime(n) * np.arange(n)) % n


@functools.lru_cache(maxsize=None)
def keystream(n: int, seed: int = 0x4A80) -> np.ndarray:
    out = np.zeros(n, np.int64)
    mem = seed
    for i in range(n):
        s = ((mem >> 1) ^ mem) & 1
        out[i] = s
        mem = (mem >> 1) | (s << 14)
    return out


@functools.lru_cache(maxsize=None)
def trellis() -> tuple:
    """(sign of output 0, sign of output 1) into state s' from its
    predecessor ``p``: arrays (2, 64), predecessors ``(s' >> 1) | (p << 5)``
    and input bit ``s' & 1``."""
    nstates = 1 << (K - 1)
    signs = np.zeros((2, 2, nstates), np.float32)
    for s in range(nstates):
        u = s & 1
        for p in range(2):
            reg = ((((s >> 1) | (p << (K - 2))) << 1) | u)
            for j, g in enumerate(POLYS):
                out = bin(reg & g).count("1") & 1
                signs[j, p, s] = 1.0 - 2.0 * out
    return signs


def viterbi(llrs: torch.Tensor, nbits: int,
            dtype=torch.float32) -> torch.Tensor:
    """(B, 2 (nbits + 6)) LLRs -> (B, nbits) uint8 bits; the metrics in
    ``dtype`` (float32, or the control's lower precision)."""
    b = llrs.shape[0]
    nsteps = nbits + K - 1
    nstates = 1 << (K - 1)
    dev = llrs.device
    sg = torch.as_tensor(trellis(), device=dev).to(dtype)   # (2, 2, S)
    ll = llrs.to(dtype).reshape(b, nsteps, 2)
    pm = torch.full((b, nstates), -1e9, dtype=dtype, device=dev)
    pm[:, 0] = 0.0
    half = nstates // 2
    dec = torch.empty((nsteps, b, nstates), dtype=torch.bool, device=dev)
    for t in range(nsteps):
        l0, l1 = ll[:, t, 0:1], ll[:, t, 1:2]
        bm0 = 0.5 * (sg[0, 0] * l0 + sg[1, 0] * l1)           # (B, S)
        bm1 = 0.5 * (sg[0, 1] * l0 + sg[1, 1] * l1)
        from0 = pm[:, :half].repeat_interleave(2, dim=1) + bm0
        from1 = pm[:, half:].repeat_interleave(2, dim=1) + bm1
        dec[t] = from1 > from0
        pm = torch.maximum(from0, from1)
        pm = pm - pm.amax(dim=1, keepdim=True)
    state = torch.zeros(b, dtype=torch.int64, device=dev)
    bits = torch.empty((b, nsteps), dtype=torch.uint8, device=dev)
    rows = torch.arange(b, device=dev)
    for t in range(nsteps - 1, -1, -1):
        bits[:, t] = (state & 1).to(torch.uint8)
        won = dec[t, rows, state].to(torch.int64)
        state = (state >> 1) | (won << (K - 2))
    return bits[:, :nbits]


def to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """(B, 8m) bits -> (B, m) int64 bytes, each byte's bits least
    significant first."""
    w = 1 << torch.arange(8, device=bits.device)
    return (bits.reshape(bits.shape[0], -1, 8).to(torch.int64) * w).sum(-1)


def crc16(data: torch.Tensor) -> torch.Tensor:
    """CRC-16/CCITT-FALSE of (B, m) bytes -> (B,) int64."""
    crc = torch.full(data.shape[:1], 0xFFFF, dtype=torch.int64,
                     device=data.device)
    for i in range(data.shape[1]):
        crc = crc ^ (data[:, i] << 8)
        for _ in range(8):
            crc = torch.where((crc & 0x8000) > 0, (crc << 1) ^ 0x1021,
                              crc << 1) & 0xFFFF
    return crc


def crc16_ok(bits: torch.Tensor) -> torch.Tensor:
    """(B, 8m + 16) bits -> (B,) bool: the CRC of the first m bytes equals
    the last two, high byte first."""
    data = to_bytes(bits)
    return crc16(data[:, :-2]) == (data[:, -2] << 8) | data[:, -1]


CHUNK = 1 << 17    # packets decoded at a time


def decode(llrs: torch.Tensor, payload_bits: int,
           dtype=torch.float32) -> tuple:
    """(B, frame_bits) LLRs of conv-coded frames -> (payload (B,
    payload_bits) uint8, crc_ok (B,) bool), ``CHUNK`` packets at a time."""
    parts = [_decode(llrs[i:i + CHUNK], payload_bits, dtype)
             for i in range(0, llrs.shape[0], CHUNK)]
    return (torch.cat([p for p, _ in parts]),
            torch.cat([ok for _, ok in parts]))


def _decode(llrs: torch.Tensor, payload_bits: int, dtype) -> tuple:
    n = llrs.shape[-1]
    x = llrs[:, torch.as_tensor(deinterleave_index(n), device=llrs.device)]
    ks = torch.as_tensor(keystream(n), device=llrs.device)
    x = x * (1 - 2 * ks).to(x.dtype)
    bits = viterbi(x, payload_bits + 16, dtype)
    return bits[:, :payload_bits], crc16_ok(bits)
