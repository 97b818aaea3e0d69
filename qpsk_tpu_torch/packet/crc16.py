"""CRC-16/CCITT-FALSE: poly 0x1021, init 0xFFFF, no reflection, no xorout
(port of ``qpsk_tpu.packet.crc16``).

The byte-to-byte dependency is inherent, so ``crc16`` loops over bytes with
a 256-entry table lookup per step, batched over every leading axis.
Known answer: crc16(b"123456789") == 0x29B1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from qpsk_tpu_torch import tracing
from qpsk_tpu_torch.packet.bits import bits_to_bytes, bytes_to_bits


@functools.lru_cache(maxsize=None)
def _crc_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.int64)
    for byte in range(256):
        x = byte ^ (byte >> 4)
        table[byte] = ((x << 12) ^ (x << 5) ^ x) & 0xFFFF
    return table


def crc16_np(data) -> int:
    """Host CRC over a uint8 array."""
    table = _crc_table()
    crc = 0xFFFF
    for byte in np.asarray(data, np.uint8).ravel():
        crc = ((crc << 8) & 0xFFFF) ^ int(table[((crc >> 8) ^ int(byte)) & 0xFF])
    return crc


def crc16(data: torch.Tensor) -> torch.Tensor:
    """CRC over the last axis of (..., n) bytes; returns (...,) int64."""
    with tracing.span("packet.crc"):
        tracing.count("sync.crc16.table")
        table = torch.from_numpy(_crc_table()).to(data.device)
        data = data.to(torch.int64)
        crc = torch.full(data.shape[:-1], 0xFFFF, dtype=torch.int64,
                         device=data.device)
        for i in range(data.shape[-1]):
            crc = ((crc << 8) & 0xFFFF) ^ table[((crc >> 8) ^ data[..., i])
                                                & 0xFF]
        return crc


def crc16_append_bits(payload_bits: torch.Tensor) -> torch.Tensor:
    """Append the 16 CRC bits of the payload bytes, high byte first."""
    crc = crc16(bits_to_bytes(payload_bits))
    crc_bytes = torch.stack([crc >> 8, crc & 0xFF], dim=-1)
    return torch.cat([payload_bits.to(torch.int32), bytes_to_bits(crc_bytes)],
                     dim=-1)


def crc16_check_bits(frame_bits: torch.Tensor) -> torch.Tensor:
    """(..., 8n+16) bits whose last 16 are the CRC -> (...,) bool."""
    crc_bytes = bits_to_bytes(frame_bits[..., -16:]).to(torch.int64)
    want = (crc_bytes[..., 0] << 8) | crc_bytes[..., 1]
    return crc16(bits_to_bytes(frame_bits[..., :-16])) == want
