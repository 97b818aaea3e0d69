"""Bit/byte packing, LSB-first within each byte (port of
``qpsk_tpu.packet.bits``).  Bits are int32 tensors of 0/1; the ``np_``
twins do the same on host arrays."""

from __future__ import annotations

import numpy as np
import torch


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """(..., n) bytes -> (..., 8n) bits."""
    shifts = torch.arange(8, dtype=torch.int32, device=data.device)
    bits = (data.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(data.shape[:-1] + (data.shape[-1] * 8,))


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8n) bits -> (..., n) uint8."""
    b = bits.to(torch.int32).reshape(bits.shape[:-1] + (-1, 8))
    weights = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    return (b * weights).sum(-1).to(torch.uint8)


def np_bytes_to_bits(data: np.ndarray) -> np.ndarray:
    """Host-side twin of ``bytes_to_bits`` (numpy): (..., n) bytes ->
    (..., 8n) int32 bits."""
    data = np.asarray(data, np.uint8)
    return ((data[..., None] >> np.arange(8)) & 1).reshape(
        data.shape[:-1] + (data.shape[-1] * 8,)).astype(np.int32)


def np_bits_to_bytes(bits: np.ndarray) -> np.ndarray:
    """Host-side twin of ``bits_to_bytes`` (numpy): (..., 8n) bits ->
    (..., n) uint8."""
    bits = np.asarray(bits, np.int32)
    b = bits.reshape(bits.shape[:-1] + (bits.shape[-1] // 8, 8))
    return (b * (1 << np.arange(8))).sum(-1).astype(np.uint8)
