"""Bit/byte packing, LSB-first within each byte (port of
``qpsk_tpu.packet.bits``).  Bits are int32 tensors of 0/1."""

from __future__ import annotations

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
