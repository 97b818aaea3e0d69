"""Uncoded packet framing (port of ``qpsk_tpu.packet.frame``).

TX:  payload bits -> CRC16 append -> DVB scramble -> golden-prime interleave
RX:  deinterleave -> descramble -> CRC16 check

The scrambler is re-seeded per frame, so frames are independent.  The coded
links (``fec="conv"`` / ``"ldpc"``) are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from qpsk_tpu_torch.packet.crc16 import crc16_append_bits, crc16_check_bits
from qpsk_tpu_torch.packet.interleave import deinterleave_bits, interleave_bits
from qpsk_tpu_torch.packet.scramble import scramble_bits


@dataclasses.dataclass(frozen=True)
class PacketConfig:
    """Static framing parameters (same fields as the JAX package's)."""
    payload_bytes: int = 30
    scramble_seed: int = 0x4A80
    scramble: bool = True
    interleave: bool = True
    fec: bool | str = False

    def __post_init__(self):
        if self.fec not in (False, True, "conv", "ldpc"):
            raise ValueError(f"unknown fec {self.fec!r}")
        if self.fec is not False:
            raise NotImplementedError(
                f"fec={self.fec!r}: the coded links are not ported yet")

    @property
    def payload_crc_bits(self) -> int:
        return 8 * self.payload_bytes + 16

    @property
    def frame_bits(self) -> int:
        return self.payload_crc_bits


class RxPacket(NamedTuple):
    payload_bits: torch.Tensor  # (..., 8*payload_bytes)
    crc_ok: torch.Tensor        # (...,) bool


def assemble_packet(pcfg: PacketConfig,
                    payload_bits: torch.Tensor) -> torch.Tensor:
    """(..., 8*payload_bytes) payload bits -> (..., frame_bits) channel bits."""
    if payload_bits.shape[-1] != 8 * pcfg.payload_bytes:
        raise ValueError(f"payload of {payload_bits.shape[-1]} bits, "
                         f"expected {8 * pcfg.payload_bytes}")
    bits = crc16_append_bits(payload_bits)
    if pcfg.scramble:
        bits = scramble_bits(bits, pcfg.scramble_seed)
    if pcfg.interleave:
        bits = interleave_bits(bits)
    return bits


def disassemble_packet(pcfg: PacketConfig, bits: torch.Tensor) -> RxPacket:
    """(..., frame_bits) received hard bits -> payload + CRC verdict."""
    if bits.shape[-1] != pcfg.frame_bits:
        raise ValueError(f"frame of {bits.shape[-1]} bits, "
                         f"expected {pcfg.frame_bits}")
    if pcfg.interleave:
        bits = deinterleave_bits(bits)
    if pcfg.scramble:
        bits = scramble_bits(bits, pcfg.scramble_seed)
    return RxPacket(payload_bits=bits[..., :-16],
                    crc_ok=crc16_check_bits(bits))
