"""Packet framing (port of ``qpsk_tpu.packet.frame``).

TX:  payload bits -> CRC16 append -> [FEC encode] -> DVB scramble ->
     golden-prime interleave
RX:  deinterleave -> descramble -> [FEC decode] -> CRC16 check

``fec`` is False (uncoded), True or "conv" (K=7 (133, 171) convolutional
code, soft Viterbi, ``packet/fec.py``) or "ldpc" (IRA LDPC, min-sum,
``packet/ldpc.py``).  The scrambler is re-seeded per frame, so frames are
independent.  The soft receive path runs in the LLR domain: deinterleave is
the same gather on floats and descrambling flips the LLR's sign.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from qpsk_tpu_torch import tracing
from qpsk_tpu_torch.packet.crc16 import crc16_append_bits, crc16_check_bits
from qpsk_tpu_torch.packet.fec import (ConvCode, conv_encode, hard_llrs,
                                       viterbi_decode)
from qpsk_tpu_torch.packet.interleave import deinterleave_bits, interleave_bits
from qpsk_tpu_torch.packet.ldpc import LdpcCode, ldpc_decode, ldpc_encode
from qpsk_tpu_torch.packet.scramble import keystream, scramble_bits


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

    @property
    def fec_kind(self):
        """None | 'conv' | 'ldpc' (True normalizes to 'conv')."""
        if not self.fec:
            return None
        return "conv" if self.fec is True else self.fec

    @property
    def payload_crc_bits(self) -> int:
        return 8 * self.payload_bytes + 16

    @property
    def frame_bits(self) -> int:
        kind = self.fec_kind
        if kind == "conv":
            return ConvCode().coded_bits(self.payload_crc_bits)
        if kind == "ldpc":
            return 2 * self.payload_crc_bits
        return self.payload_crc_bits

    def ldpc_code(self) -> LdpcCode:
        return LdpcCode(k=self.payload_crc_bits)


class RxPacket(NamedTuple):
    payload_bits: torch.Tensor  # (..., 8*payload_bytes)
    crc_ok: torch.Tensor        # (...,) bool


def _check_width(bits: torch.Tensor, want: int, what: str) -> None:
    if bits.shape[-1] != want:
        raise ValueError(f"{what} of {bits.shape[-1]} bits, expected {want}")


def assemble_packet(pcfg: PacketConfig,
                    payload_bits: torch.Tensor) -> torch.Tensor:
    """(..., 8*payload_bytes) payload bits -> (..., frame_bits) channel bits."""
    _check_width(payload_bits, 8 * pcfg.payload_bytes, "payload")
    bits = crc16_append_bits(payload_bits)
    if pcfg.fec_kind == "conv":
        bits = conv_encode(ConvCode(), bits)
    elif pcfg.fec_kind == "ldpc":
        bits = ldpc_encode(pcfg.ldpc_code(), bits)
    if pcfg.scramble:
        bits = scramble_bits(bits, pcfg.scramble_seed)
    if pcfg.interleave:
        bits = interleave_bits(bits)
    return bits


def unwrap_bits(pcfg: PacketConfig, bits: torch.Tensor) -> torch.Tensor:
    """Undo the channel wrapping only (deinterleave + descramble): the
    codeword or CRC bits, which the LDPC syndrome sync metric scores."""
    _check_width(bits, pcfg.frame_bits, "frame")
    if pcfg.interleave:
        bits = deinterleave_bits(bits)
    if pcfg.scramble:
        bits = scramble_bits(bits, pcfg.scramble_seed)
    return bits


def disassemble_packet(pcfg: PacketConfig, bits: torch.Tensor) -> RxPacket:
    """(..., frame_bits) received hard bits -> payload + CRC verdict.  With
    FEC on this decodes the hard bits as unit LLRs."""
    if pcfg.fec:
        return disassemble_packet_soft(pcfg, hard_llrs(bits))
    with tracing.span("packet.disassemble"):
        bits = unwrap_bits(pcfg, bits)
        return RxPacket(payload_bits=bits[..., :-16],
                        crc_ok=crc16_check_bits(bits))


def disassemble_packet_soft(pcfg: PacketConfig,
                            llrs: torch.Tensor) -> RxPacket:
    """(..., frame_bits) received LLRs (positive = bit 0, see
    ``modmap.demod_soft``) -> payload + CRC verdict: deinterleave, flip
    the sign where the keystream is 1, then decode."""
    _check_width(llrs, pcfg.frame_bits, "frame")
    with tracing.span("packet.disassemble"):
        llrs = llrs.to(torch.float32)
        if pcfg.interleave:
            llrs = deinterleave_bits(llrs)
        if pcfg.scramble:
            ks = torch.from_numpy(keystream(pcfg.frame_bits,
                                            pcfg.scramble_seed))
            tracing.count("sync.frame.keystream")
            llrs = llrs * (1 - 2 * ks).to(torch.float32).to(llrs.device)
        if pcfg.fec_kind == "conv":
            with tracing.span("packet.decode"):
                bits = viterbi_decode(ConvCode(), llrs, pcfg.payload_crc_bits)
        elif pcfg.fec_kind == "ldpc":
            with tracing.span("packet.decode"):
                bits = ldpc_decode(pcfg.ldpc_code(), llrs)
        else:
            bits = (llrs < 0).to(torch.int32)
        return RxPacket(payload_bits=bits[..., :-16],
                        crc_ok=crc16_check_bits(bits))
