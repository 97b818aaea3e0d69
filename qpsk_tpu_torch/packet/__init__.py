"""Packet layer: CRC16, DVB scrambler, golden-prime interleaver, and the
convolutional and LDPC codes."""

from qpsk_tpu_torch.packet.bits import (bits_to_bytes, bits_to_dibits,
                                        bytes_to_bits, dibits_to_bits)
from qpsk_tpu_torch.packet.crc16 import crc16, crc16_np
from qpsk_tpu_torch.packet.fec import (ConvCode, conv_encode, hard_llrs,
                                       viterbi_decode)
from qpsk_tpu_torch.packet.frame import (PacketConfig, RxPacket,
                                         assemble_packet, disassemble_packet,
                                         disassemble_packet_soft, unwrap_bits)
from qpsk_tpu_torch.packet.interleave import (deinterleave_bits,
                                              interleave_bits,
                                              interleave_permutation)
from qpsk_tpu_torch.packet.ldpc import (LdpcCode, ldpc_decode, ldpc_encode,
                                        ldpc_syndrome_weight)
from qpsk_tpu_torch.packet.scramble import keystream, scramble_bits
