"""Frame sync for the uncoded QPSK link (port of ``qpsk_tpu.sync``: hard
decisions, no FEC).

The Costas loop locks with a 4-fold (90 degree) ambiguity, and the RX bit
stream is offset from packet boundaries by the FIR group delays, the
decimator's one-frame delay and the timing index.  ``find_sync`` scores
every (rotation x even bit lag) hypothesis by CRC passes over a probe window
in one batched evaluation; ``extract_packets`` slices the aligned stream
into packets.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qpsk_tpu_torch.packet.frame import (PacketConfig, RxPacket,
                                         disassemble_packet)

# One 90 degree CCW rotation permutes sliced dibit indices 0->1->3->2->0;
# _ROT_POW[r] is the permutation for r steps.
_ROT_STEP = np.array([1, 3, 0, 2], dtype=np.int64)
_ROT_POW = np.stack([np.arange(4, dtype=np.int64), _ROT_STEP,
                     _ROT_STEP[_ROT_STEP], _ROT_STEP[_ROT_STEP][_ROT_STEP]])


class SyncResult(NamedTuple):
    rotation: torch.Tensor   # int64 scalar, 90 degree steps
    bit_lag: torch.Tensor    # int64 scalar, bits into the stream
    score: torch.Tensor      # int64: CRC passes among probe frames


def default_max_lag(pcfg: PacketConfig) -> int:
    """Lag window that always covers a full packet."""
    return max(2 * pcfg.frame_bits, 600)


def rotate_dibits(bits: torch.Tensor, r) -> torch.Tensor:
    """Re-slice a bit stream (..., 2n) of [b1, b0] pairs under rotation
    hypothesis ``r`` (0..3)."""
    pairs = bits.to(torch.int64).reshape(bits.shape[:-1] + (-1, 2))
    m = (pairs[..., 0] << 1) | pairs[..., 1]
    m2 = torch.from_numpy(_ROT_POW).to(bits.device)[r][m]
    return torch.stack([(m2 >> 1) & 1, m2 & 1], dim=-1).reshape(bits.shape)


def find_sync(pcfg: PacketConfig, bits: torch.Tensor, max_lag: int = 512,
              probe_frames: int = 4) -> SyncResult:
    """The (rotation, even bit lag) with the most CRC passes over
    ``probe_frames`` consecutive packets of the 1-D ``bits`` stream.  A
    score of 0 means no sync."""
    if bits.dim() != 1:
        raise ValueError(f"find_sync takes a 1-D bit stream, got {tuple(bits.shape)}")
    streams = torch.stack([rotate_dibits(bits, r) for r in range(4)])
    return find_sync_streams(pcfg, streams, max_lag=max_lag,
                             probe_frames=probe_frames)


def find_sync_streams(pcfg: PacketConfig, streams: torch.Tensor,
                      max_lag: int = 512, probe_frames: int = 4) -> SyncResult:
    """``find_sync`` over pre-rotated streams (R, n), one row per rotation
    hypothesis; lags are even, since QPSK packet grids are dibit-aligned."""
    fb = pcfg.frame_bits
    nrot = streams.shape[0]
    avail = int(streams.shape[-1]) - probe_frames * fb
    if avail < 2:
        raise ValueError(
            f"find_sync needs at least {probe_frames * fb + 2} bits "
            f"({probe_frames} probe frames of {fb} bits + a lag window), "
            f"got {streams.shape[-1]}")
    dev = streams.device
    lags = torch.arange(0, min(max_lag, avail), 2, device=dev)
    window = torch.arange(probe_frames * fb, device=dev)
    cand = streams[:, lags[:, None] + window[None, :]]          # (R, L, W)
    frames = cand.reshape(nrot, lags.shape[0], probe_frames, fb)
    score = disassemble_packet(pcfg, frames).crc_ok.sum(-1)     # (R, L)
    flat = torch.argmax(score.reshape(-1))
    return SyncResult(rotation=flat // lags.shape[0],
                      bit_lag=lags[flat % lags.shape[0]],
                      score=score.reshape(-1)[flat])


def extract_packets(pcfg: PacketConfig, bits: torch.Tensor,
                    sync: SyncResult, nframes: int) -> RxPacket:
    """Slice ``nframes`` aligned packets out of a 1-D bit stream and
    disassemble them."""
    fb = pcfg.frame_bits
    idx = sync.bit_lag + torch.arange(nframes * fb, device=bits.device)
    aligned = rotate_dibits(bits[idx], sync.rotation)
    return disassemble_packet(pcfg, aligned.reshape(nframes, fb))
