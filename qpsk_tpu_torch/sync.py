"""Frame sync, hard and soft (port of ``qpsk_tpu.sync``).

The Costas loop locks with an ``n_rot``-fold ambiguity (QPSK and 16QAM 4,
BPSK 2, 8PSK 8), and the RX bit stream is offset from packet boundaries by
the FIR group delays, the decimator's one-frame delay and the timing
index.  ``find_sync`` scores every (rotation x bit lag) hypothesis over a
probe window in one batched evaluation: by CRC passes (uncoded, or
conv-coded after a Viterbi decode of every hypothesis), or for LDPC by
the decode-free syndrome weight.  QPSK hunts even lags; the generic
family every lag, since a packet grid need not fall on a symbol (8PSK's
frame_bits is not a multiple of 3), so its streams are rotated whole
(``rotated_streams``) and sliced at any bit.  ``extract_packets`` slices
the aligned stream into packets; the tracked extractors decode every
rotation (and lag-shift) hypothesis of every packet and walk a track on
the host, so a carrier cycle slip costs at most the packet it lands in.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qpsk_tpu_torch import tracing
from qpsk_tpu_torch.ops import modfam
from qpsk_tpu_torch.packet.frame import (PacketConfig, RxPacket,
                                         disassemble_packet,
                                         disassemble_packet_soft, unwrap_bits)
from qpsk_tpu_torch.packet.ldpc import ldpc_syndrome_weight

# One 90 degree CCW rotation permutes sliced dibit indices 0->1->3->2->0;
# _ROT_POW[r] is the permutation for r steps.
_ROT_STEP = np.array([1, 3, 0, 2], dtype=np.int64)
_ROT_POW = np.stack([np.arange(4, dtype=np.int64), _ROT_STEP,
                     _ROT_STEP[_ROT_STEP], _ROT_STEP[_ROT_STEP][_ROT_STEP]])


class SyncResult(NamedTuple):
    rotation: torch.Tensor   # int64 scalar, ambiguity steps
    bit_lag: torch.Tensor    # int64 scalar, bits into the stream
    score: torch.Tensor      # int64: probe frames that pass


def default_max_lag(pcfg: PacketConfig) -> int:
    """Lag window that always covers a full packet."""
    return max(2 * pcfg.frame_bits, 600)


def rotate_dibits(bits: torch.Tensor, r) -> torch.Tensor:
    """Re-slice a bit stream (..., 2n) of [b1, b0] pairs under rotation
    hypothesis ``r`` (0..3)."""
    pairs = bits.to(torch.int64).reshape(bits.shape[:-1] + (-1, 2))
    m = (pairs[..., 0] << 1) | pairs[..., 1]
    tracing.count("sync.rotation.table")
    m2 = torch.from_numpy(_ROT_POW).to(bits.device)[r][m]
    return torch.stack([(m2 >> 1) & 1, m2 & 1], dim=-1).reshape(bits.shape)


def rotate_soft(llrs: torch.Tensor, r) -> torch.Tensor:
    """Soft twin of ``rotate_dibits``: one 90 degree CCW step maps the
    per-symbol LLR pair (l1, l0) = (im, re) to (l0, -l1).  ``r`` is an int
    or an integer scalar tensor."""
    pairs = llrs.to(torch.float32).reshape(llrs.shape[:-1] + (-1, 2))
    a, b = pairs[..., 0], pairs[..., 1]
    cands = []
    for _ in range(4):
        cands.append(torch.stack([a, b], dim=-1))
        a, b = b, -a
    return torch.stack(cands)[r].reshape(llrs.shape)


def rotated_streams(bits: torch.Tensor | None, modulation: str = "qpsk",
                    soft: torch.Tensor | None = None) -> torch.Tensor:
    """Every rotation hypothesis of a symbol-aligned 1-D demodulated
    stream, (n_rot, n): the hard ``bits`` re-sliced per hypothesis, or,
    given ``soft`` instead (an (nsym, M) ``modfam.symbol_scores``
    matrix of a generic-family stream), the max-log LLR stream of each."""
    if modulation == "qpsk":
        if soft is not None:
            raise ValueError("QPSK soft streams come from rotate_soft")
        return torch.stack([rotate_dibits(bits, r) for r in range(4)])
    mod = modfam.get(modulation)
    if soft is not None:
        return torch.stack([modfam.soft_from_scores(soft, mod, r)
                            for r in range(mod.n_rot)])
    return torch.stack([modfam.rotate_bits_mod(bits, r, mod)
                        for r in range(mod.n_rot)])


def _mod_geometry(modulation: str) -> tuple[int, int, int]:
    """(n_rot, bps, lag_step) of a modulation's hypothesis grid: QPSK
    hunts even lags (its packet grids are dibit-aligned), the generic
    family every lag."""
    if modulation == "qpsk":
        return 4, 2, 2
    mod = modfam.get(modulation)
    return mod.n_rot, mod.bps, 1


def find_sync(pcfg: PacketConfig, bits: torch.Tensor, max_lag: int = 512,
              probe_frames: int = 4, modulation: str = "qpsk") -> SyncResult:
    """The (rotation, bit lag) with the most passing packets over
    ``probe_frames`` consecutive packets of the 1-D symbol-aligned
    ``bits`` stream: even lags and 4 rotations for QPSK, every lag and
    the constellation's ``n_rot`` rotations for the generic family.  A
    score of 0 means no sync."""
    if bits.dim() != 1:
        raise ValueError(f"find_sync takes a 1-D bit stream, got {tuple(bits.shape)}")
    return find_sync_streams(pcfg, rotated_streams(bits, modulation),
                             max_lag=max_lag, probe_frames=probe_frames,
                             lag_step=_mod_geometry(modulation)[2])


def find_sync_streams(pcfg: PacketConfig, streams: torch.Tensor,
                      max_lag: int = 512, probe_frames: int = 4,
                      lag_step: int = 2, soft: bool = False) -> SyncResult:
    """``find_sync`` over pre-rotated streams (R, n), one row per rotation
    hypothesis (``rotated_streams``, or ``rotate_soft``'s LLR rows with
    ``soft``), at lags ``0, lag_step, ...``: 2 for QPSK, 1 for the
    generic family.  Soft conv-coded probes are decoded soft; LDPC probes
    are scored by syndrome weight on the LLR signs (a frame passes below
    0.35*m violated checks)."""
    fb = pcfg.frame_bits
    nrot = streams.shape[0]
    avail = int(streams.shape[-1]) - probe_frames * fb
    if avail < 2:
        raise ValueError(
            f"find_sync needs at least {probe_frames * fb + 2} bits "
            f"({probe_frames} probe frames of {fb} bits + a lag window), "
            f"got {streams.shape[-1]}")
    dev = streams.device
    lags = torch.arange(0, min(max_lag, avail), lag_step, device=dev)
    window = torch.arange(probe_frames * fb, device=dev)
    cand = streams[:, lags[:, None] + window[None, :]]          # (R, L, W)
    frames = cand.reshape(nrot, lags.shape[0], probe_frames, fb)
    if pcfg.fec_kind == "ldpc":
        if soft:
            frames = (frames < 0).to(torch.int32)    # LLR signs -> bits
        code = pcfg.ldpc_code()
        syn = ldpc_syndrome_weight(code, unwrap_bits(pcfg, frames))
        ok = syn < int(0.35 * code.m)                           # (R, L, P)
    elif soft:
        ok = disassemble_packet_soft(pcfg, frames).crc_ok
    else:
        ok = disassemble_packet(pcfg, frames).crc_ok
    score = ok.sum(-1)                                          # (R, L)
    flat = torch.argmax(score.reshape(-1))
    return SyncResult(rotation=flat // lags.shape[0],
                      bit_lag=lags[flat % lags.shape[0]],
                      score=score.reshape(-1)[flat])


def extract_packets(pcfg: PacketConfig, bits: torch.Tensor,
                    sync: SyncResult, nframes: int,
                    modulation: str = "qpsk") -> RxPacket:
    """Slice ``nframes`` aligned packets out of a 1-D symbol-aligned bit
    stream and disassemble them.  A generic-family stream is rotated
    whole before the slice, since its packets need not start on a
    symbol."""
    fb = pcfg.frame_bits
    idx = sync.bit_lag + torch.arange(nframes * fb, device=bits.device)
    if modulation == "qpsk":
        aligned = rotate_dibits(bits[idx], sync.rotation)
    else:
        aligned = modfam.rotate_bits_mod(bits, sync.rotation,
                                         modfam.get(modulation))[idx]
    return disassemble_packet(pcfg, aligned.reshape(nframes, fb))


def extract_packets_soft(pcfg: PacketConfig, llrs: torch.Tensor,
                         sync: SyncResult, nframes: int) -> RxPacket:
    """Soft twin of ``extract_packets`` over a 1-D LLR stream
    (``modmap.demod_soft`` of the derotated symbols, aligned with the hard
    bit stream)."""
    fb = pcfg.frame_bits
    idx = sync.bit_lag + torch.arange(nframes * fb, device=llrs.device)
    aligned = rotate_soft(llrs[idx], sync.rotation)
    return disassemble_packet_soft(pcfg, aligned.reshape(nframes, fb))


def extract_packets_soft_mod(pcfg: PacketConfig, scores: torch.Tensor,
                             sync: SyncResult, nframes: int,
                             modulation: str) -> RxPacket:
    """Generic-family twin of ``extract_packets_soft``: the packets of the
    (nsym, M) score matrix (``modfam.symbol_scores`` of the demodulated
    symbols) under the sync's rotation."""
    fb = pcfg.frame_bits
    streams = rotated_streams(None, modulation, soft=scores)
    idx = sync.bit_lag + torch.arange(nframes * fb, device=scores.device)
    aligned = streams[sync.rotation][idx]
    return disassemble_packet_soft(pcfg, aligned.reshape(nframes, fb))


class TrackedPackets(NamedTuple):
    payload_bits: torch.Tensor  # (nframes, 8*payload_bytes)
    crc_ok: torch.Tensor        # (nframes,) bool
    rotation: torch.Tensor      # (nframes,) int32, rotation used per packet
    shift: torch.Tensor         # (nframes,) int32, bit-lag shift used


def walk_step(ok_j: np.ndarray, shifts: np.ndarray, cur_r: int,
              cur_s: int, max_step: int = 2) -> tuple[bool, int, int]:
    """One packet's hypothesis walk: keep the tracked (rotation,
    shift-index) if it passes CRC, else try shifts ordered by distance
    from the track (at most ``max_step`` bits away), any rotation.
    ``ok_j`` is the (n_rot, S) verdict grid of this packet.  Returns
    (good, rotation, shift_index); on failure the track is unchanged."""
    if ok_j[cur_r, cur_s]:
        return True, cur_r, cur_s
    for si in sorted(range(len(shifts)),
                     key=lambda k: (abs(shifts[k] - shifts[cur_s]), k)):
        if abs(shifts[si] - shifts[cur_s]) > max_step:
            continue
        passing = np.flatnonzero(ok_j[:, si])
        if passing.size:
            return True, int(passing[0]), si
    return False, cur_r, cur_s


def _track_hypotheses(rx: RxPacket, start_rot: int, shifts: np.ndarray,
                      max_step: int = 2) -> TrackedPackets:
    """Walk the (rotation x lag-shift) track over all-hypothesis verdicts
    (n_rot, S, nframes) on the host: a passing hypothesis wins and moves
    the track, a failed packet decodes at the track."""
    ok = rx.crc_ok.cpu().numpy()                    # (R, S, nframes)
    payloads = rx.payload_bits.cpu().numpy()        # (R, S, nframes, bits)
    nframes = ok.shape[2]
    cur_r, cur_s = start_rot, int(np.flatnonzero(shifts == 0)[0])
    rot_used = np.zeros(nframes, np.int32)
    shift_used = np.zeros(nframes, np.int32)
    out_ok = np.zeros(nframes, bool)
    out_payload = np.zeros((nframes, payloads.shape[-1]), payloads.dtype)
    for j in range(nframes):
        good, r, s = walk_step(ok[:, :, j], shifts, cur_r, cur_s, max_step)
        out_ok[j] = good
        if good:
            cur_r, cur_s = r, s
        rot_used[j] = r
        shift_used[j] = shifts[s]
        out_payload[j] = payloads[r, s, j]
    dev = rx.crc_ok.device
    return TrackedPackets(*(torch.from_numpy(x).to(dev) for x in
                            (out_payload, out_ok, rot_used, shift_used)))


def _shift_set(max_slip: int, bps: int = 2) -> np.ndarray:
    """Symbol-granular bit-lag shifts covering +-max_slip symbol slips
    (one symbol = ``bps`` bits)."""
    return np.arange(-bps * max_slip, bps * max_slip + 1, bps, dtype=np.int32)


def _tracked_from_streams(pcfg: PacketConfig, streams: torch.Tensor,
                          sync: SyncResult, nframes: int, shifts: np.ndarray,
                          bps: int, soft: bool) -> TrackedPackets:
    """Gather every (rotation x lag-shift) hypothesis span of the
    per-rotation streams (R, n), disassemble all of them in one batched
    pass, then walk the CRC track at most one symbol (``bps`` bits) a
    packet."""
    fb = pcfg.frame_bits
    dev = streams.device
    base = sync.bit_lag + torch.arange(nframes * fb, device=dev)
    idx = torch.clamp(base[None, :] + torch.from_numpy(shifts).to(dev)[:, None],
                      0, streams.shape[-1] - 1)             # (S, nframes*fb)
    cand = streams[:, idx].reshape(streams.shape[0], len(shifts), nframes, fb)
    rx = (disassemble_packet_soft(pcfg, cand) if soft
          else disassemble_packet(pcfg, cand))
    return _track_hypotheses(rx, int(sync.rotation), shifts, max_step=bps)


def extract_packets_tracked(pcfg: PacketConfig, bits: torch.Tensor,
                            sync: SyncResult, nframes: int,
                            max_slip: int = 0,
                            modulation: str = "qpsk") -> TrackedPackets:
    """``extract_packets`` that recovers from carrier cycle slips (every
    packet is decoded under all ``n_rot`` rotations) and, with
    ``max_slip`` > 0, from symbol slips of up to ``max_slip`` symbols
    (lag shifts of +-bps bits per symbol; leave that many bits of
    headroom at the end)."""
    _, bps, _ = _mod_geometry(modulation)
    return _tracked_from_streams(pcfg, rotated_streams(bits, modulation),
                                 sync, nframes, _shift_set(max_slip, bps),
                                 bps, soft=False)


def extract_packets_soft_tracked(pcfg: PacketConfig, llrs: torch.Tensor,
                                 sync: SyncResult, nframes: int,
                                 max_slip: int = 0) -> TrackedPackets:
    """Soft twin of ``extract_packets_tracked`` over a 1-D LLR stream: the
    robust low-SNR path, where FEC operates and cycle slips are routine."""
    streams = torch.stack([rotate_soft(llrs, r) for r in range(4)])
    return _tracked_from_streams(pcfg, streams, sync, nframes,
                                 _shift_set(max_slip), 2, soft=True)


def extract_packets_soft_tracked_mod(pcfg: PacketConfig,
                                     scores: torch.Tensor, sync: SyncResult,
                                     nframes: int, modulation: str,
                                     max_slip: int = 0) -> TrackedPackets:
    """Generic-family twin of ``extract_packets_soft_tracked`` over an
    (nsym, M) score matrix (``modfam.symbol_scores`` of the demodulated
    symbols): each rotation's LLR stream is a relabelling of it."""
    _, bps, _ = _mod_geometry(modulation)
    return _tracked_from_streams(
        pcfg, rotated_streams(None, modulation, soft=scores), sync, nframes,
        _shift_set(max_slip, bps), bps, soft=True)
