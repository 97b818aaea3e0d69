"""Streaming runtime: push-mode demodulation with automatic sync (port of
``qpsk_tpu.runtime``).

    demod = StreamDemodulator(ModemConfig(), PacketConfig(payload_bytes=30))
    for chunk in audio_source:          # int16 PCM, any chunk size
        for pkt in demod.push(chunk):   # bit-exact payloads as they decode
            handle(pkt.payload)

One stream per object, on the card unless the caller passes
``device="cpu"`` (without a card the constructor raises).  Behaviour, as
in the JAX package:

* arbitrary chunk sizes: samples are buffered to whole frames and
  demodulated in fixed buckets of ``bucket_frames`` frames (``flush``
  demodulates the remainder a frame at a time); squelch and the
  acquisition candidate rotation act per bucket;
* FFT acquisition warm-starts the Costas loop on a cold bucket (when
  ``cfg.acquisition == "fft"``) with the first of the two
  ``rx_acquire_hz`` candidates; when the CRC hunt rejects two windows of
  bits demodulated under a candidate, the next bucket cold-restarts on
  the next one, then on the seed grid of ``ops.acquire
  .sweep_candidates_hz`` (``sweep_hz`` tunes it): a receiver whose
  acquisition parks on an M-power spur recovers;
* packet sync (rotation + alignment) is a CRC-scored hunt over the
  buffered post-transient bits, then CRC-tracked: carrier cycle slips and,
  with ``slip_track`` > 0, symbol slips cost one packet each; every
  drained span decodes all rotation x lag-shift hypotheses in one batched
  pass (one decoder launch with FEC);
* with ``pcfg.fec`` the receiver buffers LLRs beside the hard bits and
  hunts and drains soft;
* ``squelch_db``: a blind M2M4 SNR estimate of each bucket (3 dB of
  hysteresis) gates the hunt; a squelched bucket's bits are dropped after
  the bits buffered ahead of them are drained, and the loop cold-restarts;
* ``resync_after`` consecutive CRC failures drop sync and re-arm the hunt;
* ``save`` / ``load`` checkpoint the whole receiver (``.npz``, the same
  arrays as the JAX package's, so either package resumes the other's).

Each bucket is one host-to-device copy of its PCM, one ``rx_stream`` call
and one device-to-host copy of what the host needs (the loop frequency,
the symbols for the SNR estimate, every rotation's bits and LLRs); the
SNR estimate runs on the host, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from qpsk_tpu_torch import tracing
from qpsk_tpu_torch.config import ModemConfig
from qpsk_tpu_torch.metrics import snr_estimate_db_host
from qpsk_tpu_torch.modem import rx_acquire_hz, rx_stream, tx_stream
from qpsk_tpu_torch.ops import modfam
from qpsk_tpu_torch.ops.acquire import hz_to_costas_freq, sweep_candidates_hz
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.modmap import demod_soft
from qpsk_tpu_torch.packet.frame import (PacketConfig, assemble_packet,
                                         disassemble_packet,
                                         disassemble_packet_soft)
from qpsk_tpu_torch.state import flatten, rx_init, tx_init, unflatten
from qpsk_tpu_torch.sync import (SyncResult, _mod_geometry, default_max_lag,
                                 find_sync_streams, rotate_soft,
                                 rotated_streams, walk_step)
from qpsk_tpu_torch.utils.checkpoint import savez_exact


class Packet(NamedTuple):
    payload: np.ndarray   # (8*payload_bytes,) bits
    crc_ok: bool
    stream_index: int     # packet index within the current sync epoch


@dataclasses.dataclass
class LinkCounters:
    frames: int = 0
    packets: int = 0
    crc_failures: int = 0
    resyncs: int = 0
    detected_offset_hz: float = 0.0
    synced: bool = False
    # blind M2M4 SNR estimate of the last demodulated bucket (dB) and the
    # squelch / carrier-detect verdict derived from it
    carrier_snr_db: float = float("nan")
    carrier_detect: bool = False


def _on(device) -> torch.device:
    """``device`` as a torch device, checked to exist: without a card a
    CUDA device raises here, as ``tx_init`` / ``rx_init`` do."""
    dev = torch.device(device)
    torch.empty(0, device=dev)
    return dev


class StreamModulator:
    """Push-mode packet transmitter, the TX twin of ``StreamDemodulator``:

        mod = StreamModulator(ModemConfig(), PacketConfig(payload_bytes=30))
        for payloads in source:            # (npkts, 8*payload_bytes) bits
            audio_sink(mod.push(payloads)) # int16 PCM, filter-continuous

    The TX filter tail and NCO phase carry across calls, so chunked pushes
    match one ``tx_stream`` over the concatenated packets within the PCM
    bounds (the carried phasor re-associates one complex product a call
    boundary).  A push is one ``tx_stream`` call over its whole packets;
    for a constellation whose bits per symbol do not divide the packet
    (8PSK), the sub-symbol remainder of channel bits stays pending until
    the next push or ``flush``."""

    def __init__(self, cfg: ModemConfig, pcfg: PacketConfig,
                 tx_offset_hz: float = 0.0, device="cuda"):
        self.cfg = cfg
        self.pcfg = pcfg
        self.tx_offset_hz = tx_offset_hz
        self._dev = _on(device)
        self._state = tx_init(cfg, device=self._dev)
        bps = cfg.bits_per_symbol
        self._aligned = pcfg.frame_bits % bps == 0
        self._chunk_bits = bps * ((pcfg.frame_bits + bps - 1) // bps)
        self._pend = np.zeros(0, np.int32)

    def _tx(self, rows: torch.Tensor) -> np.ndarray:
        self._state, pcm = tx_stream(self.cfg, self._state, rows,
                                     tx_offset_hz=self.tx_offset_hz)
        return pcm.reshape(-1).cpu().numpy()

    def push(self, payload_bits) -> np.ndarray:
        """Modulate (npkts, 8*payload_bytes) (or one flat packet of)
        payload bits; returns the int16 passband PCM."""
        p = np.asarray(payload_bits, np.int32)
        if p.ndim == 1:
            p = p[None, :]
        if p.ndim != 2 or p.shape[-1] != 8 * self.pcfg.payload_bytes:
            raise ValueError(f"payload bits of shape {p.shape}, expected "
                             f"(npkts, {8 * self.pcfg.payload_bytes})")
        chan = assemble_packet(self.pcfg, torch.from_numpy(p).to(self._dev))
        if self._aligned:
            rows = chan
        else:
            self._pend = np.concatenate([self._pend,
                                         chan.reshape(-1).cpu().numpy()])
            cb = self._chunk_bits
            nrows = self._pend.size // cb
            rows = torch.from_numpy(
                self._pend[:nrows * cb].reshape(nrows, cb)).to(self._dev)
            self._pend = self._pend[nrows * cb:]
        if rows.shape[0] == 0:
            return np.zeros(0, np.int16)
        return self._tx(rows)

    def flush(self) -> np.ndarray:
        """Modulate any pending sub-chunk bits, zero-padded to a whole
        symbol (filler after the last packet).  QPSK never holds bits."""
        if not self._pend.size:
            return np.zeros(0, np.int16)
        pad = (-self._pend.size) % self.cfg.bits_per_symbol
        bits = np.concatenate([self._pend, np.zeros(pad, np.int32)])
        self._pend = self._pend[:0]
        return self._tx(torch.from_numpy(bits[None, :]).to(self._dev))

    def save(self, path) -> None:
        """Checkpoint the transmitter: the carried TX state (filter tail,
        NCO phasor, DQPSK phase index) and the pending sub-symbol bits.  Resume with ``load``
        on a StreamModulator built with the same cfg / pcfg / offset."""
        arrays = {"pend": self._pend}
        for i, leaf in enumerate(flatten(self._state)):
            arrays[f"tx_leaf_{i}"] = leaf.cpu().numpy()
        savez_exact(path, **arrays)

    def load(self, path) -> None:
        """Restore a checkpoint written by ``save`` (of either package)."""
        data = np.load(path)
        self._pend = data["pend"].astype(np.int32)
        like = tx_init(self.cfg, device=self._dev)
        self._state = unflatten(like, [data[f"tx_leaf_{i}"]
                                       for i in range(len(flatten(like)))])


class StreamDemodulator:
    """Push-mode packet receiver (see the module docstring).

    The bit and LLR buffers hold every rotation hypothesis of the stream,
    (n_rot, n), each row the demodulated stream under one carrier rotation
    (``sync.rotated_streams``), computed per bucket while the stream head
    is symbol-aligned; consumption then works at any bit offset."""

    def __init__(self, cfg: ModemConfig, pcfg: PacketConfig,
                 sync_skip_frames: int = 2, probe_frames: int | None = None,
                 resync_after: int = 8, bucket_frames: int = 8,
                 slip_track: int = 1, squelch_db: float | None = None,
                 sweep_hz=None, device="cuda"):
        self.cfg = cfg
        self.pcfg = pcfg
        self._dev = _on(device)
        # the hunt starts this many packet frames into the stream (the
        # post-onset transient); it is CRC-scored, so hunting transient
        # bits costs work, never a false sync
        self.sync_skip = sync_skip_frames * pcfg.frame_bits
        self._sync_skip0 = self.sync_skip
        # 8 probe packets for coded links (their sync floor then meets the
        # decode floor), 4 uncoded
        if probe_frames is None:
            probe_frames = 8 if pcfg.fec else 4
        self.probe_frames = probe_frames
        self.resync_after = resync_after
        self.bucket_frames = bucket_frames
        # None: always hunt; else open at squelch_db, close 3 dB below
        self.squelch_db = squelch_db
        # per-drain hypotheses also span bit-lag shifts of +-bps*slip_track
        self.slip_track = slip_track
        self._nrot, self._bps, self._lag_step = _mod_geometry(cfg.modulation)
        self._hw = self._bps * slip_track   # bit headroom at each end
        self.counters = LinkCounters()
        # the acquisition of a cold bucket: its two candidate offsets, Hz
        # (a test may replace it)
        self._acquire = functools.partial(rx_acquire_hz, cfg, candidates=2)
        self._sweep_hz = (sweep_candidates_hz() if sweep_hz is None
                          else np.asarray(sweep_hz, np.float32))
        self._acq_idx = 0    # which candidate the current epoch uses
        self._acq_bits = 0   # bits the hunt rejected on this candidate
        # the buffer prefix demodulated under the previous candidate after
        # a rotation: its rejections do not count against the new one
        self._acq_stale = 0
        # two rejected hunt windows per candidate before rotating
        self._acq_rotate_bits = 2 * default_max_lag(pcfg)

        self._pcm_buf = np.zeros(0, np.int16)
        self._bit_buf = np.zeros((self._nrot, 0), np.int32)
        # with FEC a parallel LLR buffer feeds the soft hunt and drain;
        # DQPSK's bits have no per-bit LLRs, so it decodes hard input
        # (unit LLRs, about 2 dB behind the soft decoder)
        self._use_soft = bool(pcfg.fec) and not cfg.differential
        self._llr_buf = np.zeros((self._nrot, 0), np.float32)
        self._state = None
        self._sync: SyncResult | None = None
        self._rotation = 0
        self._consecutive_bad = 0
        self._pkt_index = 0
        # the last bps*slip_track consumed bits of each rotation row (the
        # negative-shift hypotheses read back into them)
        self._lead = np.zeros((self._nrot, self._hw), np.int32)
        self._lead_llr = np.zeros((self._nrot, self._hw), np.float32)

    # ------------------------------------------------------------------
    def push(self, pcm) -> list[Packet]:
        """Feed int16 PCM of any length; returns the packets decoded so
        far.  Eager: buffering and demodulation happen even if the list is
        ignored.  A sub-bucket remainder stays buffered until more samples
        arrive or ``flush()``."""
        with tracing.span("runtime.push"):
            pcm = np.asarray(pcm, np.int16).ravel()
            self._pcm_buf = np.concatenate([self._pcm_buf, pcm])
            fsz = self.cfg.frame_size
            bucket = self.bucket_frames * fsz
            out: list[Packet] = []
            while self._pcm_buf.size >= bucket:
                out.extend(self._demod(
                    self._pcm_buf[:bucket].reshape(self.bucket_frames, fsz)))
                self._pcm_buf = self._pcm_buf[bucket:]
            out.extend(self._drain())
            return out

    def _start_state(self, x: torch.Tensor):
        """A cold loop state for the bucket ``x``, warm-started on the
        current acquisition candidate."""
        acq = 0.0
        if self.cfg.acquisition == "fft":
            try:
                cands = self._acquire(x).reshape(-1)
                tracing.count("sync.runtime.d2h")
                cands = cands.cpu().numpy()
            except ValueError:
                cands = None       # too short to acquire: cold start
            if cands is not None:
                i = self._acq_idx % (cands.size + self._sweep_hz.size)
                est = (cands[i] if i < cands.size
                       else self._sweep_hz[i - cands.size])
                acq = hz_to_costas_freq(torch.tensor(est, dtype=torch.float32),
                                        self.cfg.rs)
                # rx_init copies the host frequency to the device
                tracing.count("sync.runtime.h2d")
        return rx_init(self.cfg, acq_freq=acq, device=self._dev)

    def _demod(self, chunk: np.ndarray) -> list[Packet]:
        """Demodulate one bucket and buffer its bits and LLRs.  Squelch
        acts here, per bucket: a push carrying a burst and then dead air
        drains the burst's buffered bits before the dead air's are
        dropped.  Returns any packets that drain emitted."""
        with tracing.span("runtime.bucket"):
            nframes = chunk.shape[0]
            if (self._sync is None and self._state is not None
                    and self.cfg.acquisition == "fft"
                    and self._acq_bits >= self._acq_rotate_bits):
                # a full hunt's worth of bits on this candidate without a
                # sync: cold-restart this bucket on the next candidate,
                # keeping the buffered bits (they may hold a burst
                # demodulated fine)
                self._acq_idx += 1
                self._acq_bits = 0
                self._acq_stale = self._bit_buf.shape[1]
                self._state = None
            tracing.count("sync.runtime.h2d")
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self._dev)
            if self._state is None:
                self._state = self._start_state(x)
            self._state, out = rx_stream(self.cfg, self._state, x)
            host = self._to_host(out)
            self.counters.frames += nframes
            freq = host["freq"]
            self.counters.detected_offset_hz = float(np.mean(
                freq[-min(10, nframes):]))
            snr = snr_estimate_db_host(host["re"], host["im"])
            self.counters.carrier_snr_db = snr
            if self.squelch_db is None:
                self.counters.carrier_detect = True
            elif self.counters.carrier_detect:
                self.counters.carrier_detect = snr >= self.squelch_db - 3.0
            else:
                self.counters.carrier_detect = snr >= self.squelch_db

            pkts: list[Packet] = []
            if (self.squelch_db is not None
                    and not self.counters.carrier_detect):
                # squelched: drain what earlier buckets buffered first ...
                pkts = self._drain()
                if self._sync is None:
                    # ... then, still unsynced, drop this bucket's noise,
                    # re-arm the transient skip and cold-restart, so the
                    # next carrier re-runs acquisition from its first
                    # candidate
                    self._bit_buf = self._bit_buf[:, :0]
                    self._llr_buf = self._llr_buf[:, :0]
                    self.sync_skip = self._sync_skip0
                    self._state = None
                    self._acq_bits = 0
                    self._acq_stale = 0
                    self._acq_idx = 0
                    return pkts
                # an established sync is never squelch-dropped: only
                # resync_after CRC failures end the epoch
            self._bit_buf = np.concatenate([self._bit_buf, host["bits"]],
                                           axis=1)
            if self._use_soft:
                self._llr_buf = np.concatenate(
                    [self._llr_buf, host["llrs"]], axis=1)
            return pkts

    def _to_host(self, out) -> dict:
        """What the host needs of a bucket's ``RxOut``, in one
        device-to-host copy: the loop frequency per frame, the symbols,
        every rotation's bits and, with FEC, LLRs."""
        sym = CF32(out.symbols.re.reshape(-1), out.symbols.im.reshape(-1))
        parts = [out.freq_hz.reshape(-1), sym.re, sym.im,
                 rotated_streams(out.bits.reshape(-1),
                                 self.cfg.modulation).reshape(-1)
                 .to(torch.float32)]
        if self._use_soft:
            if self.cfg.modulation == "qpsk":
                llrs = demod_soft(sym)
                lstreams = torch.stack([rotate_soft(llrs, r)
                                        for r in range(4)])
            else:
                scores = modfam.symbol_scores(
                    sym, modfam.get(self.cfg.modulation),
                    scale=self.cfg.agc_target)
                lstreams = rotated_streams(None, self.cfg.modulation,
                                           soft=scores)
            parts.append(lstreams.reshape(-1))
        tracing.count("sync.runtime.d2h")
        flat = torch.cat(parts).cpu().numpy()
        nf, ns = out.freq_hz.numel(), sym.re.numel()
        nb = self._nrot * out.bits.numel()
        o = np.cumsum([0, nf, ns, ns, nb])
        host = {"freq": flat[o[0]:o[1]], "re": flat[o[1]:o[2]],
                "im": flat[o[2]:o[3]],
                "bits": flat[o[3]:o[4]].astype(np.int32).reshape(self._nrot,
                                                                 -1)}
        if self._use_soft:
            host["llrs"] = flat[o[4]:].reshape(self._nrot, -1)
        return host

    # ------------------------------------------------------------------
    def _try_sync(self) -> bool:
        with tracing.span("runtime.hunt"):
            window = default_max_lag(self.pcfg)
            probe_bits = self.probe_frames * self.pcfg.frame_bits + 64
            while True:
                if self._bit_buf.shape[1] - self.sync_skip < probe_bits:
                    return False
                # the soft hunt when the LLR rows exist
                buf = self._llr_buf if self._use_soft else self._bit_buf
                tracing.count("sync.runtime.h2d")
                streams = torch.from_numpy(np.ascontiguousarray(
                    buf[:, self.sync_skip:])).to(self._dev)
                found = find_sync_streams(self.pcfg, streams, max_lag=window,
                                          probe_frames=self.probe_frames,
                                          lag_step=self._lag_step,
                                          soft=self._use_soft)
                tracing.count("sync.runtime.d2h", len(found))
                sync = SyncResult(*(int(v) for v in found))
                # 3 CRC hits are collision-proof already; probe-1 hits of
                # the coded probe (8) would be unreachable where it is
                # needed
                if sync.score >= max(2, min(self.probe_frames - 1, 3)):
                    cut = self.sync_skip + sync.bit_lag
                    self._bit_buf = self._bit_buf[:, cut:]
                    if self._use_soft:
                        self._llr_buf = self._llr_buf[:, cut:]
                    self._sync = sync
                    self._rotation = sync.rotation
                    self.counters.synced = True
                    self.sync_skip = 0   # later resyncs hunt from the head
                    self._acq_bits = 0   # this candidate acquired it
                    self._acq_stale = 0
                    self._pkt_index = 0  # stream_index restarts per epoch
                    self._lead = np.zeros((self._nrot, self._hw), np.int32)
                    self._lead_llr = np.zeros((self._nrot, self._hw),
                                              np.float32)
                    return True
                # no sync in [sync_skip, sync_skip + window): slide the hunt
                # forward if more stream remains, trimming the dead prefix
                if (self._bit_buf.shape[1] - self.sync_skip
                        > probe_bits + window):
                    cut = self.sync_skip + window
                    self._bit_buf = self._bit_buf[:, cut:]
                    if self._use_soft:
                        self._llr_buf = self._llr_buf[:, cut:]
                    # rejected bits indict the current candidate, except the
                    # stale prefix demodulated under the previous one
                    stale_overlap = max(0, min(cut, self._acq_stale)
                                        - self.sync_skip)
                    self._acq_bits += window - stale_overlap
                    self._acq_stale = max(0, self._acq_stale - cut)
                    self.sync_skip = 0
                    continue
                return False

    def _drain(self) -> list[Packet]:
        with tracing.span("runtime.drain"):
            fb = self.pcfg.frame_bits
            hw = self._hw
            shifts = np.arange(-hw, hw + 1, self._bps, dtype=np.int64)
            out: list[Packet] = []
            while True:
                if self._sync is None and not self._try_sync():
                    return out
                nf = self._bit_buf.shape[1] // fb
                if nf <= 0:
                    return out
                # every (rotation x shift) span of the whole packets
                # buffered: the lead window serves the negative shifts,
                # zeros the positive ones on the last packet; one batched
                # decode
                ext = np.concatenate(
                    [self._lead, self._bit_buf,
                     np.zeros((self._nrot, hw), np.int32)], axis=1)
                if self._use_soft:
                    ext_l = np.concatenate(
                        [self._lead_llr, self._llr_buf,
                         np.zeros((self._nrot, hw), np.float32)], axis=1)
                    # (R, S, nf*fb)
                    spans = np.stack([ext_l[:, hw + s: hw + s + nf * fb]
                                      for s in shifts], axis=1)
                    tracing.count("sync.runtime.h2d")
                    cand = torch.from_numpy(spans.reshape(
                        self._nrot, len(shifts), nf, fb)).to(self._dev)
                    rx = disassemble_packet_soft(self.pcfg, cand)
                else:
                    spans = np.stack([ext[:, hw + s: hw + s + nf * fb]
                                      for s in shifts], axis=1)
                    tracing.count("sync.runtime.h2d")
                    cand = torch.from_numpy(spans.reshape(
                        self._nrot, len(shifts), nf, fb)).to(self._dev)
                    rx = disassemble_packet(self.pcfg, cand)
                tracing.count("sync.runtime.d2h")
                res = torch.cat([rx.crc_ok.to(torch.int32)[..., None],
                                 rx.payload_bits.to(torch.int32)],
                                dim=-1).cpu().numpy()
                ok = res[..., 0] != 0                     # (R, S, nf)
                payloads = res[..., 1:]                   # (R, S, nf, bits)
                cur_si = self.slip_track      # grid index of shift 0
                stop_j = None
                for j in range(nf):
                    good, r, si = walk_step(ok[:, :, j], shifts,
                                            self._rotation, cur_si,
                                            max_step=self._bps)
                    if good:
                        self._rotation, cur_si = r, si
                        self._consecutive_bad = 0
                    else:
                        self.counters.crc_failures += 1
                        self._consecutive_bad += 1
                    out.append(Packet(payloads[r, si, j], good,
                                      self._pkt_index))
                    self._pkt_index += 1
                    self.counters.packets += 1
                    if self._consecutive_bad >= self.resync_after:
                        stop_j = j
                        break
                # consume through the last emitted packet, the adopted shift
                # folded into the offset (capped at the buffer: the walk then
                # re-adopts the shift on the next span), and refresh the lead
                last = nf if stop_j is None else stop_j + 1
                consumed = min(last * fb + int(shifts[cur_si]),
                               self._bit_buf.shape[1])
                self._lead = ext[:, consumed: consumed + hw].astype(np.int32)
                self._bit_buf = self._bit_buf[:, consumed:]
                if self._use_soft:
                    self._lead_llr = ext_l[:, consumed: consumed + hw].astype(
                        np.float32)
                    self._llr_buf = self._llr_buf[:, consumed:]
                if stop_j is None:
                    return out
                # lost the channel: drop sync and re-arm; the unconsumed
                # remainder stays buffered for the re-hunt
                self._sync = None
                self.counters.synced = False
                self.counters.resyncs += 1
                self._consecutive_bad = 0

    def flush(self) -> list[Packet]:
        """Demodulate the buffered whole frames (one frame a pass), then
        decode whatever whole packets remain."""
        fsz = self.cfg.frame_size
        out: list[Packet] = []
        while self._pcm_buf.size >= fsz:
            out.extend(self._demod(self._pcm_buf[:fsz].reshape(1, fsz)))
            self._pcm_buf = self._pcm_buf[fsz:]
        out.extend(self._drain())
        return out

    # ------------------------------------------------------------------
    # checkpoint / resume: the receiver around the modem state (sample,
    # bit and LLR buffers, the sync epoch, the slip-track lead window, the
    # acquisition epoch, the counters), so a long-running process restarts
    # mid-stream without re-acquiring

    def save(self, path) -> None:
        """Serialize the whole receiver to a dependency-free .npz.  Resume
        with ``load`` on a StreamDemodulator built with the same cfg /
        pcfg / knobs; the next ``push`` continues the stream exactly."""
        sync = self._sync
        arrays = {
            "pcm_buf": self._pcm_buf, "bit_buf": self._bit_buf,
            "llr_buf": self._llr_buf, "lead": self._lead,
            "lead_llr": self._lead_llr,
            "scalars": np.asarray([
                self.sync_skip, self._rotation, self._consecutive_bad,
                self._pkt_index, 1 if sync is not None else 0,
                0 if sync is None else int(sync.rotation),
                0 if sync is None else int(sync.bit_lag),
                0 if sync is None else int(sync.score),
                1 if self._state is not None else 0,
                self._acq_idx, self._acq_bits, self._acq_stale,
            ], np.int64),
            "counters": np.asarray(
                [float(v) for v in dataclasses.astuple(self.counters)],
                np.float64),
        }
        if self._state is not None:
            for i, leaf in enumerate(flatten(self._state)):
                arrays[f"rx_leaf_{i}"] = leaf.cpu().numpy()
        savez_exact(path, **arrays)

    def load(self, path) -> None:
        """Restore a receiver checkpoint written by ``save`` of either
        package, onto a demodulator built with the same cfg / pcfg /
        knobs.  A checkpoint without the acquisition epoch (written before
        the JAX package kept it) keeps this receiver's."""
        data = np.load(path)
        self._pcm_buf = data["pcm_buf"].astype(np.int16)
        self._bit_buf = data["bit_buf"].astype(np.int32)
        self._llr_buf = data["llr_buf"].astype(np.float32)
        self._lead = data["lead"].astype(np.int32)
        self._lead_llr = data["lead_llr"].astype(np.float32)
        s = data["scalars"]
        self.sync_skip = int(s[0])
        self._rotation = int(s[1])
        self._consecutive_bad = int(s[2])
        self._pkt_index = int(s[3])
        self._sync = (SyncResult(int(s[5]), int(s[6]), int(s[7])) if s[4]
                      else None)
        if s.size > 9:
            self._acq_idx = int(s[9])
            self._acq_bits = int(s[10])
            self._acq_stale = int(s[11])
        fields = [f.name for f in dataclasses.fields(LinkCounters)]
        for name, v in zip(fields, data["counters"]):
            cur = getattr(self.counters, name)
            setattr(self.counters, name,
                    bool(v > 0.5) if isinstance(cur, bool)
                    else type(cur)(float(v)))
        if s[8]:
            like = rx_init(self.cfg, device=self._dev)
            self._state = unflatten(like, [data[f"rx_leaf_{i}"]
                                           for i in range(len(flatten(like)))])
        else:
            self._state = None
