"""Command-line harness, the L5 layer (port of ``qpsk_tpu.cli``; cf. main()
qpsk.c:289-359).

Subcommands, with the JAX package's flags, defaults, exit codes, error
messages and JSON keys:

* ``loopback`` — TX -> channel -> RX in one process (the reference's whole
  main(), with reproducible seeds, AWGN and the other impairments,
  metrics, and an optional scatter artifact replacing the octave plot).
* ``tx``       — payload packets -> int16 PCM spool or WAV file, or with
  ``--stream-in`` hex payload lines -> raw PCM as they arrive.
* ``rx``       — PCM spool or WAV file -> packets + metrics, or with
  ``--stream`` push-mode decode of a file or stdin.
* ``sweep``    — PER/BER against SNR (``eval.per_vs_snr``).
* ``fdm``      — multi-carrier loopback through the FDM filterbank.
* ``bench``    — the throughput and latency suites of ``benchmarks.py``,
  one JSON record a line.  ``--suite scaling`` runs the scale-out records
  in a process group: under ``torchrun`` the one that is there; on the
  card outside one, a rank a visible card (``torch.multiprocessing``
  workers on a ``FileStore`` in a temporary directory, NCCL); with
  ``--device cpu`` outside one, a single rank.  Rank 0's records are
  printed.

The one flag the JAX CLI lacks is ``--device {cuda,cpu}``: the port runs
on the card unless told otherwise, and without one it exits with code 2
rather than carry on on the CPU.  The noise comes from ``torch.Generator``s
seeded ``--seed`` (AWGN), ``--seed + 1`` (phase noise) and ``--seed + 2``
(impulses), where the JAX CLI uses PRNG keys: the payloads equal the JAX
CLI's, the noise does not.

Usage: ``python -m qpsk_tpu_torch loopback --frames 100 --snr-db 10``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from qpsk_tpu_torch import benchmarks
from qpsk_tpu_torch.channel import (_to_pcm, awgn_pcm, clock_offset_pcm,
                                    impulse_noise_pcm, multipath_pcm,
                                    phase_noise_pcm)
from qpsk_tpu_torch.config import ModemConfig, config_parity
from qpsk_tpu_torch.fdm import FdmConfig, fdm_demux, fdm_mux
from qpsk_tpu_torch.io import SpoolReader, SpoolWriter, read_wav, write_wav
from qpsk_tpu_torch.metrics import evm, per, snr_estimate_db
from qpsk_tpu_torch.modem import rx_acquire_hz, rx_stream, tx_stream
from qpsk_tpu_torch.ops import modfam
from qpsk_tpu_torch.ops.acquire import hz_to_costas_freq
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.modmap import demod_soft
from qpsk_tpu_torch.ops.resample import (rational_ratio, resample_init,
                                         resample_pcm, resample_stream)
from qpsk_tpu_torch.packet import PacketConfig, assemble_packet
from qpsk_tpu_torch.packet.bits import np_bits_to_bytes, np_bytes_to_bits
from qpsk_tpu_torch.runtime import StreamDemodulator, StreamModulator
from qpsk_tpu_torch.state import rx_init, tx_init
from qpsk_tpu_torch.sync import (_mod_geometry, default_max_lag,
                                 extract_packets_soft_tracked,
                                 extract_packets_soft_tracked_mod,
                                 extract_packets_tracked, find_sync,
                                 find_sync_streams, rotate_soft,
                                 rotated_streams)


def _add_common(p):
    p.add_argument("--baud", type=float, default=2400.0,
                   help="symbol rate (2400 VHF / 1200 10m, README.md:2)")
    p.add_argument("--offset-hz", type=float, default=50.0,
                   help="TX carrier offset stimulus (qpsk.c:320)")
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--parity", action="store_true",
                   help="reference-parity mode (histogram timing, exact NCO)")
    p.add_argument("--modulation", type=str, default="qpsk",
                   choices=["qpsk", "bpsk", "8psk", "16qam"],
                   help="constellation: qpsk is the reference-parity "
                        "flagship; bpsk/8psk/16qam route the same packet "
                        "stack through the generic family (ops/modfam.py; "
                        "pair 16qam with --agc on uncalibrated levels)")
    p.add_argument("--differential", action="store_true",
                   help="DQPSK: rotation-immune decode, no CRC rotation search")
    p.add_argument("--timing", type=str, default="power",
                   choices=["power", "fractional", "tracking", "histogram"],
                   help="symbol-timing estimator (tracking = frame-rate PLL)")
    p.add_argument("--eq-taps", type=int, default=0,
                   help="blind CMA channel equalizer length (0 = off); "
                        "decodes through static multipath")
    p.add_argument("--agc", action="store_true",
                   help="frame-rate automatic gain control: decode streams "
                        "at unknown levels (pair with loopback --level-db)")
    p.add_argument("--fec", nargs="?", const="conv", default=False,
                   choices=("conv", "ldpc"),
                   help="rate-1/2 FEC: 'conv' = K=7 + soft Viterbi (the "
                        "default when the flag is given bare), 'ldpc' = "
                        "IRA LDPC + min-sum")
    p.add_argument("--payload-bytes", type=int, default=30,
                   help="packet payload size (default 30: one uncoded "
                        "packet fills one 256-symbol frame with its "
                        "CRC16; larger packets span multiple frames)")
    p.add_argument("--device", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="where the modem runs: the card (default; exits "
                        "with an error without one) or the CPU")


def _cfg(args) -> ModemConfig:
    if getattr(args, "parity", False):
        return config_parity()
    return ModemConfig(rs=args.baud,
                       modulation=getattr(args, "modulation", "qpsk"),
                       differential=getattr(args, "differential", False),
                       timing_mode=getattr(args, "timing", "power"),
                       eq_taps=getattr(args, "eq_taps", 0),
                       agc=getattr(args, "agc", False))


def _pcfg(args) -> PacketConfig:
    return PacketConfig(payload_bytes=getattr(args, "payload_bytes", 30),
                        fec=getattr(args, "fec", False))


def _payload(args, pcfg, rng, lead=()) -> torch.Tensor:
    """(*lead, frames, 8*payload_bytes) random payload bits on the
    device, the JAX CLI's draw."""
    return torch.from_numpy(rng.integers(
        0, 2, tuple(lead) + (args.frames, 8 * pcfg.payload_bytes),
        dtype=np.int32)).to(args.device)


def _modem_frames(cfg, pcfg, payload, rng) -> torch.Tensor:
    """The packet stream of (..., npkts, payload bits) re-framed into whole
    modem frames (..., nframes, bits_per_frame), symbol-aligned (the
    generic family's bits a symbol need not divide a packet), the tail
    padded with filler bits drawn from ``rng``."""
    lead = tuple(payload.shape[:-2])
    bits = assemble_packet(pcfg, payload).reshape(lead + (-1,))
    mfb = cfg.bits_per_frame
    npad = (-bits.shape[-1]) % mfb
    if npad:
        bits = torch.cat([bits, torch.from_numpy(rng.integers(
            0, 2, lead + (npad,), dtype=np.int32)).to(bits.device)], dim=-1)
    return bits.reshape(lead + (-1, mfb))


def _noise(args, offset: int) -> torch.Generator:
    return torch.Generator(device=args.device).manual_seed(args.seed + offset)


def _awgn(args, cfg, pcm: torch.Tensor) -> torch.Tensor:
    """AWGN at ``--snr-db`` relative to the PCM's own power."""
    sp = float(torch.mean((pcm.to(torch.float32) / cfg.pcm_scale) ** 2))
    return awgn_pcm(_noise(args, 0), pcm, snr_db=args.snr_db,
                    signal_power=sp, pcm_scale=cfg.pcm_scale)


def _acq_freq(cfg, pcm: torch.Tensor):
    """The loop's warm start: the generic family FFT-acquires before its
    narrower-pull-in decision-directed loop (as ``eval.per_vs_snr``)."""
    if cfg.modulation != "qpsk" and cfg.acquisition == "fft":
        return hz_to_costas_freq(rx_acquire_hz(cfg, pcm), cfg.rs)
    return 0.0


def cmd_loopback(args) -> int:
    cfg = _cfg(args)
    pcfg = _pcfg(args)
    min_frames = 16 if pcfg.fec else 8
    if args.frames < min_frames:
        print(f"error: --frames must be >= {min_frames} (packet sync needs "
              f"a probe window past the Costas transient; coded links probe "
              f"8 packet frames), got {args.frames}", file=sys.stderr)
        return 2
    rng = np.random.default_rng(args.seed)
    chan_bits = _modem_frames(cfg, pcfg, _payload(args, pcfg, rng), rng)
    _, pcm = tx_stream(cfg, tx_init(cfg, device=args.device), chan_bits,
                       tx_offset_hz=args.offset_hz,
                       doppler_hz_per_s=args.doppler)
    if args.phase_noise_hz:
        pcm = phase_noise_pcm(_noise(args, 1), pcm.reshape(-1),
                              args.phase_noise_hz, cfg.fs).reshape(pcm.shape)
    if args.multipath:
        paths = [(int(p.split(":")[0]), float(p.split(":")[1]))
                 for p in args.multipath.split(",")]
        pcm = multipath_pcm(pcm.reshape(-1), paths).reshape(pcm.shape)
    if args.snr_db is not None:
        pcm = _awgn(args, cfg, pcm)
    if args.impulse_rate:
        # impulsive interference (static crashes / ignition noise): pair
        # with --fec, whose interleaver spreads each burst across codewords
        pcm = impulse_noise_pcm(_noise(args, 2), pcm.reshape(-1),
                                args.impulse_rate, cfg.fs).reshape(pcm.shape)
    if args.level_db:
        # a mis-set audio level AFTER the channel (an RX-side gain error):
        # pair with --agc to decode anyway
        g = float(np.float32(10.0 ** (args.level_db / 20.0)))
        pcm = _to_pcm(pcm.to(torch.float32) * g)
    if args.clock_ppm:
        # RX A/D clock mismatch (pair with --timing tracking)
        pcm = clock_offset_pcm(pcm.reshape(-1), args.clock_ppm * 1e-6)

    # the packets' PCM length need not divide the RX frame: pad with silence
    flat = pcm.reshape(-1)
    npad = (-flat.numel()) % cfg.frame_size
    if npad:
        flat = torch.cat([flat, flat.new_zeros(npad)])
    _, out = rx_stream(cfg, rx_init(cfg, acq_freq=_acq_freq(cfg, flat),
                                    device=args.device),
                       flat.reshape(-1, cfg.frame_size))

    skip = min(8, args.frames // 4)
    bits = out.bits.reshape(-1)
    # generic-family bit streams are sliced SYMBOL-aligned (rotation
    # hypotheses re-group bits per symbol); for QPSK any even offset works
    bps = cfg.bits_per_symbol
    skip_bits = skip * pcfg.frame_bits
    skip_bits -= skip_bits % bps
    use_soft = args.fec and not cfg.differential
    sym = CF32(out.symbols.re.reshape(-1), out.symbols.im.reshape(-1))
    mod = None if cfg.modulation == "qpsk" else modfam.get(cfg.modulation)
    llrs = scores = None
    if use_soft:
        # soft source first: both the sync hunt and the extraction run
        # soft-decision (the hard-input hunt limits acquisition about 2 dB
        # above the soft decode floor)
        if mod is None:
            llrs = demod_soft(sym)
            rows = torch.stack([rotate_soft(llrs[skip_bits:], r)
                                for r in range(4)])
        else:
            scores = modfam.symbol_scores(sym, mod, scale=cfg.agc_target)
            rows = rotated_streams(None, cfg.modulation,
                                   soft=scores[skip_bits // bps:])
        # coded links probe 8 frames: the 4-probe hunt is score-starved at
        # the soft decode floor
        sync = find_sync_streams(pcfg, rows, max_lag=default_max_lag(pcfg),
                                 probe_frames=8, soft=True,
                                 lag_step=_mod_geometry(cfg.modulation)[2])
    else:
        sync = find_sync(pcfg, bits[skip_bits:],
                         max_lag=default_max_lag(pcfg),
                         probe_frames=8 if pcfg.fec else 4,
                         modulation=cfg.modulation)
    navail = (bits.numel() - skip_bits - int(sync.bit_lag)) // pcfg.frame_bits
    # sustained clock drift can wrap the timing phase and slip the symbol
    # grid: let the tracked extractors walk the bit lag too
    max_slip = 2 if args.clock_ppm else 0
    if use_soft and mod is None:
        rx = extract_packets_soft_tracked(pcfg, llrs[skip_bits:], sync,
                                          navail, max_slip=max_slip)
    elif use_soft:
        rx = extract_packets_soft_tracked_mod(
            pcfg, scores[skip_bits // bps:], sync, navail, cfg.modulation,
            max_slip=max_slip)
    else:
        # differential bits come from the turn-difference decode, so LLRs
        # of the absolute symbols don't apply: FEC (if on) decodes hard
        # input inside disassemble_packet (about 2 dB behind soft)
        rx = extract_packets_tracked(pcfg, bits[skip_bits:], sync, navail,
                                     max_slip=max_slip,
                                     modulation=cfg.modulation)
    post = CF32(out.symbols.re[skip:], out.symbols.im[skip:])
    if mod is None:
        evm_rms = float(evm(post).evm_rms.mean())
    else:
        evm_rms = float(modfam.evm_mod(
            CF32(post.re.reshape(1, -1), post.im.reshape(1, -1)), mod).mean())
    est_snr = float(snr_estimate_db(CF32(post.re.reshape(-1),
                                         post.im.reshape(-1))))

    result = {
        "frames": args.frames,
        "snr_db": args.snr_db,
        "offset_hz": args.offset_hz,
        "detected_offset_hz": round(float(out.freq_hz[-10:].mean()), 2),
        "sync_rotation_deg": int(sync.rotation) * (
            360 // _mod_geometry(cfg.modulation)[0]),
        "sync_score": int(sync.score),
        "packets": int(rx.crc_ok.numel()),
        "per": round(float(per(rx.crc_ok)), 5),
        "evm_rms": round(evm_rms, 5),
        "est_snr_db": round(est_snr, 2),
    }
    print(json.dumps(result))

    if args.scatter:
        _scatter_png(args.scatter, out.symbols, skip)
        print(f"scatter written to {args.scatter}", file=sys.stderr)
    return 0


def _scatter_png(path: str, symbols, skip: int) -> None:
    """Constellation artifact (replaces the octave plot, Makefile:10-12)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    re = symbols.re[skip:].reshape(-1).cpu().numpy()
    im = symbols.im[skip:].reshape(-1).cpu().numpy()
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.scatter(re, im, s=2, alpha=0.3)
    ax.set_xlabel("I")
    ax.set_ylabel("Q")
    ax.set_title("Costas-locked constellation")
    ax.set_aspect("equal")
    fig.savefig(path, dpi=120)
    plt.close(fig)


class _Resampler:
    """Streaming rate conversion of int16 PCM chunks at the IO edge: whole
    M-groups go through ``resample_stream`` on the device a call, the
    sub-M remainder CARRIES to the next chunk (padding each chunk would
    insert mid-stream silence and shift the framing wherever M does not
    divide it); only the stream's end pads."""

    def __init__(self, fs_in: float, fs_out: float, device):
        self.l, self.m = rational_ratio(fs_in, fs_out)
        self.device = device
        self.state = resample_init(self.l, self.m, device=device)
        self.buf = np.zeros(0, np.float32)

    def __call__(self, pcm16: np.ndarray, last: bool = False) -> np.ndarray:
        self.buf = np.concatenate([self.buf, pcm16.astype(np.float32)])
        n = self.buf.size - (self.buf.size % self.m)
        if last and self.buf.size % self.m:
            self.buf = np.concatenate(
                [self.buf, np.zeros(self.m - self.buf.size % self.m,
                                    np.float32)])
            n = self.buf.size
        if n == 0:
            return np.zeros(0, np.int16)
        y, self.state = resample_stream(
            torch.from_numpy(self.buf[:n]).to(self.device), self.state,
            self.l, self.m)
        self.buf = self.buf[n:]
        return np.clip(np.rint(y.cpu().numpy()), -32768, 32767).astype(
            np.int16)


def _cmd_tx_stream(args) -> int:
    """Push-mode modulator (the TX twin of ``rx --stream``): read hex
    payload lines (payload_bytes each) from a file or stdin, modulate
    through ``StreamModulator`` (filter/NCO state carried across lines),
    and write raw int16 PCM to ``--out`` ('-' = stdout) as it goes:
    ``tx --stream-in - | rx - --stream`` is a live duplex pipe."""
    cfg = _cfg(args)
    pcfg = _pcfg(args)
    mod = StreamModulator(cfg, pcfg, tx_offset_hz=args.offset_hz,
                          device=args.device)
    rate = int(args.io_rate or cfg.fs)
    convert = None
    if rate != int(cfg.fs):
        try:
            convert = _Resampler(cfg.fs, rate, args.device)
        except ValueError:
            print(f"error: cannot resample {int(cfg.fs)} -> {rate} S/s "
                  "(not a small rational ratio)", file=sys.stderr)
            return 2
    src = sys.stdin if args.stream_in == "-" else open(args.stream_in)
    sink = (sys.stdout.buffer if args.out == "-"
            else open(args.out, "wb"))
    npkts = nsamp = 0

    def out(pcm16: np.ndarray, last: bool = False) -> np.ndarray:
        return pcm16 if convert is None else convert(pcm16, last)

    try:
        for line in src:
            line = line.strip()
            if not line:
                continue
            try:
                data = bytes.fromhex(line)
            except ValueError:
                print(f"error: payload line is not hex: {line[:40]!r}",
                      file=sys.stderr)
                return 2
            if len(data) != pcfg.payload_bytes:
                print(f"error: payload line has {len(data)} bytes, "
                      f"expected {pcfg.payload_bytes}", file=sys.stderr)
                return 2
            pcm = out(mod.push(np_bytes_to_bits(np.frombuffer(data,
                                                              np.uint8))))
            sink.write(pcm.tobytes())
            sink.flush()
            npkts += 1
            nsamp += pcm.size
        # drain the modulator's sub-symbol bit remainder (generic-family
        # constellations), then the resampler's carry
        tail = np.concatenate([out(mod.flush()),
                               out(np.zeros(0, np.int16), last=True)])
        sink.write(tail.tobytes())
        sink.flush()
        nsamp += tail.size
    finally:
        if src is not sys.stdin:
            src.close()
        if sink is not sys.stdout.buffer:
            sink.close()
    print(json.dumps({"packets": npkts, "samples": nsamp,
                      "sample_rate": rate}), file=sys.stderr)
    return 0


def cmd_tx(args) -> int:
    if args.stream_in is not None:
        return _cmd_tx_stream(args)
    cfg = _cfg(args)
    pcfg = _pcfg(args)
    rng = np.random.default_rng(args.seed)
    chan_bits = _modem_frames(cfg, pcfg, _payload(args, pcfg, rng), rng)
    _, pcm = tx_stream(cfg, tx_init(cfg, device=args.device), chan_bits,
                       tx_offset_hz=args.offset_hz)
    rate = int(args.io_rate or cfg.fs)
    if rate != int(cfg.fs):
        # a sound card's device rate: polyphase-resample the modem-rate PCM
        pcm = resample_pcm(pcm.reshape(-1), cfg.fs, rate)[None, :]
    pcm = pcm.cpu().numpy()
    if args.out.endswith(".wav"):
        write_wav(args.out, pcm.reshape(-1), rate)
    else:
        with SpoolWriter(args.out, pcm.shape[-1]) as w:
            w.write(pcm)
    print(json.dumps({"samples": int(pcm.size), "file": args.out,
                      "sample_rate": rate}))
    return 0


def _cmd_rx_stream(args) -> int:
    """Push-mode decode (the 24/7 receiver surface): read raw int16 PCM
    from a file or stdin in chunks, push through ``StreamDemodulator``
    (automatic sync, CRC tracking, optional squelch), print one hex
    payload line per CRC-good packet AS IT DECODES, and a final counters
    JSON line to stderr."""
    cfg = _cfg(args)
    pcfg = _pcfg(args)
    if args.infile.endswith(".wav"):
        print("error: --stream reads raw int16 (headerless); convert WAV "
              "first or use the one-shot rx", file=sys.stderr)
        return 2
    sr = int(args.io_rate or cfg.fs)
    convert = None
    if sr != int(cfg.fs):
        try:
            convert = _Resampler(sr, cfg.fs, args.device)
        except ValueError:
            print(f"error: cannot resample {sr} -> {int(cfg.fs)} S/s "
                  "(not a small rational ratio)", file=sys.stderr)
            return 2

    demod = StreamDemodulator(cfg, pcfg, squelch_db=args.squelch_db,
                              device=args.device)
    if args.state_file and os.path.exists(args.state_file):
        # resume a prior epoch: buffers, sync, counters all continue
        demod.load(args.state_file)
    src = sys.stdin.buffer if args.infile == "-" else open(args.infile, "rb")
    npkts = nok = 0

    def emit(pkts) -> None:
        nonlocal npkts, nok
        for p in pkts:
            npkts += 1
            if p.crc_ok:
                nok += 1
                print(np_bits_to_bytes(np.asarray(p.payload)).tobytes()
                      .hex(), flush=True)

    def modem_rate(pcm16: np.ndarray, last: bool = False) -> np.ndarray:
        return pcm16 if convert is None else convert(pcm16, last)

    try:
        carry = b""
        while True:
            buf = src.read(2 * args.chunk)
            if not buf:
                break
            buf = carry + buf
            # pipes and truncated captures can end (or split) mid-sample:
            # carry the odd byte to the next read; a trailing odd byte at
            # EOF is a dropped partial sample, not a dead receiver
            carry = buf[len(buf) - (len(buf) % 2):]
            buf = buf[:len(buf) - (len(buf) % 2)]
            emit(demod.push(modem_rate(np.frombuffer(buf, dtype="<i2"))))
        emit(demod.push(modem_rate(np.zeros(0, np.int16), last=True)))
        if args.state_file:
            # checkpoint BEFORE flush: flush consumes partial frames the
            # resumed process would rather re-assemble with new samples
            demod.save(args.state_file)
        else:
            emit(demod.flush())
    finally:
        if src is not sys.stdin.buffer:
            src.close()
    c = demod.counters
    print(json.dumps({
        "frames": c.frames, "packets": npkts, "crc_ok": nok,
        "crc_failures": c.crc_failures, "resyncs": c.resyncs,
        "synced": c.synced,
        "detected_offset_hz": round(c.detected_offset_hz, 2),
        "carrier_snr_db": round(c.carrier_snr_db, 2),
        "carrier_detect": c.carrier_detect,
    }), file=sys.stderr)
    return 0


def cmd_rx(args) -> int:
    if args.stream:
        return _cmd_rx_stream(args)
    cfg = _cfg(args)
    pcfg = _pcfg(args)
    if args.infile.endswith(".wav"):
        pcm, sr = read_wav(args.infile)
        if args.io_rate and int(args.io_rate) != sr:
            print(f"error: {args.infile} header says {sr} S/s but "
                  f"--io-rate {int(args.io_rate)} was given", file=sys.stderr)
            return 2
    else:
        sr = int(args.io_rate or cfg.fs)
        navail = os.path.getsize(args.infile) // (2 * cfg.frame_size)
        with SpoolReader(args.infile, cfg.frame_size) as r:
            pcm = r.read(max(navail, 1)).reshape(-1)
    if sr != int(cfg.fs):
        # a device-rate capture: rate-convert it to the modem rate
        try:
            rational_ratio(sr, cfg.fs)
        except ValueError:
            print(f"error: cannot resample {sr} -> {int(cfg.fs)} S/s "
                  "(not a small rational ratio)", file=sys.stderr)
            return 2
        pcm = resample_pcm(torch.from_numpy(pcm).to(args.device), sr,
                           cfg.fs).cpu().numpy()
    nframes = pcm.size // cfg.frame_size
    if nframes < 8:
        print(f"error: {args.infile} holds only {nframes} frames; packet "
              f"sync needs at least 8", file=sys.stderr)
        return 2
    pcm = torch.from_numpy(np.ascontiguousarray(
        pcm[:nframes * cfg.frame_size].reshape(nframes, cfg.frame_size))
    ).to(args.device)
    _, out = rx_stream(cfg, rx_init(cfg, acq_freq=_acq_freq(cfg,
                                                           pcm.reshape(-1)),
                                    device=args.device), pcm)
    bits = out.bits.reshape(-1)
    skip = min(8, nframes // 4) * pcfg.frame_bits
    skip -= skip % cfg.bits_per_symbol   # symbol-aligned (generic family)
    sync = find_sync(pcfg, bits[skip:], max_lag=default_max_lag(pcfg),
                     probe_frames=8 if pcfg.fec else 4,
                     modulation=cfg.modulation)
    navail = (bits.numel() - skip - int(sync.bit_lag)) // pcfg.frame_bits
    rx = extract_packets_tracked(pcfg, bits[skip:], sync, navail,
                                 modulation=cfg.modulation)
    print(json.dumps({
        "frames": nframes,
        "detected_offset_hz": round(float(np.mean(
            out.freq_hz.cpu().numpy()[-10:])), 2),
        "sync_score": int(sync.score),
        "packets": navail,
        "per": round(float(per(rx.crc_ok)), 5),
    }))
    return 0


def cmd_sweep(args) -> int:
    from qpsk_tpu_torch.eval import per_vs_snr

    cfg = _cfg(args)
    # size the payload so one packet ~ one modem frame: uncoded frames fill
    # it exactly (payload + CRC16); coded frames halve the payload for the
    # rate-1/2 codes (conv adds 6 tail bits, so slightly under)
    bpf = cfg.bits_per_frame
    if args.fec == "conv":
        pb = (bpf // 2 - 16 - 6) // 8
    elif args.fec == "ldpc":
        pb = (bpf // 2 - 16) // 8
    else:
        pb = (bpf - 16) // 8
    pcfg = PacketConfig(payload_bytes=pb, fec=args.fec)
    try:
        snrs = [float(s) for s in args.snr_db.split(",")]
    except ValueError:
        print(f"error: --snr-db expects comma-separated numbers, "
              f"got {args.snr_db!r}", file=sys.stderr)
        return 2
    for rec in per_vs_snr(cfg, pcfg, snrs, nframes=args.frames,
                          offset_hz=args.offset_hz, seed=args.seed,
                          device=args.device):
        print(json.dumps(rec))
    return 0


def cmd_fdm(args) -> int:
    """Multi-carrier loopback: C independent packet streams share one
    wideband through the polyphase-DFT bank (``fdm.py``)."""
    cfg = _cfg(args)
    pcfg = _pcfg(args)
    fcfg = FdmConfig(nslots=args.nslots, fs=cfg.fs)
    c_n = fcfg.nchan
    if args.frames < 8:
        print("error: --frames must be >= 8", file=sys.stderr)
        return 2
    rng = np.random.default_rng(args.seed)
    chan_bits = _modem_frames(cfg, pcfg, _payload(args, pcfg, rng, (c_n,)),
                              rng)
    _, pcm = tx_stream(cfg, tx_init(cfg, batch_shape=(c_n,),
                                    device=args.device), chan_bits,
                       tx_offset_hz=args.offset_hz)
    wide = fdm_mux(fcfg, pcm.reshape(c_n, -1))
    if args.snr_db is not None:
        wide = _awgn(args, cfg, wide)
    back = fdm_demux(fcfg, wide)
    npad = (-back.shape[-1]) % cfg.frame_size
    back = torch.cat([back, back.new_zeros((c_n, npad))], dim=-1)
    _, out = rx_stream(cfg, rx_init(cfg, batch_shape=(c_n,),
                                    device=args.device),
                       back.reshape(c_n, -1, cfg.frame_size))
    skip = min(8, args.frames // 4) * pcfg.frame_bits
    skip -= skip % cfg.bits_per_symbol   # symbol-aligned (generic family)
    use_soft = args.fec and not cfg.differential
    mod = None if cfg.modulation == "qpsk" else modfam.get(cfg.modulation)
    freq_hz = out.freq_hz.cpu().numpy()
    chans = []
    for c in range(c_n):
        b = out.bits[c].reshape(-1)
        sync = find_sync(pcfg, b[skip:], max_lag=default_max_lag(pcfg),
                         probe_frames=8 if pcfg.fec else 4,
                         modulation=cfg.modulation)
        navail = (b.numel() - skip - int(sync.bit_lag)) // pcfg.frame_bits
        sym = CF32(out.symbols.re[c].reshape(-1),
                   out.symbols.im[c].reshape(-1))
        if use_soft and mod is None:
            # soft-decision extraction, like loopback (hard-input decode
            # would forfeit about 2 dB of the coded gain)
            rx = extract_packets_soft_tracked(pcfg, demod_soft(sym)[skip:],
                                              sync, navail)
        elif use_soft:
            scores = modfam.symbol_scores(sym, mod, scale=cfg.agc_target)
            rx = extract_packets_soft_tracked_mod(
                pcfg, scores[skip // cfg.bits_per_symbol:], sync, navail,
                cfg.modulation)
        else:
            rx = extract_packets_tracked(pcfg, b[skip:], sync, navail,
                                         modulation=cfg.modulation)
        chans.append({
            "chan": c,
            "carrier_hz": fcfg.slot_center_hz(c, cfg.center),
            "sync_score": int(sync.score),
            "packets": navail,
            "per": round(float(per(rx.crc_ok)), 5),
            "detected_offset_hz": round(float(np.mean(freq_hz[c, -10:])), 2),
        })
    print(json.dumps({"nslots": args.nslots, "nchan": c_n,
                      "wide_fs": fcfg.wide_fs, "snr_db": args.snr_db,
                      "channels": chans}))
    return 0


def _print_records(recs) -> None:
    for rec in recs if isinstance(recs, list) else [recs]:
        print(json.dumps(rec), flush=True)


def _scaling_rank(rank: int, world: int, out: str) -> None:
    """One rank of ``bench --suite scaling`` on its card; rank 0 writes
    the records to ``out``."""
    recs = benchmarks.suites("cuda")["scaling"]()
    if rank == 0:
        with open(out, "w") as fh:
            json.dump(recs, fh)


def _bench_scaling(device: str) -> int:
    """``bench --suite scaling``: in torchrun's group if there is one,
    else one rank a visible card, or one rank on the CPU."""
    import torch.distributed as dist
    from qpsk_tpu_torch.parallel import multihost

    multihost.initialize(device=device)
    if dist.is_initialized() or device == "cpu":
        started = not dist.is_initialized()
        try:
            recs = benchmarks.suites(device)["scaling"]()
        finally:
            if started and dist.is_initialized():
                dist.destroy_process_group()
        _print_records(recs)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "records.json")
        multihost.spawn_per_card(_scaling_rank, os.path.join(tmp, "store"),
                                 out)
        with open(out) as fh:
            _print_records(json.load(fh))
    return 0


def cmd_bench(args) -> int:
    if args.suite == "scaling":
        return _bench_scaling(args.device)
    import torch.distributed as dist
    suites = benchmarks.suites(args.device)
    names = [n for n in suites if n != "scaling"] if args.suite == "all" \
        else [args.suite]
    for name in names:
        recs = suites[name]()
        if not dist.is_initialized() or dist.get_rank() == 0:
            _print_records(recs)
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="qpsk_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    lp = sub.add_parser("loopback", help="TX→channel→RX simulation")
    _add_common(lp)
    lp.add_argument("--snr-db", type=float, default=None,
                    help="AWGN SNR; omit for the reference's noiseless loop")
    lp.add_argument("--multipath", type=str, default=None,
                    help="static multipath paths as 'delay:gain,...' in "
                         "samples (e.g. '0:1.0,4:0.5'); pair with "
                         "--eq-taps to decode through it")
    lp.add_argument("--doppler", type=float, default=0.0,
                    help="carrier chirp rate, Hz/s (Doppler ramp stimulus)")
    lp.add_argument("--level-db", type=float, default=0.0,
                    help="RX-side level error in dB (e.g. -26 for a quiet "
                         "input); pair with --agc")
    lp.add_argument("--clock-ppm", type=float, default=0.0,
                    help="TX/RX sample-clock mismatch in ppm; pair with "
                         "--timing tracking")
    lp.add_argument("--impulse-rate", type=float, default=0.0,
                    help="impulsive interference bursts per second "
                         "(full-scale, 8-sample); pair with --fec")
    lp.add_argument("--phase-noise-hz", type=float, default=0.0,
                    help="TX oscillator phase-noise linewidth, Hz (Wiener "
                         "walk)")
    lp.add_argument("--scatter", type=str, default=None,
                    help="write a constellation PNG artifact")
    lp.set_defaults(fn=cmd_loopback)

    tx = sub.add_parser("tx", help="modulate packets to an int16 PCM file")
    _add_common(tx)
    tx.add_argument("--out", type=str,
                    default=os.path.join(tempfile.gettempdir(),
                                         "qpsk_tpu_spool.raw"),
                    help="output PCM path ('-' = stdout with --stream-in)")
    tx.add_argument("--stream-in", type=str, default=None,
                    help="push-mode modulation: read hex payload lines "
                         "(payload_bytes each) from this file ('-' = "
                         "stdin) and write raw int16 PCM to --out as "
                         "they arrive (filter/NCO state carried)")
    tx.add_argument("--io-rate", type=float, default=0.0,
                    help="device sample rate (e.g. 48000): write PCM at "
                         "this rate via the polyphase resampler (0 = modem "
                         "rate)")
    tx.set_defaults(fn=cmd_tx)

    rx = sub.add_parser("rx", help="demodulate an int16 PCM file")
    _add_common(rx)
    rx.add_argument("infile", type=str,
                    help="int16 PCM file ('-' = stdin with --stream)")
    rx.add_argument("--io-rate", type=float, default=0.0,
                    help="device sample rate of the input (raw files; WAV "
                         "carries its own): resampled to the modem rate")
    rx.add_argument("--stream", action="store_true",
                    help="push-mode decode (StreamDemodulator): read in "
                         "chunks, print one hex payload line per CRC-good "
                         "packet as it decodes, counters JSON to stderr")
    rx.add_argument("--squelch-db", type=float, default=None,
                    help="--stream carrier-detect squelch threshold (dB "
                         "blind SNR): dead-air bits are discarded, not "
                         "hunted")
    rx.add_argument("--state-file", type=str, default=None,
                    help="--stream checkpoint path: resumed at start if it "
                         "exists, written at input end (instead of a final "
                         "flush) — a restarted 24/7 receiver continues its "
                         "sync epoch mid-stream")
    rx.add_argument("--chunk", type=int, default=32768,
                    help="--stream read size in int16 samples")
    rx.set_defaults(fn=cmd_rx)

    sw = sub.add_parser("sweep", help="PER/BER vs SNR curve")
    _add_common(sw)
    sw.add_argument("--snr-db", type=str, default="0,3,6,9,12",
                    help="comma-separated SNR points")
    sw.set_defaults(fn=cmd_sweep)

    fd = sub.add_parser("fdm", help="multi-carrier wideband loopback")
    _add_common(fd)
    fd.add_argument("--nslots", type=int, default=8,
                    help="DFT bank size N; usable channels = N/2 - 1 "
                         "(wideband rate = N * fs)")
    fd.add_argument("--snr-db", type=float, default=None,
                    help="wideband AWGN SNR; omit for noiseless")
    fd.set_defaults(fn=cmd_fdm)

    be = sub.add_parser("bench", help="throughput benchmark")
    be.add_argument("--suite", type=str, default="rx",
                    choices=tuple(benchmarks.suites()) + ("all",),
                    help="which benchmark to run (all = every suite but "
                         "scaling; scaling = weak-scaling efficiency sweep "
                         "over the cards)")
    be.add_argument("--device", type=str, default="cuda",
                    choices=("cuda", "cpu"),
                    help="where the suites run: the card (default; exits "
                         "with an error without one) or the CPU")
    be.set_defaults(fn=cmd_bench)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
