"""End-to-end walkthrough: packets over an impaired channel (the port's
twin of ``examples/end_to_end.py``).

Run:  python -m qpsk_tpu_torch.examples.end_to_end [--device cpu]
(on the card by default; ``--frames`` sets the length of the two links).
"""

import argparse

import numpy as np
import torch

from qpsk_tpu_torch import (ModemConfig, rx_acquire_hz, rx_init, rx_stream,
                            tx_init, tx_stream)
from qpsk_tpu_torch.channel import awgn_pcm
from qpsk_tpu_torch.fdm import FdmConfig, fdm_demux, fdm_mux
from qpsk_tpu_torch.metrics import evm, per
from qpsk_tpu_torch.ops.acquire import hz_to_costas_freq
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.modmap import demod_soft
from qpsk_tpu_torch.packet import PacketConfig, assemble_packet
from qpsk_tpu_torch.sync import (default_max_lag, extract_packets_soft_tracked,
                                 extract_packets_tracked, find_sync)


def power(pcm, cfg) -> float:
    return float(((pcm.to(torch.float32) / cfg.pcm_scale) ** 2).mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--fdm-frames", type=int, default=40)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # --- configuration: the reference design point (2400 baud @ 9600 S/s)
    cfg = ModemConfig()
    pcfg = PacketConfig(payload_bytes=30)   # 240 payload bits + CRC16 = 1 frame
    nframes, snr_db, offset_hz = args.frames, 10.0, 137.0

    # --- TX: payload -> CRC/scramble/interleave -> QPSK -> RRC -> carrier
    rng = np.random.default_rng(0)
    payload = torch.from_numpy(rng.integers(0, 2, (nframes, 240),
                                            dtype=np.int32)).to(dev)
    chan_bits = assemble_packet(pcfg, payload)
    _, pcm = tx_stream(cfg, tx_init(cfg, device=dev), chan_bits,
                       tx_offset_hz=offset_hz)

    # --- channel: AWGN at 10 dB over the passband
    noisy = awgn_pcm(torch.Generator(device=dev).manual_seed(1), pcm, snr_db,
                     power(pcm, cfg))

    # --- RX: acquire -> warm-start Costas -> demodulate
    est_hz = rx_acquire_hz(cfg, noisy)
    state = rx_init(cfg, acq_freq=hz_to_costas_freq(est_hz, cfg.rs),
                    device=dev)
    state, out = rx_stream(cfg, state, noisy)
    print(f"acquisition: {float(est_hz):+7.2f} Hz   "
          f"tracked: {float(out.freq_hz[-10:].mean()):+7.2f} Hz   "
          f"(true {offset_hz:+.0f})")

    m = evm(CF32(out.symbols.re[8:], out.symbols.im[8:]))
    print(f"EVM (post-transient): {float(m.evm_rms.mean()) * 100:.1f}%")

    # --- packets: resolve phase ambiguity + alignment by CRC
    bits = out.bits.reshape(-1)
    skip = 8 * pcfg.frame_bits
    sync = find_sync(pcfg, bits[skip:], max_lag=default_max_lag(pcfg),
                     probe_frames=4)
    navail = (bits.numel() - skip - int(sync.bit_lag)) // pcfg.frame_bits
    rx = extract_packets_tracked(pcfg, bits[skip:], sync, navail)
    print(f"sync: rotation {int(sync.rotation) * 90}°, lag {int(sync.bit_lag)} "
          f"bits, score {int(sync.score)}/4")
    print(f"packets: {int(rx.crc_ok.sum())}/{navail} CRC-pass "
          f"(PER {float(per(rx.crc_ok)):.3f})")

    # --- coded link: the same pipeline with rate-1/2 FEC + soft decisions.
    # At 5-6 dB the uncoded link above cannot sync; the K=7 (133, 171)
    # code decoded with soft-decision Viterbi keeps delivering.
    pcfg_c = PacketConfig(payload_bytes=30, fec=True)  # 524 channel bits
    chan_c = assemble_packet(pcfg_c, payload).reshape(-1)
    npad = (-chan_c.numel()) % (2 * cfg.symbols_per_frame)
    chan_c = torch.cat([chan_c, chan_c.new_zeros(npad)])
    _, pcm_c = tx_stream(cfg, tx_init(cfg, device=dev),
                         chan_c.reshape(-1, 2 * cfg.symbols_per_frame),
                         tx_offset_hz=offset_hz)
    noisy_c = awgn_pcm(torch.Generator(device=dev).manual_seed(2), pcm_c, 6.0,
                       power(pcm_c, cfg))
    _, out_c = rx_stream(cfg, rx_init(cfg, device=dev), noisy_c)

    bits_c = out_c.bits.reshape(-1)
    llrs_c = demod_soft(CF32(out_c.symbols.re.reshape(-1),
                             out_c.symbols.im.reshape(-1)))
    skip_c = 10 * 2 * cfg.symbols_per_frame
    sync_c = find_sync(pcfg_c, bits_c[skip_c:],
                       max_lag=default_max_lag(pcfg_c), probe_frames=4)
    nav_c = (bits_c.numel() - skip_c - int(sync_c.bit_lag)) // pcfg_c.frame_bits
    rx_c = extract_packets_soft_tracked(pcfg_c, llrs_c[skip_c:], sync_c, nav_c)
    print(f"coded @ 6 dB: {int(rx_c.crc_ok.sum())}/{nav_c} CRC-pass "
          f"(PER {float(per(rx_c.crc_ok)):.3f}) — soft Viterbi, slip-tracked")

    # --- FDM: three independent channels in one wideband stream.  A
    # critically sampled polyphase-DFT bank puts N/2-1 unmodified modem
    # channels on slots of an N*fs wideband; the batched RX decodes them
    # all as its ordinary channel axis.
    fcfg = FdmConfig(nslots=8)
    pay3 = torch.from_numpy(rng.integers(0, 2, (fcfg.nchan, args.fdm_frames,
                                                240), dtype=np.int32)).to(dev)
    _, pcm3 = tx_stream(cfg, tx_init(cfg, (fcfg.nchan,), device=dev),
                        assemble_packet(pcfg, pay3), tx_offset_hz=50.0)
    wide = fdm_mux(fcfg, pcm3.reshape(fcfg.nchan, -1))
    wide = awgn_pcm(torch.Generator(device=dev).manual_seed(3), wide, 18.0,
                    power(wide, cfg))
    back = fdm_demux(fcfg, wide)
    npad3 = (-back.shape[-1]) % cfg.frame_size
    back = torch.cat([back, back.new_zeros((fcfg.nchan, npad3))], dim=-1)
    _, out3 = rx_stream(cfg, rx_init(cfg, (fcfg.nchan,), device=dev),
                        back.reshape(fcfg.nchan, -1, cfg.frame_size))
    for c in range(fcfg.nchan):
        b3 = out3.bits[c].reshape(-1)
        s3 = find_sync(pcfg, b3[skip:], max_lag=default_max_lag(pcfg),
                       probe_frames=4)
        n3 = (b3.numel() - skip - int(s3.bit_lag)) // pcfg.frame_bits
        r3 = extract_packets_tracked(pcfg, b3[skip:], s3, n3)
        print(f"FDM chan {c} @ {fcfg.slot_center_hz(c, cfg.center):7.0f} Hz: "
              f"{int(r3.crc_ok.sum())}/{n3} CRC-pass")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
