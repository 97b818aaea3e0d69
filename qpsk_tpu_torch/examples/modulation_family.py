"""Modulation-family walkthrough: one packet stack, four constellations
(the port's twin of ``examples/modulation_family.py``).

The link picks its constellation for the channel it has: BPSK at the
low-SNR end, QPSK (the reference flagship), 8PSK / 16QAM when the SNR
affords the rate.  Everything else is shared: the RRC front-end, the
(decision-directed) carrier loop, CRC/scramble/interleave framing, the
CRC-scored sync hunt that also resolves each constellation's carrier
ambiguity, and the tracked extractors.

Run:  python -m qpsk_tpu_torch.examples.modulation_family [--device cpu]
"""

import argparse

import numpy as np
import torch

from qpsk_tpu_torch import (ModemConfig, rx_acquire_hz, rx_init, rx_stream,
                            tx_init, tx_stream)
from qpsk_tpu_torch.channel import awgn_pcm
from qpsk_tpu_torch.ops.acquire import hz_to_costas_freq
from qpsk_tpu_torch.packet import PacketConfig, assemble_packet
from qpsk_tpu_torch.sync import (default_max_lag, extract_packets_tracked,
                                 find_sync)

# each mode at a comfortable operating SNR (the JAX package's soaked
# floors, docs/per_vs_snr_*.jsonl: BPSK 8 dB, QPSK 12, 8PSK 16, 16QAM 18)
MODES = [("bpsk", 10.0), ("qpsk", 14.0), ("8psk", 18.0), ("16qam", 20.0)]
OFFSET_HZ = 35.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--frames", type=int, default=60)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    pcfg = PacketConfig(payload_bytes=30)

    rng = np.random.default_rng(7)
    payload = torch.from_numpy(rng.integers(0, 2, (args.frames, 240),
                                            dtype=np.int32)).to(dev)

    print(f"{'mode':>6} {'bits/sym':>8} {'snr':>5} {'sync':>4} "
          f"{'packets':>7} {'per':>6} {'kbit/s @2400 baud':>17}")
    for name, snr_db in MODES:
        cfg = ModemConfig(modulation=name, agc=(name == "16qam"))

        # --- TX: re-frame the packet stream into whole symbol-aligned modem
        # frames (8PSK's 3 bits/symbol does not divide the packet length)
        chan = assemble_packet(pcfg, payload).reshape(-1)
        mfb = cfg.bits_per_frame
        pad = (-chan.numel()) % mfb
        if pad:
            chan = torch.cat([chan, torch.from_numpy(
                rng.integers(0, 2, (pad,), dtype=np.int32)).to(dev)])
        _, pcm = tx_stream(cfg, tx_init(cfg, device=dev), chan.reshape(-1, mfb),
                           tx_offset_hz=OFFSET_HZ)

        # --- channel
        sp = float(((pcm.to(torch.float32) / cfg.pcm_scale) ** 2).mean())
        pcm = awgn_pcm(torch.Generator(device=dev).manual_seed(1), pcm,
                       snr_db, sp)

        # --- RX: M-power FFT acquisition seeds the (narrower pull-in)
        # decision-directed loop, then demod + CRC-scored sync + extraction
        est = rx_acquire_hz(cfg, pcm)
        state = rx_init(cfg, acq_freq=hz_to_costas_freq(est, cfg.rs),
                        device=dev)
        _, out = rx_stream(cfg, state, pcm)

        bits = out.bits.reshape(-1)
        skip = 10 * mfb                      # Costas transient, symbol-aligned
        sync = find_sync(pcfg, bits[skip:], max_lag=default_max_lag(pcfg),
                         probe_frames=4, modulation=name)
        navail = (bits.numel() - skip - int(sync.bit_lag)) // pcfg.frame_bits
        rx = extract_packets_tracked(pcfg, bits[skip:], sync, navail,
                                     modulation=name)
        ok = rx.crc_ok.cpu().numpy()
        rate_kbps = 2.4 * cfg.bits_per_symbol
        print(f"{name:>6} {cfg.bits_per_symbol:>8} {snr_db:>5.1f} "
              f"{int(sync.score):>3}/4 {int(ok.sum()):>3}/{navail:>3} "
              f"{1.0 - ok.mean():>6.3f} {rate_kbps:>17.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
