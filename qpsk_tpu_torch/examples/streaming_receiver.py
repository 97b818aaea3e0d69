"""24/7 streaming receiver walkthrough: bursts, dead air, squelch (the
port's twin of ``examples/streaming_receiver.py``).

The batch API (``end_to_end``) asks the caller to manage sync and
framing; this is the deployment surface instead: ``StreamModulator`` /
``StreamDemodulator`` (``qpsk_tpu_torch.runtime``) with arbitrary chunk
sizes, automatic sync, CRC-tracked slips, squelch-gated hunting, resync
after signal loss, and checkpoints.  The same machinery backs the CLI
pipe ``python -m qpsk_tpu_torch tx --stream-in - | python -m
qpsk_tpu_torch rx - --stream``.

Run:  python -m qpsk_tpu_torch.examples.streaming_receiver [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from qpsk_tpu_torch import ModemConfig
from qpsk_tpu_torch.channel import awgn_pcm
from qpsk_tpu_torch.packet import PacketConfig
from qpsk_tpu_torch.runtime import StreamDemodulator, StreamModulator


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--packets", type=int, default=25,
                    help="packets a burst (the resumed stream has 4/5 of it)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = ModemConfig()
    pcfg = PacketConfig(payload_bytes=30)
    rng = np.random.default_rng(0)

    def burst(npkts, seed, snr_db=12.0):
        """One transmission: npkts packets of random payload -> noisy PCM."""
        payloads = rng.integers(0, 2, (npkts, 8 * pcfg.payload_bytes),
                                dtype=np.int32)
        mod = StreamModulator(cfg, pcfg, tx_offset_hz=50.0, device=dev)
        pcm = mod.push(payloads)
        sp = float(np.mean((pcm / cfg.pcm_scale) ** 2))
        noisy = awgn_pcm(torch.Generator(device=dev).manual_seed(seed),
                         torch.from_numpy(pcm).to(dev), snr_db, sp)
        return payloads, noisy.cpu().numpy()

    def dead_air(nframes, seed):
        return np.random.default_rng(seed).normal(
            0, 600.0, nframes * cfg.frame_size).astype(np.int16)

    # a day in the life: burst -> long silence -> burst (other payloads)
    p1, s1 = burst(args.packets, seed=1)
    p2, s2 = burst(args.packets, seed=2)
    stream = np.concatenate([s1, dead_air(120, 3), s2])

    # squelch_db: the sync hunt only runs while the blind carrier-SNR
    # estimate says a signal is present; dead air is discarded, and the
    # loop cold-restarts (FFT re-acquisition) when the carrier returns
    demod = StreamDemodulator(cfg, pcfg, squelch_db=5.0, device=dev)

    good = 0
    pos = 0
    chunks = np.random.default_rng(4)
    while pos < stream.size:                 # arbitrary chunk sizes, as from
        n = int(chunks.integers(500, 8000))  # a sound card or SDR pipe
        good += sum(p.crc_ok for p in demod.push(stream[pos:pos + n]))
        pos += n
    good += sum(p.crc_ok for p in demod.flush())

    c = demod.counters
    wanted = {p.tobytes() for p in np.concatenate([p1, p2]).astype(np.uint8)}
    print(f"decoded {good} CRC-good packets across two bursts "
          f"({len(wanted)} sent; the sync transient costs the burst heads)")
    print(f"frames={c.frames}  resyncs={c.resyncs}  "
          f"offset={c.detected_offset_hz:+.1f} Hz  "
          f"carrier_snr={c.carrier_snr_db:.1f} dB  dcd={c.carrier_detect}")
    if good < args.packets or c.resyncs < 1:
        raise SystemExit("the two bursts did not decode")
    print("ok")

    # --- checkpoint / resume (24/7 operation): a restarted process picks
    # up the receiver exactly where it stopped: buffers, sync epoch,
    # counters
    with tempfile.TemporaryDirectory() as td:
        ckpt = os.path.join(td, "rx.npz")
        _, s3 = burst(args.packets * 4 // 5, seed=5)
        cut = s3.size // 2 + 173

        d1 = StreamDemodulator(cfg, pcfg, device=dev)
        first = [p for p in d1.push(s3[:cut]) if p.crc_ok]
        d1.save(ckpt)                        # the process "dies" here

        d2 = StreamDemodulator(cfg, pcfg, device=dev)  # new process
        d2.load(ckpt)
        second = [p for p in d2.push(s3[cut:]) if p.crc_ok]
        second += [p for p in d2.flush() if p.crc_ok]

        ref = StreamDemodulator(cfg, pcfg, device=dev)
        uninterrupted = [p for p in ref.push(s3) if p.crc_ok]
        uninterrupted += [p for p in ref.flush() if p.crc_ok]
        if len(first) + len(second) != len(uninterrupted):
            raise SystemExit("the resumed receiver lost packets")
        print(f"resume: {len(first)}+{len(second)} packets across the "
              f"restart == {len(uninterrupted)} uninterrupted")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
