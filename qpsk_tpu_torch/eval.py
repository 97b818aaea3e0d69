"""Link-evaluation harness: PER/BER/EVM against SNR (port of
``qpsk_tpu.eval``).

Every SNR point is a channel on the batch axis, so one ``rx_stream`` call
evaluates the whole curve through the kernels; only packet sync (a small
search per point) runs a point at a time.  The payload is drawn from
``np.random.default_rng(seed)``, as in the JAX package, so both packages
send the same packets; the noise comes from a ``torch.Generator`` seeded
``seed`` on the device, where the JAX package draws from
``jax.random.key(seed)``, so the two packages' noise differs.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from qpsk_tpu_torch.channel import awgn_pcm, multipath_pcm
from qpsk_tpu_torch.config import ModemConfig
from qpsk_tpu_torch.metrics import evm
from qpsk_tpu_torch.modem import rx_acquire_hz, rx_stream, tx_stream
from qpsk_tpu_torch.ops import modfam
from qpsk_tpu_torch.ops.acquire import hz_to_costas_freq
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.modmap import demod_soft
from qpsk_tpu_torch.packet import PacketConfig, assemble_packet
from qpsk_tpu_torch.runtime import _on
from qpsk_tpu_torch.state import rx_init, tx_init
from qpsk_tpu_torch.sync import (_mod_geometry, default_max_lag,
                                 extract_packets_soft_tracked,
                                 extract_packets_soft_tracked_mod,
                                 extract_packets_tracked, find_sync,
                                 find_sync_streams, rotate_soft,
                                 rotated_streams)


def per_vs_snr(cfg: ModemConfig, pcfg: PacketConfig,
               snr_db: Sequence[float], nframes: int = 120,
               offset_hz: float = 50.0, seed: int = 0,
               skip_frames: int = 8, paths=None,
               probe_frames: int = 4, device="cuda") -> list[dict]:
    """Packet/bit error rates across SNR points, one receive pass, on
    ``device`` (the card unless the caller passes ``device="cpu"``;
    without a card it raises).

    Returns one record per SNR: {snr_db, per, ber, evm_rms, detected_hz,
    packets, sync_score}.  Packets need not fill a whole number of modem
    frames (coded packets don't): the channel-bit stream is padded to the
    frame grid.  With ``pcfg.fec`` the extraction runs in the soft domain
    (LLRs from the demodulated symbols -> soft decoder).  ``paths`` adds
    static multipath (``channel.multipath_pcm``) before the AWGN — pair
    with ``ModemConfig(eq_taps=...)`` to sweep the equalized link."""
    dev = _on(device)
    snr = np.asarray(list(snr_db), np.float32)
    ns = snr.size
    rng = np.random.default_rng(seed)
    want = rng.integers(0, 2, (nframes, 8 * pcfg.payload_bytes),
                        dtype=np.int32)
    chan_bits = assemble_packet(pcfg, torch.from_numpy(want).to(dev)).ravel()
    mframe_bits = cfg.bits_per_frame
    npad = (-chan_bits.numel()) % mframe_bits
    if npad:
        chan_bits = torch.cat([chan_bits, torch.from_numpy(rng.integers(
            0, 2, (npad,), dtype=np.int32)).to(dev)])
    chan_bits = chan_bits.reshape(-1, mframe_bits)

    _, pcm = tx_stream(cfg, tx_init(cfg, device=dev), chan_bits,
                       tx_offset_hz=offset_hz)          # (F, frame)
    if paths:
        pcm = multipath_pcm(pcm.reshape(-1), paths).reshape(pcm.shape)
    sp = float(torch.mean((pcm.to(torch.float32) / cfg.pcm_scale) ** 2))
    gen = torch.Generator(device=dev).manual_seed(seed)
    noisy = awgn_pcm(gen, pcm.expand((ns,) + tuple(pcm.shape)),
                     snr_db=torch.from_numpy(snr).to(dev), signal_power=sp,
                     pcm_scale=cfg.pcm_scale)           # (S, F, frame)

    acq = 0.0
    if cfg.modulation != "qpsk" and cfg.acquisition == "fft":
        # the generic family's receive recipe (as the CLI's): FFT-acquire
        # each SNR point before the narrower decision-directed loop
        acq = hz_to_costas_freq(rx_acquire_hz(cfg, noisy), cfg.rs)
    _, out = rx_stream(cfg, rx_init(cfg, batch_shape=(ns,), acq_freq=acq,
                                    device=dev), noisy)

    post = CF32(out.symbols.re[:, skip_frames:], out.symbols.im[:, skip_frames:])
    mod = None if cfg.modulation == "qpsk" else modfam.get(cfg.modulation)
    if mod is None:
        evm_rms = evm(post).evm_rms.mean(dim=-1).cpu().numpy()
    else:
        evm_rms = modfam.evm_mod(CF32(post.re.reshape(ns, -1),
                                      post.im.reshape(ns, -1)),
                                 mod).cpu().numpy()
    det = out.freq_hz[:, -10:].mean(dim=-1).cpu().numpy()

    bits = out.bits.reshape(ns, -1)
    sym = CF32(out.symbols.re.reshape(ns, -1), out.symbols.im.reshape(ns, -1))
    # LLRs of the absolute symbols align with the hard bit stream only in
    # coherent mode; differential bits come from the turn-difference
    # decode, so coded DQPSK decodes hard input inside disassemble_packet
    # (as StreamDemodulator does)
    use_soft = pcfg.fec and not cfg.differential
    soft_src = None
    if use_soft and mod is None:
        soft_src = demod_soft(sym)
    elif use_soft:
        # the generic family: the (nsym, M) score matrix carries every
        # rotation hypothesis' LLR stream (sync.rotated_streams)
        soft_src = modfam.symbol_scores(sym, mod, scale=cfg.agc_target)
    results = []
    skip_bits = skip_frames * mframe_bits  # modem frames, not packets
    skip_syms = skip_bits // cfg.bits_per_symbol
    for i in range(ns):
        stream = bits[i, skip_bits:]
        if use_soft:
            # soft-decision sync hunt: the hard-input hunt misses about
            # 2 dB above the soft decode floor
            if mod is None:
                llrs_i = soft_src[i, skip_bits:]
                rows = torch.stack([rotate_soft(llrs_i, r) for r in range(4)])
            else:
                rows = rotated_streams(None, cfg.modulation,
                                       soft=soft_src[i, skip_syms:])
            sync = find_sync_streams(
                pcfg, rows, max_lag=default_max_lag(pcfg),
                probe_frames=probe_frames,
                lag_step=_mod_geometry(cfg.modulation)[2], soft=True)
        else:
            sync = find_sync(pcfg, stream, max_lag=default_max_lag(pcfg),
                             probe_frames=probe_frames,
                             modulation=cfg.modulation)
        navail = (stream.shape[0] - int(sync.bit_lag)) // pcfg.frame_bits
        rec = {"snr_db": float(snr[i]), "evm_rms": float(evm_rms[i]),
               "detected_hz": float(det[i]), "sync_score": int(sync.score),
               "packets": 0, "per": 1.0, "ber": 0.5}
        if int(sync.score) > 0 and navail > 0:
            if use_soft and mod is None:
                rx = extract_packets_soft_tracked(
                    pcfg, soft_src[i, skip_bits:], sync, navail)
            elif use_soft:
                rx = extract_packets_soft_tracked_mod(
                    pcfg, soft_src[i, skip_syms:], sync, navail,
                    cfg.modulation)
            else:
                rx = extract_packets_tracked(pcfg, stream, sync, navail,
                                             modulation=cfg.modulation)
            ok = rx.crc_ok.cpu().numpy()
            got = rx.payload_bits.cpu().numpy().astype(np.int32)
            # anchor the stream offset on CRC-ok packets: try each until one
            # matches a sent payload (a lone CRC collision or a mid-probe
            # slip must not poison the whole SNR point)
            want_index = {w.tobytes(): k for k, w in enumerate(want)}
            k0 = None
            for i0 in np.flatnonzero(ok):
                k = want_index.get(got[int(i0)].tobytes())
                if k is not None:
                    k0 = k - int(i0)
                    break
            errs, nbits, npk, nok = 0, 0, 0, 0
            for j in range(navail):
                if k0 is None or not (0 <= j + k0 < want.shape[0]):
                    continue
                npk += 1
                ref = want[j + k0]
                errs += int(np.sum(got[j] ^ ref))
                nbits += ref.size
                nok += int(ok[j] and np.array_equal(got[j], ref))
            if npk:
                rec.update(packets=npk, per=1.0 - nok / npk,
                           ber=errs / max(nbits, 1))
        results.append(rec)
    return results
