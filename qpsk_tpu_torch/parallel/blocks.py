"""Block-parallel single-stream demodulation on one card (port of
``qpsk_tpu.parallel.blocks``).

The Costas recurrence caps one stream at the serial rate of its loop:
one dependent step a symbol, however idle the rest of the card is.  Here
the stream's decimated symbols are split into B overlapping blocks on the
Costas kernel's channel axis (``costas_kernel.costas_run_cm``, one launch
for all blocks): each block re-acquires the carrier by the 4th power from
its own head, runs its own loop over ``overlap_sym`` symbols of warmup and
its body, and drops the warmup.  A block boundary behaves like a burst
start: each block has its own 90-degree ambiguity and a fresh transient,
both absorbed by the CRC-tracked extraction
(``sync.extract_packets_tracked``).  Exactness at the seams is traded for
B-fold parallelism; the overlap sets the trade.
"""

from __future__ import annotations

import torch

from qpsk_tpu_torch.config import ModemConfig
from qpsk_tpu_torch.modem import _tmat
from qpsk_tpu_torch.ops import acquire, nco
from qpsk_tpu_torch.ops import costas as costas_ops
from qpsk_tpu_torch.ops import rrc as rrc_ops
from qpsk_tpu_torch.ops import timing as timing_ops
from qpsk_tpu_torch.ops.cplx import CF32, cmap
from qpsk_tpu_torch.ops.cuda.costas_kernel import costas_run_cm
from qpsk_tpu_torch.ops.modmap import demod_bits_reference

__all__ = ["rx_stream_blockparallel"]


def rx_stream_blockparallel(cfg: ModemConfig, pcm: torch.Tensor,
                            nblocks: int, overlap_sym: int = 64):
    """Demodulate one (nframes, frame_size) int16 PCM stream with the
    Costas loop split over ``nblocks`` blocks.

    Returns (symbols CF32 (nsym,), bits (2*nsym,) int32, freq_hz
    (nblocks,)).  The symbols are *undelayed* (no one-frame decimation
    delay: the blocks decode independently, like bursts).  ``nblocks``
    must divide the symbol count; ``overlap_sym`` symbols before each
    block (zeros before the first) warm its loop up and are dropped.  The
    device of ``pcm`` picks the Costas lowering as in ``rx_stream``
    (``cfg.costas_impl``); the front-end is plain torch, as in the JAX
    package.
    """
    if cfg.modulation != "qpsk":
        # the 4th-power acquisition, the sign detector and the slicers
        # below are QPSK's: a family config would give silent garbage
        raise ValueError(
            f"rx_stream_blockparallel is QPSK-only, got {cfg.modulation!r}")
    if pcm.dim() != 2:
        raise ValueError(
            f"single stream expected: (nframes, frame_size), got "
            f"{tuple(pcm.shape)}")
    nframes, fsz = pcm.shape
    n, nsym = nframes * fsz, nframes * cfg.symbols_per_frame
    if nblocks < 1 or nsym % nblocks:
        raise ValueError(f"nblocks={nblocks} must divide {nsym} symbols")
    length = nsym // nblocks
    warm = min(overlap_sym, length)
    dev = pcm.device

    # the serial front-end: every step is parallel, no recurrence
    flat = pcm.reshape(n).to(torch.float32) / float(cfg.pcm_scale)
    x, _ = nco.mix(CF32(flat, torch.zeros_like(flat)),
                   nco.nco_init((), dev), -cfg.omega_center, "fast")
    blk = rrc_ops.pick_block(fsz)
    x, _ = rrc_ops.fir_block(x, rrc_ops.fir_init_tail(cfg.ntaps, (), dev),
                             _tmat(cfg, blk, dev), cfg.gain, blk,
                             exact=cfg.fir_precision == "exact")
    picks, _ = timing_ops.estimate_and_decimate(
        cmap(lambda p: p.reshape(nframes, fsz), x), cfg.cycles,
        cfg.timing_mode)
    sym = cmap(lambda p: p.reshape(nsym), picks)

    # block b's window is stream symbols [b*L - W, b*L + L), W zeros
    # before the first: the W-symbol history and the body are two reshape
    # views of the stream, no gather
    def windows(plane):
        pre = torch.cat([plane.new_zeros(warm), plane])
        hist = pre[:nsym].reshape(nblocks, length)[:, :warm]
        return torch.cat([hist, plane.reshape(nblocks, length)], dim=1)
    zb = cmap(windows, sym)

    # each block re-acquires on its pre-decimation samples at fs (the 4th
    # power at the symbol rate would alias beyond rs/8)
    spb = length * cfg.cycles
    nfft = min(cfg.nfft, spb)
    heads = cmap(lambda p: p.reshape(nblocks, spb)[:, :nfft], x)
    f_hz = acquire.acquire_freq_hz(heads, cfg.fs, nfft=nfft)
    freq0 = torch.clamp(acquire.hz_to_costas_freq(f_hz, cfg.rs),
                        cfg.min_freq, cfg.max_freq)
    gear = costas_ops.gear_for(cfg.loop_bw_track, cfg.damping)
    params = costas_ops.costas_params(cfg.loop_bw, cfg.damping, cfg.min_freq,
                                      cfg.max_freq)
    cstate, derot, _, bits = costas_run_cm(
        costas_ops.costas_init_from_freq(freq0, gear is not None), zb,
        params, warm + length, gear=gear, impl=cfg.costas_impl)

    # drop each block's warmup: the L outputs left are stream symbols
    # [b*L, (b+1)*L)
    out = cmap(lambda p: p[:, warm:].reshape(nsym), derot)
    bits = (bits[:, 2 * warm:].reshape(2 * nsym) if cfg.slicer == "diagonal"
            else demod_bits_reference(out))
    return out, bits, costas_ops.freq_to_hz(cstate.freq, cfg.rs)
