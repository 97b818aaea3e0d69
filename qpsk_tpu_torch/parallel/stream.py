"""Sequence (time-block) parallelism for one long sample stream (port of
``qpsk_tpu.parallel.stream``).

A length-n PCM stream is split into S contiguous blocks, one a rank on
the mesh's ``"sp"`` axis.  Per block:

* **NCO mix-down**: the free-running RX NCO is a geometric phasor
  sequence, so each block's start phase is the closed form
  ``exp(-j w s L)``, wrapped in float64 on the host; no recurrence crosses
  a block boundary.
* **RRC matched filter**: overlap-save.  Each block needs the previous
  block's last ``ntaps-1`` mixed samples: one neighbour shift
  (``dist.batch_isend_irecv`` on the axis's group, re and im as one
  ``(2, ntaps-1)`` message) delivers the halo; rank 0 gets zeros, the cold
  delay line.  The exchange is posted before the bulk of the FIR and
  waited for only by the first tile's tail product, so it overlaps the
  local matmuls, as XLA overlaps the JAX package's ``ppermute``.
* **Timing and decimation**: per frame, local.  The symbols are
  *undelayed* (no one-frame decimation delay: blocks decode
  independently).
* **Costas**: each block re-acquires the carrier by the 4th power on its
  first ``min(nfft, L)`` filtered samples and warm-starts its own loop;
  the block runs through the Costas kernel as one channel
  (``costas_kernel.costas_run_cm``: one launch a rank on the card, the
  plain loop on the CPU).  Each block has its own 90-degree ambiguity and
  transient, resolved by the packet layer's CRC sync, as for bursts.

The mesh, input, output, device and backend conventions are the scale-out
layer's (``parallel/multihost.py``): the stream has its global shape on
every rank, and each rank returns its own block.  The front-end here is
plain torch (the mix and a float32 matmul), as the JAX package computes it
outside Pallas.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from qpsk_tpu_torch.config import TAU, ModemConfig
from qpsk_tpu_torch.modem import _tmat
from qpsk_tpu_torch.ops import acquire, nco
from qpsk_tpu_torch.ops import costas as costas_ops
from qpsk_tpu_torch.ops import rrc as rrc_ops
from qpsk_tpu_torch.ops import timing as timing_ops
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.cuda.costas_kernel import costas_run_cm
from qpsk_tpu_torch.parallel.multihost import (axis_rank, axis_size,
                                               mesh_device, to_mesh)

__all__ = ["rx_frontend_timeparallel", "rx_stream_timeparallel"]


def _start_phases(omega: float, nshards: int, block_len: int) -> np.ndarray:
    """Per-shard NCO start phasor exp(j w s L) as (nshards, 2) float32,
    wrapped in float64 to keep precision at large sample offsets."""
    ang = np.mod(omega * np.arange(nshards, dtype=np.float64) * block_len, TAU)
    return np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)


def _halo_from_left(tail: torch.Tensor, mesh, axis: str):
    """Post the shift of each rank's ``tail`` to its right neighbour on
    ``axis``.  Returns (halo, requests): ``halo`` is the left neighbour's
    tail once every request is waited for, zeros on rank 0.  At axis size
    1 there is nothing to exchange and no call is made."""
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    halo = torch.zeros_like(tail)
    group = mesh.get_group(axis)
    ops = []
    if r + 1 < n:
        ops.append(dist.P2POp(dist.isend, tail,
                              dist.get_global_rank(group, r + 1), group))
    if r > 0:
        ops.append(dist.P2POp(dist.irecv, halo,
                              dist.get_global_rank(group, r - 1), group))
    return halo, (dist.batch_isend_irecv(ops) if ops else [])


def _mixdown_fir_local(cfg: ModemConfig, pcm_local: torch.Tensor,
                       phase0: torch.Tensor, mesh, axis: str) -> CF32:
    """One block: PCM -> mixed down -> halo -> matched filter.

    The halo feeds only the first tile's tail product, so the exchange is
    posted first, the bulk split matmul and the interior tails (local
    slices) run while it is in flight, and only then is it waited for:
    ``wait`` orders the current stream after the exchange, so tile 0's
    tail product comes after it.  The sum keeps the JAX association,
    ``(tail @ T1) + (block @ T2)``, then ``* gain``.  ``fir_precision=
    "exact"``, or a tile shorter than the tail, takes the windowed
    ``rrc_ops.fir_block`` with the halo.
    """
    L = pcm_local.shape[-1]
    ntm1 = cfg.ntaps - 1
    xr = pcm_local.to(torch.float32) / float(cfg.pcm_scale)
    x, _ = nco.mix(CF32(xr, torch.zeros_like(xr)),
                   CF32(phase0[0], phase0[1]), -cfg.omega_center, "fast")
    # the tail stays referenced, unmodified, until its send is waited for
    tail = torch.stack([x.re[L - ntm1:], x.im[L - ntm1:]])
    halo, reqs = _halo_from_left(tail, mesh, axis)
    block = rrc_ops.pick_block(L)
    tmat = _tmat(cfg, block, x.re.device)
    exact = cfg.fir_precision == "exact"
    if exact or block < ntm1:
        for req in reqs:
            req.wait()
        y, _ = rrc_ops.fir_block(x, CF32(halo[0], halo[1]), tmat, cfg.gain,
                                 block, exact=exact)
        return y
    nb = L // block

    def bulk(plane):
        blocks = plane.reshape(nb, block)
        return (blocks @ tmat[ntm1:],
                blocks[:-1, block - ntm1:] @ tmat[:ntm1])

    (br, air), (bi, aii) = bulk(x.re), bulk(x.im)
    for req in reqs:
        req.wait()

    def finish(b, a_int, h):
        a = torch.cat([h[None, :] @ tmat[:ntm1], a_int])
        return ((a + b) * cfg.gain).reshape(L)
    return CF32(finish(br, air, halo[0]), finish(bi, aii, halo[1]))


def _local_block(cfg: ModemConfig, pcm: torch.Tensor, mesh, axis: str,
                 unit: int, what: str) -> tuple:
    """(this rank's block of the (n,) stream on its device, the block's
    NCO start phasor as a (2,) tensor there); ValueError unless
    ``nshards * unit`` divides n, and for a stream on the card given to a
    CPU mesh."""
    nshards, s = axis_size(mesh, axis), axis_rank(mesh, axis)
    n = pcm.shape[-1]
    if pcm.dim() != 1 or n % (nshards * unit):
        raise ValueError(f"{what}: a (n,) stream with n a multiple of "
                         f"{nshards} x {unit}, got {tuple(pcm.shape)}")
    L = n // nshards
    dev = mesh_device(mesh)
    phase0 = _start_phases(-cfg.omega_center, nshards, L)[s]
    return (to_mesh(pcm[s * L:(s + 1) * L], mesh),
            torch.from_numpy(phase0).to(dev))


def rx_frontend_timeparallel(cfg: ModemConfig, pcm: torch.Tensor, mesh,
                             axis: str = "sp") -> CF32:
    """Mix-down + RRC matched filter of a (n,) int16 PCM stream, time
    blocks across ``axis``: this rank's block of the filtered stream, CF32
    (n / S,).  The halo exchange reproduces the streaming delay line, so
    the gathered blocks equal the serial front-end (within float32
    rounding of differently blocked matmuls)."""
    local, phase0 = _local_block(cfg, pcm, mesh, axis, 1,
                                 "rx_frontend_timeparallel")
    return _mixdown_fir_local(cfg, local, phase0, mesh, axis)


def rx_stream_timeparallel(cfg: ModemConfig, pcm: torch.Tensor, mesh,
                           axis: str = "sp"):
    """Demodulate a (n,) int16 PCM stream with time blocks across
    ``axis``.

    Returns this rank's block: (symbols CF32 (nsym / S,), bits (2 nsym /
    S,) int32, freq_hz (1,)).  The block's Costas loop is warm-started by
    its own FFT acquisition and runs with the gear shift when
    ``loop_bw_track > 0``; the bits are the diagonal slicer's, whatever
    ``cfg.slicer`` says, as in the JAX package.  Raises ValueError for a
    modulation other than QPSK and for a length that ``S * frame_size``
    does not divide."""
    if cfg.modulation != "qpsk":
        # the block-local demod below is QPSK's (4th-power acquisition,
        # sign-detector Costas, QPSK slicer)
        raise ValueError(
            f"rx_stream_timeparallel is QPSK-only, got {cfg.modulation!r}")
    local, phase0 = _local_block(cfg, pcm, mesh, axis, cfg.frame_size,
                                 "rx_stream_timeparallel")
    L = local.shape[-1]
    y = _mixdown_fir_local(cfg, local, phase0, mesh, axis)

    # per-frame timing, one index a frame, local to the block
    frames = CF32(y.re.reshape(-1, cfg.frame_size),
                  y.im.reshape(-1, cfg.frame_size))
    p, _ = timing_ops.estimate_and_decimate(frames, cfg.cycles,
                                            cfg.timing_mode)
    nsym = p.re.numel()
    picks = CF32(p.re.reshape(1, nsym), p.im.reshape(1, nsym))

    # block-local carrier re-acquisition -> a warm loop, the block as one
    # channel of the Costas kernel
    nfft = min(cfg.nfft, L)
    f_hz = acquire.acquire_freq_hz(CF32(y.re[:nfft], y.im[:nfft]), cfg.fs,
                                   nfft=nfft)
    freq0 = torch.clamp(acquire.hz_to_costas_freq(f_hz, cfg.rs),
                        cfg.min_freq, cfg.max_freq).reshape(1)
    gear = costas_ops.gear_for(cfg.loop_bw_track, cfg.damping)
    params = costas_ops.costas_params(cfg.loop_bw, cfg.damping, cfg.min_freq,
                                      cfg.max_freq)
    cstate, derot, _, bits = costas_run_cm(
        costas_ops.costas_init_from_freq(freq0, gear is not None), picks,
        params, nsym, gear=gear, impl=cfg.costas_impl)
    return (CF32(derot.re.reshape(nsym), derot.im.reshape(nsym)),
            bits.reshape(2 * nsym), costas_ops.freq_to_hz(cstate.freq, cfg.rs))
