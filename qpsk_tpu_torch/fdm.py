"""FDM multi-carrier: many QPSK subchannels in one wideband PCM stream
(port of ``qpsk_tpu.fdm``).

``nchan`` independent, unmodified modem channels, each the real 9600 S/s
passband signal ``tx_stream`` emits, are frequency-division multiplexed
into one real wideband stream at ``nslots * fs`` samples/s and split back.
The per-channel modem is untouched: the batched RX takes the subchannels
as its channel axis.

A critically sampled polyphase-DFT filterbank in which every stage is a
matrix product or a static-shift FIR:

* **Band plan.**  Slot ``c`` of an ``N = nslots`` bank sits at ``c * fs``
  Hz of the wideband rate ``N * fs``; a real subchannel occupies its slot
  and the conjugate mirror, so the usable channels are slots
  ``1 .. N/2 - 1``.
* **Synthesis** (``fdm_mux``): the slot carrier ``cos(2*pi*c*n/N)``
  depends only on ``n mod N``, so modulate-then-sum is one cosine-matrix
  product across channels followed by the polyphase interpolation FIR of
  a shared Kaiser prototype.
* **Analysis** (``fdm_demux``): the dual, polyphase branch FIRs over the
  phase-reversed wideband blocks, then one DFT-cosine product gives every
  slot's mixed-down, lowpassed, N-decimated output.  For a real input the
  real part of the complex mix holds ``x_c / 2``, so a factor 2 restores
  unit gain.
* **Streaming**: both directions carry their FIR branch history
  (``FdmState``), so chunked calls chain with one-shot calls.

The prototypes are the rational resampler's (``ops.resample
.resampler_taps``): analysis the 1/N decimator, synthesis the N/1
interpolator (gain N), both cut at the slot Nyquist ``fs/2``.  The host
tables are cached by device, so a call copies nothing from the host.  The
products are float32 ``torch.matmul`` (the JAX package computes them
outside any Pallas kernel too); TF32 stays off, as torch leaves it, since
the demuxed int16 PCM follows the float32 sums.

Headroom: ``fdm_mux`` scales the sum by ``1/nchan`` so the int16 wideband
cannot clip whatever the channels' phases; ``fdm_demux`` undoes it.
"""

from __future__ import annotations

import dataclasses
import functools
import io
from typing import NamedTuple

import numpy as np
import torch

from qpsk_tpu_torch import tracing
from qpsk_tpu_torch.channel import _to_pcm
from qpsk_tpu_torch.ops.resample import resampler_taps
from qpsk_tpu_torch.runtime import StreamDemodulator, _on
from qpsk_tpu_torch.utils.checkpoint import savez_exact


@dataclasses.dataclass(frozen=True)
class FdmConfig:
    """Band plan for an ``nslots``-slot DFT bank over slot width ``fs``."""
    nslots: int = 8
    fs: float = 9600.0
    taps_per_branch: int = 16
    beta: float = 8.0

    def __post_init__(self):
        if self.nslots < 4 or self.nslots % 2:
            raise ValueError("nslots must be even and >= 4")

    @property
    def nchan(self) -> int:
        """Usable subchannels (slots 1 .. nslots/2 - 1)."""
        return self.nslots // 2 - 1

    @property
    def wide_fs(self) -> float:
        return self.nslots * self.fs

    def slot_center_hz(self, chan: int, modem_center: float) -> float:
        """Absolute carrier frequency of channel ``chan`` (0-based) in the
        wideband spectrum (its slot offset plus the modem's own carrier)."""
        return (chan + 1) * self.fs + modem_center


class FdmState(NamedTuple):
    """Carried streaming state: ``hist`` = (Q-1, N) rows of branch-FIR
    input history (both directions); ``tail`` = the previous chunk's last
    N-1 wideband samples (demux only: the phase-reversed blocks straddle
    chunk boundaries by N-1 samples).  The JAX package's leaf order."""
    hist: torch.Tensor
    tail: torch.Tensor


@functools.lru_cache(maxsize=None)
def _bank(nslots: int, taps_per_branch: int, beta: float):
    """(g2, h2, wc_syn, wc_ana), numpy float32: synthesis / analysis
    polyphase taps (Q, N) and the cosine matrices of the channel <-> phase
    products."""
    n = nslots
    g = resampler_taps(n, 1, taps_per_branch, beta)   # interp proto, sum=N
    h = resampler_taps(1, n, taps_per_branch, beta)   # decim proto, sum=1
    q = len(g) // n
    g2 = g.reshape(q, n).astype(np.float32)           # g[q*N + r]
    h2 = h.reshape(q, n).astype(np.float32)           # h[q*N + p]
    # synthesis: t[m, r] = sum_c x_c[m] cos(2*pi*(c+1)*r / N)  (slot c+1)
    r = np.arange(n)
    usable = np.arange(1, n // 2)                     # slots 1..N/2-1
    wc_syn = np.cos(2.0 * np.pi * np.outer(usable, r) / n).astype(np.float32)
    # analysis: y_c[m] = sum_p u[m, p] cos(2*pi*(c+1)*p / N)
    wc_ana = np.cos(2.0 * np.pi * np.outer(r, usable) / n).astype(np.float32)
    return g2, h2, wc_syn, wc_ana


@functools.lru_cache(maxsize=None)
def _bank_on(nslots: int, taps_per_branch: int, beta: float,
             device: torch.device) -> tuple:
    """``_bank``'s four tables on ``device``, copied there once."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in _bank(nslots, taps_per_branch, beta))


def fdm_taps_per_branch(fcfg: FdmConfig) -> int:
    g2, _, _, _ = _bank(fcfg.nslots, fcfg.taps_per_branch, fcfg.beta)
    return g2.shape[0]


def fdm_init(fcfg: FdmConfig, device="cuda") -> FdmState:
    """Zero history (silence before the stream), either direction, on
    ``device``."""
    q = fdm_taps_per_branch(fcfg)
    return FdmState(
        hist=torch.zeros((q - 1, fcfg.nslots), dtype=torch.float32,
                         device=device),
        tail=torch.zeros((fcfg.nslots - 1,), dtype=torch.float32,
                         device=device))


def _branch_fir(v: torch.Tensor, taps: torch.Tensor,
                state: FdmState) -> tuple[torch.Tensor, FdmState]:
    """Per-phase FIR over the block axis: (M, N) blocks x (Q, N) taps ->
    (M, N), with carried (Q-1, N) history.  Static shifted slices, summed
    from tap 0 up in the JAX package's order (the int16 rounding of the
    output follows the float32 sums)."""
    q = taps.shape[0]
    vv = torch.cat([state.hist, v], dim=0)               # (M+Q-1, N)
    m = v.shape[0]
    out = torch.zeros_like(v)
    for k in range(q):
        # u[m] += taps[k] * vv[m + (Q-1) - k]
        out = out + taps[k] * vv[q - 1 - k: q - 1 - k + m]
    return out, state._replace(hist=vv[-(q - 1):].clone())


def fdm_mux_stream(fcfg: FdmConfig, pcm: torch.Tensor, state: FdmState):
    """Multiplex (nchan, M) int16 subchannel PCM into (M * nslots,) int16
    wideband PCM.  Chunked calls chain with one-shot via ``state``."""
    g2, _, wc_syn, _ = _bank_on(fcfg.nslots, fcfg.taps_per_branch,
                                fcfg.beta, pcm.device)
    if pcm.dim() != 2 or pcm.shape[0] != fcfg.nchan:
        raise ValueError(f"PCM of shape {tuple(pcm.shape)}, expected "
                         f"({fcfg.nchan}, M)")
    x = pcm.to(torch.float32)
    # channel -> phase product: t (M, N)
    t = torch.matmul(x.T, wc_syn)
    t = t / float(fcfg.nchan)                            # clip headroom
    y, state = _branch_fir(t, g2, state)                 # (M, N)
    return _to_pcm(y.reshape(-1)), state


def fdm_demux_stream(fcfg: FdmConfig, wide: torch.Tensor, state: FdmState):
    """Split (M * nslots,) int16 wideband PCM back into (nchan, M) int16
    subchannel PCM (each the standard modem-rate passband signal)."""
    with tracing.span("fdm.demux"):
        _, h2, _, wc_ana = _bank_on(fcfg.nslots, fcfg.taps_per_branch,
                                    fcfg.beta, wide.device)
        n = fcfg.nslots
        if wide.dim() != 1 or wide.shape[0] % n:
            raise ValueError(f"wideband PCM of shape {tuple(wide.shape)}: "
                             f"one stream of whole {n}-sample blocks "
                             f"expected")
        w = wide.to(torch.float32)
        mtot = w.shape[0] // n
        # z[m*N + (N-1-p)] = x[m*N - p]: the previous chunk's last N-1
        # samples in front (zeros at stream start), then the lanes
        # phase-reversed
        z = torch.cat([state.tail, w])
        state = state._replace(tail=z[-(n - 1):].clone())
        v = z[: mtot * n].reshape(mtot, n).flip(-1)      # (M, N)
        u, state = _branch_fir(v, h2, state)
        # float32 product (TF32 stays off, torch's default): the demuxed
        # int16 PCM follows these sums, which the 2*nchan gain below
        # magnifies
        y = torch.matmul(u, wc_ana)                      # (M, nchan)
        # x2: the real part of the complex mix leaves x_c/2; x nchan: undo
        # the mux headroom backoff
        y = y * float(2.0 * fcfg.nchan)
        return _to_pcm(y.T), state


def fdm_mux(fcfg: FdmConfig, pcm: torch.Tensor) -> torch.Tensor:
    """One-shot ``fdm_mux_stream`` from silence."""
    wide, _ = fdm_mux_stream(fcfg, pcm, fdm_init(fcfg, pcm.device))
    return wide


def fdm_demux(fcfg: FdmConfig, wide: torch.Tensor) -> torch.Tensor:
    """One-shot ``fdm_demux_stream`` from silence."""
    pcm, _ = fdm_demux_stream(fcfg, wide, fdm_init(fcfg, wide.device))
    return pcm


class FdmReceiver:
    """Push-mode wideband receiver: ``fdm_demux_stream`` feeding one
    ``StreamDemodulator`` per subchannel, on the card unless the caller
    passes ``device="cpu"``.

        rx = FdmReceiver(FdmConfig(nslots=8), ModemConfig(), pcfg)
        for chunk in wideband_source:        # int16, any chunk size
            for chan, pkts in enumerate(rx.push(chunk)):
                ...

    Wideband samples buffer to a bucket of ``bucket_blocks * nslots``
    samples, as in the JAX package: packet emission depends on where the
    buckets fall, so the packets equal the JAX receiver's on the same
    chunks.  Each bucket demuxes once and pushes every subchannel's PCM
    into its demodulator."""

    def __init__(self, fcfg: FdmConfig, cfg, pcfg, bucket_blocks: int = 4096,
                 device="cuda", **demod_kwargs):
        self.fcfg = fcfg
        self._dev = _on(device)
        self.demods = [StreamDemodulator(cfg, pcfg, device=self._dev,
                                         **demod_kwargs)
                       for _ in range(fcfg.nchan)]
        self._state = fdm_init(fcfg, self._dev)
        self._bucket = bucket_blocks * fcfg.nslots
        self._buf = np.zeros(0, np.int16)

    def _demux(self, wide: np.ndarray) -> np.ndarray:
        pcm, self._state = fdm_demux_stream(
            self.fcfg, torch.from_numpy(wide).to(self._dev), self._state)
        return pcm.cpu().numpy()

    def push(self, wide) -> list[list]:
        """Feed wideband int16 PCM; returns per-channel packet lists."""
        wide = np.asarray(wide, np.int16).ravel()
        self._buf = np.concatenate([self._buf, wide])
        out = [[] for _ in range(self.fcfg.nchan)]
        while self._buf.size >= self._bucket:
            pcm = self._demux(self._buf[:self._bucket])
            self._buf = self._buf[self._bucket:]
            for c, d in enumerate(self.demods):
                out[c].extend(d.push(pcm[c]))
        return out

    def flush(self) -> list[list]:
        """Demux the buffered remainder (zero-padded to one bucket) and
        flush every subchannel demodulator."""
        out = [[] for _ in range(self.fcfg.nchan)]
        if self._buf.size:
            pad = np.zeros(self._bucket - self._buf.size, np.int16)
            pcm = self._demux(np.concatenate([self._buf, pad]))
            self._buf = np.zeros(0, np.int16)
            for c, d in enumerate(self.demods):
                out[c].extend(d.push(pcm[c]))
        for c, d in enumerate(self.demods):
            out[c].extend(d.flush())
        return out

    def save(self, path) -> None:
        """Checkpoint the wideband receiver: the filterbank state, the
        wideband sample buffer and every subchannel demodulator, one .npz
        in the JAX package's layout (``wide_buf``, ``fb_leaf_0/1``,
        ``chan_<c>``), so either package resumes it; resume with ``load``
        on an FdmReceiver built with the same configs."""
        arrays = {"wide_buf": self._buf}
        for i, leaf in enumerate(self._state):
            arrays[f"fb_leaf_{i}"] = leaf.cpu().numpy()
        for c, d in enumerate(self.demods):
            buf = io.BytesIO()
            d.save(buf)
            arrays[f"chan_{c}"] = np.frombuffer(buf.getvalue(), np.uint8)
        savez_exact(path, **arrays)

    def load(self, path) -> None:
        """Restore a checkpoint written by ``save`` of either package."""
        data = np.load(path)
        self._buf = data["wide_buf"].astype(np.int16)
        self._state = FdmState(*(
            torch.from_numpy(np.asarray(data[f"fb_leaf_{i}"], np.float32))
            .to(self._dev) for i in range(len(FdmState._fields))))
        for c, d in enumerate(self.demods):
            d.load(io.BytesIO(data[f"chan_{c}"].tobytes()))
