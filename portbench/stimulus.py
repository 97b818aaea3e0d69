"""The benchmark's own transmitter: every cell's input, made on the device
from ``--seed`` at set-up.

It follows the program's transmit side as it stood at commit 7bb37cf
(``qpsk_tpu_torch/modem.py`` ``tx_stream``: zero-stuffing at phase 0 of
each symbol group, the RRC FIR with its second gain multiply, the carrier,
``pcm_scale``; ``packet/frame.py`` ``assemble_packet``: CRC-16, the K=7
code, the scrambler, the interleaver; ``fdm.py`` ``fdm_mux_stream``: the
cosine product and the synthesis branch FIRs; ``channel.py`` ``awgn_pcm``:
the SNR of the clean PCM's mean power), with the filter designs of
``portbench.reference``, and made circular: a buffer of whole periods, the
pulse shaping and the synthesis bank wrapped around it, the carrier a whole
number of cycles, so replaying it has no seam and the receive loops never
re-acquire.

Each channel has its carrier offset (``offsets``), the loops are
warm-started at it (``warm_freq``) and each carrier's phase is set so that
its loop starts at its lock: the output symbol ``t``
carries transmitted symbol ``t - delay`` on the diagonal ``e^{j pi/4}``,
rotation 0.  So in the coded cell the payload bits come out where they were
sent and every whole packet of a call meets the timed path's cut.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import fdm as ref_fdm
from portbench.reference import packet as ref_packet
from portbench.reference.rx import rrc_taps

TAU = 2.0 * math.pi
# constellation[(b1 << 1) | b0]
_CONST = ((1.0, 0.0), (0.0, 1.0), (0.0, -1.0), (-1.0, 0.0))
_BLOCK_SAMPLES = 1 << 25   # samples of a period made at a time


def cycles(modem: dict) -> int:
    return int(modem["fs"] // modem["rs"])


def delay_symbols(modem: dict) -> int:
    """Output symbols between a transmitted symbol and its slice: the two
    filters' delay (whole symbols) and the one-frame delay."""
    return (modem["ntaps"] - 1) // cycles(modem) + (
        modem["frame_size"] // cycles(modem))


def period_samples(modem: dict, traffic: dict) -> int:
    return traffic["period_calls"] * traffic["frames_per_call"] * \
        modem["frame_size"]


def offsets(gen: torch.Generator, modem: dict, traffic: dict, chans: int,
            device) -> torch.Tensor:
    """Each channel's carrier offset, Hz (C,) float64: the grid of whole
    cycles a period from ``offset_hz - offset_spread_hz`` to ``offset_hz +
    offset_spread_hz``, tiled over the channels in an order drawn from the
    seed, so every seed has the same set of offsets."""
    step = modem["fs"] / period_samples(modem, traffic)
    k = int(traffic["offset_spread_hz"] // step)
    grid = traffic["offset_hz"] + step * torch.arange(
        -k, k + 1, dtype=torch.float64, device=device)
    order = torch.randperm(chans, generator=gen, device=device)
    return grid[order % grid.numel()]


def warm_freq(modem: dict, offset_hz: torch.Tensor) -> torch.Tensor:
    """The loop frequency of each offset, rad/symbol, float32."""
    return (TAU * offset_hz / modem["rs"]).to(torch.float32)


def carrier_phase(modem: dict, offset_hz: torch.Tensor) -> torch.Tensor:
    """The carrier phase that puts each loop at its rotation-0 lock from
    its start at phase 0 and ``warm_freq``."""
    wc = TAU * modem["center"] / modem["fs"]
    lag = cycles(modem) * delay_symbols(modem) - (modem["ntaps"] - 1) / 2.0
    return math.pi / 4.0 + wc + TAU * offset_hz / modem["fs"] * lag


def check_period(modem: dict, traffic: dict) -> None:
    """Raise unless a period of the traffic holds whole cycles of the
    receiver's carrier and of the offsets' grid."""
    n = period_samples(modem, traffic)
    for hz in (modem["center"], traffic["offset_hz"]):
        if (hz * n) % modem["fs"]:
            raise ValueError(f"a period of {n} samples holds no whole cycle "
                             f"count of {hz} Hz")


def packets(gen: torch.Generator, npkt: int, payload_bytes: int,
            device) -> tuple:
    """(payload bits (npkt, 8 payload_bytes), frame bits (npkt,
    2 (8 payload_bytes + 22))), uint8: CRC-16 appended high byte first,
    each byte least significant bit first; the K=7 code, tail-terminated;
    the keystream; the golden-prime interleave."""
    u8 = torch.uint8
    nb = 8 * payload_bytes
    pay = torch.randint(0, 2, (npkt, nb), generator=gen, device=device,
                        dtype=u8)
    crc = ref_packet.crc16(ref_packet.to_bytes(pay))
    shifts = torch.arange(8, device=device)
    crc_bits = torch.cat([(crc[:, None] >> 8 >> shifts) & 1,
                          (crc[:, None] >> shifts) & 1], dim=1).to(u8)
    tail = torch.zeros((npkt, ref_packet.K - 1), dtype=u8, device=device)
    u = torch.cat([pay, crc_bits, tail], dim=1)
    steps = u.shape[1]
    padded = torch.cat([tail, u], 1)
    outs = []
    for g in ref_packet.POLYS:
        acc = torch.zeros_like(u)
        for bit in range(ref_packet.K):
            if (g >> bit) & 1:
                start = ref_packet.K - 1 - bit
                acc = acc ^ padded[:, start:start + steps]
        outs.append(acc)
    coded = torch.stack(outs, dim=-1).reshape(npkt, -1)
    n = coded.shape[1]
    coded = coded ^ torch.as_tensor(ref_packet.keystream(n), dtype=u8,
                                    device=device)
    frame = torch.empty_like(coded)
    frame[:, torch.as_tensor(ref_packet.deinterleave_index(n),
                             device=device)] = coded
    return pay, frame


def _modulate(modem: dict, dibits: torch.Tensor, offset_hz: torch.Tensor,
              phase: torch.Tensor) -> torch.Tensor:
    """(C, S) dibits ``(b1 << 1) | b0`` of one period, each channel's
    offset and carrier phase (C,) -> clean float64 passband PCM
    (C, S cycles), circular."""
    cyc = cycles(modem)
    c, s = dibits.shape
    n = s * cyc
    table = torch.tensor(_CONST, dtype=torch.float64, device=dibits.device)
    sym = table[dibits.long()]
    up = torch.zeros((c, s, cyc, 2), dtype=torch.float64,
                     device=dibits.device)
    up[:, :, 0] = sym
    up = torch.complex(up[..., 0], up[..., 1]).reshape(c, n)
    h = torch.zeros(n, dtype=torch.float64, device=dibits.device)
    h[:modem["ntaps"]] = torch.as_tensor(
        rrc_taps(modem["fs"], modem["rs"], modem["alpha"], modem["ntaps"],
                 modem["gain"]), device=dibits.device)
    base = torch.fft.ifft(torch.fft.fft(up) * torch.fft.fft(h)) * \
        modem["gain"]
    w1 = TAU * (modem["center"] + offset_hz[:, None]) / modem["fs"]
    k = torch.arange(n, dtype=torch.float64, device=dibits.device)
    ang = torch.remainder(w1 * k + phase[:, None], TAU)
    return (base * torch.polar(torch.ones_like(ang), ang)).real * \
        modem["pcm_scale"]


def _noisy(gen: torch.Generator, clean: torch.Tensor, snr_db: float,
           power: float, pcm_scale: float) -> torch.Tensor:
    sigma = math.sqrt(power / 10.0 ** (snr_db / 10.0)) * pcm_scale
    noise = torch.randn(clean.shape, generator=gen, dtype=torch.float32,
                        device=clean.device)
    return torch.clamp(torch.round(clean + noise.to(torch.float64) * sigma),
                       -32768, 32767).to(torch.int16)


def channel_pcm(gen: torch.Generator, modem: dict, dibits: torch.Tensor,
                offset_hz: torch.Tensor, snr_db: float) -> torch.Tensor:
    """(C, S) dibits -> (C, S cycles) int16 noisy passband PCM, one period,
    made a block of channels at a time, twice: first for the clean PCM's
    mean power over all channels, which sets the noise's, then for the
    noisy PCM."""
    phase = carrier_phase(modem, offset_hz)
    n = dibits.shape[1] * cycles(modem)
    step = max(1, _BLOCK_SAMPLES // n)
    blocks = [slice(i, i + step) for i in range(0, dibits.shape[0], step)]

    def clean(b):
        return _modulate(modem, dibits[b], offset_hz[b], phase[b])
    power = sum(float((clean(b) / modem["pcm_scale"]).pow(2).sum())
                for b in blocks) / (dibits.shape[0] * n)
    out = torch.empty((dibits.shape[0], n), dtype=torch.int16,
                      device=dibits.device)
    for b in blocks:
        out[b] = _noisy(gen, clean(b), snr_db, power, modem["pcm_scale"])
    return out


def mux(pcm: torch.Tensor, nslots: int, taps_per_branch: int,
        beta: float) -> torch.Tensor:
    """(nchan, M) int16 subchannel PCM of one period -> (M nslots,) int16
    wideband, circular: ``fdm_mux_stream``'s float32 cosine product and
    branch FIRs, the history wrapped from the period's end."""
    n, q = nslots, taps_per_branch
    nchan = n // 2 - 1
    dev = pcm.device
    g = torch.as_tensor(ref_fdm.prototype(n, q, beta, float(n))
                        .reshape(q, n), dtype=torch.float32, device=dev)
    wc = torch.as_tensor(ref_fdm.cosines(n).T, dtype=torch.float32,
                         device=dev)
    x = pcm.to(torch.float32)
    x = torch.cat([x[:, -(q - 1):], x], dim=1)
    t = torch.matmul(x.T, wc) / float(nchan)
    m = pcm.shape[1]
    out = torch.zeros((m, n), dtype=torch.float32, device=dev)
    for k in range(q):
        out = out + g[k] * t[q - 1 - k:q - 1 - k + m]
    return torch.clamp(torch.round(out.reshape(-1)), -32768,
                       32767).to(torch.int16)
