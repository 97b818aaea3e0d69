"""Generator ``coded_link``: ``circular_link``'s channels carrying one coded
packet link, striped over the channels in the order the timed path
flattens them, so every whole packet of a call meets the path's cut and
passes its CRC with the payload sent.

The timed path is ``rx_stream``, then ``ops.modmap.demod_soft`` on the
call's symbols flattened channel by channel, cut into frames of the code
(the last zero-padded, as ``qpsk_tpu_torch.benchmarks.coded_rx_throughput``
cuts them), then ``packet.frame.disassemble_packet_soft`` (deinterleave,
descramble, the Viterbi kernel, CRC).  The configuration's ``packet``
holds the ``PacketConfig``; the traffic file's fields are
``circular_link``'s.
"""

from __future__ import annotations

import torch

from portbench import judge, stimulus
from portbench.generators import circular_link, span
from portbench.reference import packet as ref_packet

channels = circular_link.channels


def check(cell) -> None:
    if cell.config.get("packet") is None:
        raise ValueError(f"{cell.name}: coded_link needs a configuration "
                         f"with a packet")


def frame_bits(cell) -> int:
    return 2 * (8 * cell.config["packet"]["payload_bytes"] + 16
                + ref_packet.K - 1)


def bits_per_call(cell) -> int:
    """Soft bits a call: two a symbol of every channel."""
    return cell.samples_per_call // stimulus.cycles(cell.modem) * 2


def make(cell, seed: int, device) -> dict:
    """``circular_link``'s stimulus with the link's packets as its symbols,
    and ``sent``, the payload bits of each call of the period."""
    gen, hz, out = circular_link.start(cell, seed, device)
    bits = bits_per_call(cell)
    per_call = bits // (2 * cell.channels)       # symbols a channel
    npkt = -(-bits // frame_bits(cell))
    sent, links = [], []
    for _ in range(cell.traffic["period_calls"]):
        pay, frame = stimulus.packets(
            gen, npkt, cell.config["packet"]["payload_bytes"], device)
        sent.append(pay)
        links.append(frame.reshape(-1)[:bits].reshape(cell.channels,
                                                      per_call, 2))
    want = torch.cat(links, dim=1)               # output dibits, (C, P, 2)
    want = (want[..., 0] << 1) | want[..., 1]
    # the output symbol t carries the transmitted symbol t - delay
    dibits = torch.roll(want, -stimulus.delay_symbols(cell.modem), dims=1)
    del want, links
    pcm = stimulus.channel_pcm(gen, cell.modem, dibits, hz,
                               cell.config["snr_db"])
    del dibits
    out["sent"] = torch.stack(sent)
    out["judged"] = circular_link.draw_judged(cell, gen, device)
    out["calls"] = circular_link.split_calls(cell, pcm)
    return out


class System(circular_link.System):
    """``rx_stream``, then the packet path on its symbols."""

    def __init__(self, cell, device, stim: dict, spans: bool = False):
        super().__init__(cell, device, stim, spans)
        from qpsk_tpu_torch.ops.modmap import demod_soft
        from qpsk_tpu_torch.packet.frame import (PacketConfig,
                                                 disassemble_packet_soft)
        self.pcfg = PacketConfig(**cell.config["packet"])
        self._soft, self._disassemble = demod_soft, disassemble_packet_soft
        bits = bits_per_call(cell)
        self.npkt = -(-bits // self.pcfg.frame_bits)
        self.pad = self.npkt * self.pcfg.frame_bits - bits

    def call(self, state: dict, x) -> tuple:
        state, out = super().call(state, x)
        with span("packet_path", self.spans):
            sym = out["rx"].symbols
            llr = self._soft(type(sym)(sym.re.reshape(-1),
                                       sym.im.reshape(-1)))
            llr = torch.cat([llr, llr.new_zeros(self.pad)])
            out["llr"] = llr
            out["packets"] = self._disassemble(self.pcfg,
                                               llr.reshape(self.npkt, -1))
        return state, out

    def view(self, state: dict, out: dict | None = None) -> dict:
        v = super().view(state, out)
        if out is not None:
            v.update(llr=out["llr"], payload=out["packets"].payload_bits,
                     crc=out["packets"].crc_ok)
        return v


def numbers(cell, stim: dict, rec, device, last: bool) -> dict:
    """``circular_link``'s numbers and ``llr_gap``, the widest soft-bit gap
    over the symbols' RMS on the judged channels; ``decode_wrong``, packets
    whose payload or CRC verdict differ from the reference decoder's on the
    program's own soft bits (every packet); and on the last call
    ``packets_lost``, the whole packets whose CRC fails or whose payload is
    not the one sent, which is printed and judges nothing."""
    per_chan = bits_per_call(cell) // cell.channels
    p = rec.after
    llr_p = p["llr"][:cell.channels * per_chan].reshape(cell.channels,
                                                        per_chan)

    def llr_gap(sl, sym_r, rms):
        llr_r = ref_packet.soft_bits(sym_r.reshape(sym_r.shape[0], -1))
        return {"llr_gap": float((llr_p[sl] - llr_r).abs().max()) / rms}
    out = judge.rx_numbers(
        cell, stim, rec, device,
        lambda i: circular_link.modem_input(stim, i), llr_gap)
    nb = 8 * cell.config["packet"]["payload_bytes"]
    npkt = p["payload"].shape[0]
    pay, ok = ref_packet.decode(p["llr"].reshape(npkt, -1).float(), nb)
    out["decode_wrong"] = int(((pay != p["payload"]).any(dim=1)
                               | (ok != p["crc"])).sum())
    if last:
        whole = bits_per_call(cell) // frame_bits(cell)
        sent = stim["sent"][rec.index % len(stim["calls"])][:whole].to(
            p["payload"].dtype)
        lost = (~p["crc"][:whole]) | (p["payload"][:whole] != sent).any(1)
        out["packets_lost"] = int(lost.sum())
    return out


class Control(circular_link.Control):
    """The reference receive, then the reference decoder with its path
    metrics in bfloat16 (the decoder states float32)."""

    def call(self, state: dict, x) -> tuple:
        new, out = super().call(state, x)
        llr = ref_packet.soft_bits(out["symbols"].reshape(-1)).float()
        fb = frame_bits(self.cell)
        npkt = -(-llr.shape[0] // fb)
        llr = torch.cat([llr, llr.new_zeros(npkt * fb - llr.shape[0])])
        out["llr"] = llr
        out["payload"], out["crc"] = ref_packet.decode(
            llr.reshape(npkt, fb), 8 * self.cell.config["packet"][
                "payload_bytes"], dtype=torch.bfloat16)
        return new, out
