"""Generator ``fdm_link``: an FDM gateway's usable subchannels,
``nslots / 2 - 1`` of them, each ``circular_link``'s uncoded link,
multiplexed by the benchmark's own synthesis bank into one wideband int16
stream at ``nslots`` times the modem's rate, made circular on the device
and replayed.

The timed path is ``fdm.fdm_demux_stream`` on the wideband call, then
``rx_stream`` over the demuxed subchannels, both states chained.  The
traffic file's ``fdm`` holds the ``FdmConfig`` (``nslots``, ``fs``,
``taps_per_branch``, ``beta``); its other fields are ``circular_link``'s,
less ``channels``.  Beside ``circular_link``'s numbers the judge compares
``pcm_gap_lsb``, the widest gap of a demuxed subchannel sample against the
reference bank's.
"""

from __future__ import annotations

import torch

from portbench import judge, stimulus
from portbench.generators import circular_link, span
from portbench.reference import fdm as ref_fdm

check = circular_link.check


def channels(cell) -> int:
    return cell.traffic["fdm"]["nslots"] // 2 - 1


def _fdm(cell) -> tuple:
    f = cell.traffic["fdm"]
    return f["nslots"], f["taps_per_branch"], f["beta"]


def make(cell, seed: int, device) -> dict:
    gen, hz, out = circular_link.start(cell, seed, device)
    dibits = torch.randint(0, 4, (cell.channels,
                                  circular_link.period_symbols(cell)),
                           generator=gen, device=device, dtype=torch.uint8)
    pcm = stimulus.channel_pcm(gen, cell.modem, dibits, hz,
                               cell.config["snr_db"])
    del dibits
    out["judged"] = circular_link.draw_judged(cell, gen, device)
    wide = stimulus.mux(pcm, *_fdm(cell))
    out["calls"] = list(wide.reshape(cell.traffic["period_calls"], -1)
                        .clone().unbind(0))
    return out


class System(circular_link.System):
    """``fdm_demux_stream``, then ``rx_stream`` on its subchannels."""

    def __init__(self, cell, device, stim: dict, spans: bool = False):
        super().__init__(cell, device, stim, spans)
        from qpsk_tpu_torch.fdm import FdmConfig, fdm_demux_stream, fdm_init
        self.fcfg = FdmConfig(**cell.traffic["fdm"])
        self._fdm_init, self._demux = fdm_init, fdm_demux_stream

    def init(self) -> dict:
        return {**super().init(), "fb": self._fdm_init(self.fcfg,
                                                       self.device)}

    def _chans(self, chans):
        return chans.reshape(self.cell.channels, self.cell.frames,
                             self.cell.modem["frame_size"])

    def call(self, state: dict, x) -> tuple:
        with span("fdm_bank", self.spans):
            chans, fb = self._demux(self.fcfg, x, state["fb"])
        state, out = super().call({**state, "fb": fb}, self._chans(chans))
        out["chans"] = chans
        return state, out

    def view(self, state: dict, out: dict | None = None) -> dict:
        v = super().view(state, out)
        if out is not None:
            v["chans"] = out["chans"]
        return v


def modem_input(cell, stim: dict, i: int):
    """Call ``i``'s subchannel PCM as the reference bank demuxes it (None
    before the stream)."""
    x = circular_link.modem_input(stim, i)
    if x is None:
        return None
    prev = circular_link.modem_input(stim, i - 1) if i > 0 else None
    return ref_fdm.demux(x, prev, *_fdm(cell)).reshape(
        cell.channels, cell.frames, cell.modem["frame_size"])


def numbers(cell, stim: dict, rec, device, last: bool) -> dict:
    demuxed = {}

    def pcm_of(i):
        if i not in demuxed:
            demuxed[i] = modem_input(cell, stim, i)
        return demuxed[i]
    out = judge.rx_numbers(cell, stim, rec, device, pcm_of)
    ref = pcm_of(rec.index).reshape(cell.channels, -1)
    out["pcm_gap_lsb"] = int((rec.after["chans"].to(torch.int32)
                              - ref.to(torch.int32)).abs().max())
    return out


class Control(circular_link.Control):
    """The reference bank with its cosine product in TF32 (the bank states
    float32 with TF32 off), then the reference receive."""

    def call(self, state: dict, x) -> tuple:
        chans = ref_fdm.demux(x, state.get("prev_wide"), *_fdm(self.cell),
                              tf32=True)
        new, out = super().call(state, chans.reshape(
            self.cell.channels, self.cell.frames,
            self.cell.modem["frame_size"]))
        new["prev_wide"] = x
        out["chans"] = chans
        return new, out
