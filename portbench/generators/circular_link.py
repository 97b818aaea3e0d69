"""Generator ``circular_link``: a gateway's channels, each an uncoded QPSK
link at its own carrier offset with Gaussian noise at the configuration's
``snr_db``; one seamless period of ``period_calls`` calls is made on the
device and replayed.  The timed path is ``modem.rx_stream`` on
``(C, F, frame_size)`` int16 PCM, the state chained from call to call.

Its traffic file's fields, all required: ``channels``,
``frames_per_call``, ``period_calls``, ``offset_hz`` and
``offset_spread_hz`` (``stimulus.offsets``), ``warmup_calls``,
``judge_channels`` (how many channels the judge compares, drawn from the
seed).

``coded_link`` and ``fdm_link`` build on this module.
"""

from __future__ import annotations

import torch

from portbench import judge, stimulus
from portbench.generators import span
from portbench.reference import rx as ref_rx


def check(cell) -> None:
    if cell.config.get("packet") is not None:
        raise ValueError(f"{cell.name}: a coded configuration needs the "
                         f"coded_link generator")


def channels(cell) -> int:
    return cell.traffic["channels"]


def start(cell, seed: int, device) -> tuple:
    """(the seed's generator, each channel's offset in Hz, the stimulus
    dict with ``warm_freq``): the first draws of every link generator."""
    stimulus.check_period(cell.modem, cell.traffic)
    gen = torch.Generator(device=device).manual_seed(seed)
    hz = stimulus.offsets(gen, cell.modem, cell.traffic, cell.channels,
                          device)
    return gen, hz, {"warm_freq": stimulus.warm_freq(cell.modem, hz)}


def period_symbols(cell) -> int:
    """Symbols a channel in one period."""
    m = cell.modem
    return cell.traffic["period_calls"] * cell.frames * (
        m["frame_size"] // stimulus.cycles(m))


def draw_judged(cell, gen: torch.Generator, device) -> torch.Tensor:
    """The ``judge_channels`` channels the judge compares, sorted."""
    judged = torch.randperm(cell.channels, generator=gen, device=device)
    return judged[:cell.traffic["judge_channels"]].sort().values


def split_calls(cell, pcm: torch.Tensor) -> list:
    """(C, period) PCM -> one contiguous (C, F, frame_size) tensor a call."""
    fsz = cell.modem["frame_size"]
    pcm = pcm.reshape(cell.channels, -1, cell.frames, fsz).transpose(0, 1)
    return [p.contiguous() for p in pcm]


def make(cell, seed: int, device) -> dict:
    gen, hz, out = start(cell, seed, device)
    dibits = torch.randint(0, 4, (cell.channels, period_symbols(cell)),
                           generator=gen, device=device, dtype=torch.uint8)
    pcm = stimulus.channel_pcm(gen, cell.modem, dibits, hz,
                               cell.config["snr_db"])
    del dibits
    out["judged"] = draw_judged(cell, gen, device)
    out["calls"] = split_calls(cell, pcm)
    return out


class System:
    """The program's ``rx_stream`` over the cell's channels."""

    def __init__(self, cell, device, stim: dict, spans: bool = False):
        from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream
        self.cell, self.device, self.spans = cell, device, spans
        self.cfg = ModemConfig(**cell.modem)
        self._rx_init, self._rx_stream = rx_init, rx_stream
        self.warm_freq = stim["warm_freq"]

    def init(self) -> dict:
        return {"rx": self._rx_init(self.cfg, (self.cell.channels,),
                                    acq_freq=self.warm_freq.clone(),
                                    device=self.device)}

    def call(self, state: dict, x) -> tuple:
        """One timed call: (new state, outputs)."""
        with span("rx_stream", self.spans):
            rx, out = self._rx_stream(self.cfg, state["rx"], x)
        return {**state, "rx": rx}, {"rx": out}

    def view(self, state: dict, out: dict | None = None) -> dict:
        """The judge's view of a state (and of a call's outputs): the
        loop's phase and frequency, the delay line, the filter tail and the
        carrier phasor as complex; the symbols as their (re, im) planes,
        which the judge reads on its channels only; the bits and the
        frequency trace as they are."""
        st = state["rx"]

        def cplx(x):
            return torch.complex(x.re, x.im).to(torch.complex128)
        v = {"phase": st.costas.phase, "freq": st.costas.freq,
             "decim_delay": cplx(st.decim_delay),
             "fir_tail": cplx(st.fir_tail), "nco": cplx(st.nco_phase)}
        if out is not None:
            rx = out["rx"]
            v.update(symbols=tuple(rx.symbols), bits=rx.bits,
                     freq_hz=rx.freq_hz)
        return v


def modem_input(stim: dict, i: int):
    """Call ``i``'s PCM (None before the stream)."""
    calls = stim["calls"]
    return None if i < 0 else calls[i % len(calls)]


def numbers(cell, stim: dict, rec, device, last: bool) -> dict:
    return judge.rx_numbers(cell, stim, rec, device,
                            lambda i: modem_input(stim, i))


class Control:
    """``System``'s interface over the reference, its matched filter's
    samples and taps rounded to float16 and summed in float32: one float16
    tensor-core pass where the program's kernel makes three to keep
    float32.  It receives the ``judged`` channels, the ones the judge
    reads; the others' outputs stay zero."""

    FIR_DTYPE = torch.float16

    def __init__(self, cell, device, stim: dict):
        self.cell, self.device = cell, device
        self.warm_freq, self.judged = stim["warm_freq"], stim["judged"]

    def init(self) -> dict:
        return {"phase": torch.zeros(self.judged.numel(), dtype=torch.float64,
                                     device=self.device),
                "freq": self.warm_freq[self.judged].to(torch.float64),
                "i": 0, "prev": None}

    def _full(self, t: torch.Tensor) -> torch.Tensor:
        f = t.new_zeros((self.cell.channels,) + tuple(t.shape[1:]))
        f[self.judged] = t
        return f

    def call(self, state: dict, x) -> tuple:
        cell, modem = self.cell, self.cell.modem
        n0 = state["i"] * cell.frames * modem["frame_size"]
        x = x[self.judged]
        r = ref_rx.receive(modem, x, state["prev"], state["phase"],
                           state["freq"], n0, fir_dtype=self.FIR_DTYPE)
        out = {"symbols": self._full(r["symbols"]),
               "bits": self._full(r["bits"]),
               "freq_hz": self._full(r["freq_hz"])}
        new = {**state, "phase": r["phase"], "freq": r["freq"],
               "i": state["i"] + 1, "prev": x,
               "decim_delay": self._full(r["decim_delay"]),
               "raw_tail": self._full(r["raw_tail"]),
               "n_end": n0 + cell.frames * modem["frame_size"]}
        return new, out

    def view(self, state: dict, out: dict | None = None) -> dict:
        full = torch.zeros(self.cell.channels, dtype=torch.float64,
                           device=self.device)
        v = {"phase": full.index_put((self.judged,), state["phase"]),
             "freq": full.index_put((self.judged,), state["freq"])}
        if out is None:
            return v
        v.update(out)
        v["decim_delay"] = state["decim_delay"]
        v["fir_tail"], nco = ref_rx.carried(self.cell.modem,
                                            state["raw_tail"],
                                            state["n_end"])
        v["nco"] = torch.full((self.cell.channels,), nco,
                              dtype=torch.complex128, device=self.device)
        return v
