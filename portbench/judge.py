"""How ``correct`` is decided: the calls the timed path made, compared with
``portbench.reference`` at the timed sizes, once the window has closed.

Two calls are compared in every run, on the channels the stimulus drew
from the seed for it (``judged``): the first call of the stream, from the
program's initial state, which the reference follows from its own start;
and the window's last call.  Where the reference's loop detector meets a
tie (a derotated component within ``TIE_LOOP`` of the RMS from zero), it
takes the program's sign: either is right to rounding, and the cold start's
filling filter makes such symbols.  For the last call the reference takes one
thing from the program, the loop's phase and frequency before it (the loop
is the only state that is not a function of the last samples of input),
and checks the program's loop state after it; the front-end's carried
tail, phasor and delay line, the picks and everything downstream it works
out again from the input.

Each cell's generator (``portbench.generators``) gives the numbers of its
kind of cell; ``rx_numbers`` gives those of the receive chain that every
kind shares.  Each number has its limit in the configuration file
(``limits``); the value passes when it is at most the limit:

* ``symbols_gap``: the widest gap of a derotated symbol, over the RMS of
  the reference's symbols;
* ``state_gap``: the widest gap of the carried state and the frequency
  trace: the loop phase (rad), the loop frequency and the trace (rad a
  symbol, times the symbols of a frame), the delay line and the filter
  tail (over their RMS), the carrier phasor;
* ``bits_wrong``: sliced bits that differ where the reference's symbol
  component lies farther from zero than the ``symbols_gap`` limit allows
  a symbol to move (nearer, a sound program may slice it either way, and
  the symbol gap judges it).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench.reference import rx as ref_rx

TAU = 2.0 * math.pi
TIE_LOOP = 1e-4     # of the RMS: a loop detector's tie (reference.rx.costas)
BLOCK_SAMPLES = 1 << 25   # call samples the reference takes at a time


@dataclasses.dataclass
class Compared:
    """One call to judge: its index in the stream, the program's view of
    the state before it (None for the first call) and after it, and of
    what it produced (``System.view``)."""
    index: int
    before: dict | None
    after: dict


def _wrap(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x + math.pi, TAU) - math.pi


def _rows(x, rows) -> torch.Tensor:
    """``rows`` of complex ``x``, or of its (re, im) planes, complex128."""
    if isinstance(x, tuple):
        return torch.complex(x[0][rows], x[1][rows]).to(torch.complex128)
    return x[rows].to(torch.complex128)


def _max(a: torch.Tensor) -> float:
    return float(a.max()) if a.numel() else 0.0


def _state_gap(p: dict, r: dict, modem: dict, sl, rms: float,
               n_end: int) -> float:
    nsym = modem["frame_size"] // int(modem["fs"] // modem["rs"])
    tail_r, nco = ref_rx.carried(modem, r["raw_tail"], n_end)
    tail_rms = float(tail_r.abs().pow(2).mean().sqrt()) or 1.0
    per_sym = TAU / modem["rs"]
    return max(
        _max(_wrap(p["phase"][sl] - r["phase"]).abs()),
        _max((p["freq"][sl] - r["freq"]).abs()) * nsym,
        _max((p["freq_hz"][sl] - r["freq_hz"]).abs()) * per_sym * nsym,
        _max((p["decim_delay"][sl] - r["decim_delay"]).abs()) / rms,
        _max((p["fir_tail"][sl] - tail_r).abs()) / tail_rms,
        _max((p["nco"][sl] - nco).abs()))


def rx_numbers(cell, stim: dict, rec: Compared, device, pcm_of,
               per_block=None) -> dict:
    """``symbols_gap``, ``state_gap`` and ``bits_wrong`` of one call, whose
    modem input ``pcm_of(i)`` gives for call ``i`` (None before the
    stream); the reference runs ``BLOCK_SAMPLES`` call samples at a time.
    ``per_block(channels, reference symbols, their RMS)`` adds numbers of
    a block, each taken at its worst over the blocks."""
    modem = cell.modem
    fsz = modem["frame_size"]
    i = rec.index
    n0 = i * cell.frames * fsz
    pcm, prev = pcm_of(i), pcm_of(i - 1)
    p = rec.after
    if rec.before is None:
        phase = torch.zeros(cell.channels, dtype=torch.float64,
                            device=device)
        freq = stim["warm_freq"].to(torch.float64)
    else:
        phase, freq = rec.before["phase"], rec.before["freq"]
    out = {"symbols_gap": 0.0, "state_gap": 0.0, "bits_wrong": 0}
    step = max(1, BLOCK_SAMPLES // (cell.frames * fsz))
    judged = stim["judged"]
    for start in range(0, judged.numel(), step):
        sl = judged[start:start + step]
        sym_p = _rows(p["symbols"], sl)
        tie = TIE_LOOP * float(sym_p.abs().pow(2).mean().sqrt())
        r = ref_rx.receive(modem, pcm[sl], None if prev is None else prev[sl],
                           phase[sl], freq[sl], n0, guide=sym_p, tie=tie)
        sym_r = r["symbols"]
        rms = float(sym_r.abs().pow(2).mean().sqrt()) or 1.0
        out["symbols_gap"] = max(out["symbols_gap"],
                                 _max((sym_p - sym_r).abs()) / rms)
        comp = torch.stack([sym_r.imag, sym_r.real], dim=-1).reshape(
            r["bits"].shape)
        tie = cell.limits()["symbols_gap"] * rms
        wrong = (p["bits"][sl] != r["bits"]) & (comp.abs() > tie)
        out["bits_wrong"] += int(wrong.sum())
        out["state_gap"] = max(out["state_gap"], _state_gap(
            p, r, modem, sl, rms, n0 + cell.frames * fsz))
        if per_block is not None:
            for k, v in per_block(sl, sym_r, rms).items():
                out[k] = max(out.get(k, v), v)
    return out


def judge(cell, stim: dict, records: list, device) -> tuple:
    """(each number's worst over ``records``, {name: (value, limit)} of the
    judged ones, the count of records with a number over its limit, each
    record's own numbers)."""
    limits = cell.limits()
    worst, failed, each = {}, 0, []
    for k, rec in enumerate(records):
        got = cell.gen.numbers(cell, stim, rec, device,
                               k == len(records) - 1)
        each.append(got)
        failed += any(v > limits[n] for n, v in got.items() if n in limits)
        for n, v in got.items():
            worst[n] = max(worst.get(n, v), v)
    checks = {n: (v, limits[n]) for n, v in worst.items() if n in limits}
    return worst, checks, failed, each
