"""The yardstick's roofline arithmetic: a frozen copy of
``qpsk_tpu_torch/utils/roofline.py`` at commit 7bb37cf (``bound``,
``fir_bound``, ``_frontend_terms``, ``frontend_work``, ``_costas_terms``,
``costas_work``, ``_viterbi_terms`` and ``fec_work``'s Viterbi branch),
kept here so that a later change to the program's copy cannot move the
benchmark's bounds.  ``portbench/tests`` checks that the two still agree
at the cells' shapes.

A bound is the least time one NVIDIA H100 SXM could take for a function's
work: the larger of the bytes it must move (each input read once, each
output written once) at 3.35 TB/s and its operations at their peak: float32
at 67 TFLOP/s on the CUDA cores, and an FIR's multiply-adds as three
float16 tensor-core passes (hi*hi, hi*lo, lo*hi) at 989 TFLOP/s.
"""

from __future__ import annotations

import math

PEAK_BYTES_S, PEAK_FLOP_S, PEAK_F16_S = 3.35e12, 67e12, 989e12


def bound(nbytes: float, flops: float) -> tuple:
    """(least ms, what bounds it) of ``nbytes`` moved and ``flops`` float32
    operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fir_bound(nbytes: float, fir: float, rest: float) -> tuple:
    """(least ms, what bounds it, the float32-FMA floor ms) of a function
    moving ``nbytes`` whose FIR's ``fir`` operations run as three float16
    passes at the tensor cores' peak beside ``rest`` float32 operations."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = (3 * fir / PEAK_F16_S + rest / PEAK_FLOP_S) * 1e3
    fma = max(t_bytes, (fir + rest) / PEAK_FLOP_S * 1e3)
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")) \
        + (fma,)


def _frontend_terms(c, nframes, cycles, tm: bool, power: bool) -> tuple:
    """(bytes, FIR operations, other float32 operations) of the front-end
    on (c, nframes, 512) int16 PCM: the PCM, the carried tail and phasor
    in, the picks, index, new tail and phasor out (time-major: the delay
    line in and out; with ``power`` the frame powers out); 127 complex taps
    on a real input, 254 multiply-adds a sample."""
    n, nsym = nframes * 512, 512 // cycles
    t = nframes * nsym
    nbytes = c * (n * 2 + 2 * (126 * 4 + 4) * 2) + c * (2 * t * 4 + nframes * 4)
    fir, rest = c * n * 254 * 2, c * n * (2 + 3) + c * t * 6
    if tm:
        nbytes += 2 * 2 * c * nsym * 4
    if power:
        nbytes += c * nframes * 4
        rest += c * t * 3
    return nbytes, fir, rest


def frontend_work(c, nframes, cycles, tm: bool, power: bool) -> tuple:
    return fir_bound(*_frontend_terms(c, nframes, cycles, tm, power))


_DD_OPS = {None: 0, "bpsk": 2, "8psk": 8, "16qam": 12}
_BPS = {None: 2, "bpsk": 1, "8psk": 3, "16qam": 4}


def _costas_terms(c, t, trace_every, gear=False, gains=False, dd=None):
    """(bytes, operations) of the Costas loop: (T, C) planes in, derotated
    planes, the int32 bits, the frame-rate trace and the state out; about
    22 float operations a symbol."""
    nstate = 4 if gear else 2
    nbytes = c * t * (8 + 8 + 4 * _BPS[dd]) + c * (t // trace_every) * 4 \
        + 2 * c * nstate * 4
    flops = c * t * (22 + (8 if gear else 0) + (2 if gains else 0)
                     + _DD_OPS[dd])
    if gains:
        nbytes += c * (t // trace_every) * 4
    return nbytes, flops


def costas_work(c, t, trace_every, gear: bool = False,
                gains: bool = False, dd: str | None = None) -> tuple:
    return bound(*_costas_terms(c, t, trace_every, gear, gains, dd))


def _viterbi_terms(nsteps: int, states: int, batch: int) -> tuple:
    """(bytes, operations) of ``batch`` rate-1/2 Viterbi decodes of
    ``nsteps`` trellis steps: LLRs in, info bits out as int32, 4
    operations a state (2 adds, compare, select) and 4 more a step."""
    nbits = nsteps - int(round(math.log2(states)))
    return (batch * (2 * nsteps + nbits) * 4,
            batch * nsteps * (states * 4 + 4))


def viterbi_work(b: int) -> tuple:
    """The K=7 rate-1/2 Viterbi's bound at ``b`` packets of the coded link
    (30-byte packets: 262 trellis steps)."""
    return bound(*_viterbi_terms(262, 64, b))
