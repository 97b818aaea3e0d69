"""Roofline accounting on one NVIDIA H100 (port of
``qpsk_tpu.utils.roofline``, repriced for the port's kernels).

A bound here is the least time the card could take for a function's
work: the larger of the bytes it must move (each input read once, each
output written once) over the memory rate and its operations over the
peak rate of their type.  It is named ``"bytes"`` or ``"operations"`` by
which of the two is larger.  The peaks are the H100 SXM's published ones
(dense, at the 700 W limit): 3.35 TB/s, 67 TFLOP/s float32 on the CUDA
cores and 989 TFLOP/s float16 on the tensor cores.  The front-end and TX
kernels run their FIRs on the tensor cores in three float16 passes
(hi*hi, hi*lo, lo*hi) with float32 sums, so their FIR operations are
priced three times at the float16 peak; the same FIR as float32 FMAs on
the CUDA cores is given beside as their float32-FMA floor.

``*_work`` give (least ms, what bounds it[, float32-FMA floor ms]) of one
kernel call at the shapes of the card's measurements (``chip_smoke.py``);
``frontend_cost`` / ``*_report`` are the JAX module's records on the same
prices, attached by ``benchmarks.py`` to its rates on the card.
"""

from __future__ import annotations

import dataclasses
import math

# the H100 SXM's published peaks: memory bytes/s, float32 (non-tensor)
# FLOP/s and dense float16 tensor-core FLOP/s
PEAK_BYTES_S, PEAK_FLOP_S, PEAK_F16_S = 3.35e12, 67e12, 989e12
# its top SM clock (nvidia-smi's clocks.max.sm on the H100 80GB HBM3), in
# which the Costas step is expressed
SM_CLOCK_HZ = 1.98e9


def bound(nbytes: float, flops: float) -> tuple:
    """(least ms, what bounds it): the larger of ``nbytes`` moved at the
    card's memory rate and ``flops`` float32 operations at its peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fir_bound(nbytes: float, fir: float, rest: float) -> tuple:
    """(least ms, what bounds it, the float32-FMA floor ms) of a function
    moving ``nbytes`` whose FIR's ``fir`` float operations could run on the
    tensor cores in three float16 passes (hi*hi, hi*lo, lo*hi) at the
    float16 peak, beside ``rest`` float32 operations on the CUDA cores;
    the floor is the same FIR as float32 FMAs on the CUDA cores."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = (3 * fir / PEAK_F16_S + rest / PEAK_FLOP_S) * 1e3
    fma = max(t_bytes, (fir + rest) / PEAK_FLOP_S * 1e3)
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")) \
        + (fma,)


def _frontend_terms(c, nframes, cycles, tm: bool, power: bool) -> tuple:
    """(bytes, FIR operations, other float32 operations) of the front-end
    kernel's fast instance on (c, nframes, 512) PCM; see
    ``frontend_work``."""
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
    """The front-end's bound on the route the kernel takes, (least ms, what
    bounds it, the float32-FMA floor ms): int16 PCM, the carried tail and
    phasor in, the picks, the index and the new tail and phasor out (and
    the carried delay in and out, the powers out); the FIR, 127 complex
    taps on a real input (254 multiply-adds a sample), on the tensor cores
    in three float16 passes (hi*hi, hi*lo, lo*hi) at the float16 peak,
    beside the float32 work of the CUDA cores (the gain, the phase energy
    at every sample, a phasor per pick).  The third value is the same FIR
    as float32 FMAs on the CUDA cores, the floor of the route the kernel
    left."""
    return fir_bound(*_frontend_terms(c, nframes, cycles, tm, power))


# the dd detectors' comparisons, selects and products beyond QPSK's
_DD_OPS = {None: 0, "bpsk": 2, "8psk": 8, "16qam": 12}
_BPS = {None: 2, "bpsk": 1, "8psk": 3, "16qam": 4}


def _costas_terms(c, t, trace_every, gear=False, gains=False, dd=None):
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
    """The Costas loop's bound: (T, C) planes in, derotated planes, the
    (C, bps*T) int32 bits the wrapper returns, the frame-rate trace and
    the state out; about 22 float operations a symbol (derotation,
    detector, loop update, wrap and clamp, cos and sin counted once each),
    8 more for the gear, 2 for a gain, 2 / 8 / 12 more for the BPSK /
    8PSK / 16QAM detector.  The serial chain's floor (cycles a step x T /
    clock) is given by ``costas_report``, not counted here."""
    return bound(*_costas_terms(c, t, trace_every, gear, gains, dd))


def tx_work(c, s, cycles) -> tuple:
    """TX's bound on the route the kernel takes, (least ms, what bounds
    it, the float32-FMA floor ms): symbols, the carried tail's 126 //
    cycles symbol lanes (all the function reads of it) and the phasor in,
    int16 PCM, the whole new zero-stuffed tail and the phasor out; per
    sample two planes of 127 / cycles polyphase multiply-adds, on the
    tensor cores in three float16 passes at the float16 peak, beside the
    carrier mix's float32 work on the CUDA cores (two complex products and
    the real part, 8 operations).  The third value is the same FIR as
    float32 FMAs on the CUDA cores, the floor of the route the kernel
    left."""
    n = s * cycles
    nbytes = c * (s * 8 + n * 2 + (126 // cycles) * 8 + 126 * 8 + 2 * 8)
    return fir_bound(nbytes, c * n * 2 * 2 * -(-127 // cycles), c * n * 8)


def _viterbi_terms(nsteps: int, states: int, batch: int) -> tuple:
    """(bytes, operations) of ``batch`` rate-1/2 Viterbi decodes of
    ``nsteps`` trellis steps: LLRs in, the info bits (the steps less the
    tail) out as int32, 4 operations a state (2 adds, compare, select)
    and 4 more a step."""
    nbits = nsteps - int(round(math.log2(states)))
    return (batch * (2 * nsteps + nbits) * 4,
            batch * nsteps * (states * 4 + 4))


def _ldpc_edges(code) -> int:
    import torch
    from qpsk_tpu_torch.ops.cuda import ldpc_kernel as lk
    return int((lk._tables(code, torch.device("cpu"))[0] >= 0).sum())


def _ldpc_terms(code, batch: int) -> tuple:
    """(bytes, operations) of ``batch`` LDPC decodes: LLRs in, bits out,
    about 8 operations per edge and iteration."""
    return (batch * (code.n + code.k) * 4,
            batch * code.iters * _ldpc_edges(code) * 8)


def fec_work(name: str, b: int) -> tuple:
    """A decoder's bound at ``b`` packets of the coded link (30-byte
    packets: K=7 rate-1/2 Viterbi over 262 steps, ``LdpcCode(k=256)``):
    LLRs in, bits out; Viterbi 64 states x (2 adds, compare, select) a
    step, LDPC about 8 operations per edge and iteration."""
    if name == "viterbi":
        return bound(*_viterbi_terms(262, 64, b))
    from qpsk_tpu_torch.packet import LdpcCode
    return bound(*_ldpc_terms(LdpcCode(k=256), b))


def _general_frontend_terms(kind: str, cfg, c, nframes) -> tuple:
    """(bytes, FIR operations, other float32 operations) of the front-end
    kernel's general instance (``kind`` "tm", "tm_power" or "cm") on
    (c, nframes, frame_size) PCM; see ``general_work``."""
    fsz, nsym, h = cfg.frame_size, cfg.symbols_per_frame, cfg.ntaps - 1
    n, t = nframes * fsz, nframes * nsym
    nbytes = c * (n * 2 + 2 * (h * 4 + 4) * 2 + 2 * t * 4 + nframes * 4)
    fir, rest = c * n * 4 * cfg.ntaps, c * n * 3 + c * t * 6
    if kind != "cm":
        nbytes += 2 * 2 * c * nsym * 4
    if kind == "tm_power":
        nbytes += c * nframes * 4
        rest += c * t * 3
    return nbytes, fir, rest


def general_work(kind: str, cfg=None, c=0, nframes=0, s=0, code=None,
                 b=0, nbits=0) -> tuple:
    """The bound of a general instance on its inputs, (least ms, what
    bounds it), and for the front-end and TX the float32-FMA floor ms: the
    front-end (``kind`` "tm", "tm_power" or "cm") moves the PCM, the
    carried tail and phase in and the picks, index, new tail and phase (the
    delay in and out, the powers) out, and does 2 x ntaps multiply-adds a
    sample for the FIR plus 3 operations a sample and the energy and a
    phasor a pick; TX moves the symbols and the tail's symbol lanes in,
    PCM and the new tail out, 2 x ceil(ntaps/cycles) multiply-adds and 8
    carrier operations a sample.  Both FIRs as ``fir_bound`` prices them
    (on the tensor cores, as the fast instances run them).  Viterbi moves
    the LLRs in and the bits out, 2 x rate_den + 8 operations a state and
    step; LDPC as ``fec_work`` on its code's edges; both float32."""
    if kind in ("tm", "tm_power", "cm"):
        return fir_bound(*_general_frontend_terms(kind, cfg, c, nframes))
    if kind == "tx":
        n, h = s * cfg.cycles, cfg.ntaps - 1
        nbytes = c * (s * 8 + n * 2 + (h // cfg.cycles) * 8 + h * 8 + 2 * 8)
        return fir_bound(nbytes, c * n * 4 * -(-cfg.ntaps // cfg.cycles),
                         c * n * 8)
    if kind == "viterbi":
        nsteps = nbits + code.constraint - 1
        return bound(b * (code.rate_den * nsteps + nbits) * 4,
                     b * nsteps * code.nstates * (2 * code.rate_den + 8))
    return bound(*_ldpc_terms(code, b))


# --- the JAX module's records, on the H100's prices -----------------------

@dataclasses.dataclass(frozen=True)
class FrontendCost:
    bytes: float               # memory traffic, bytes
    flops: float               # FIR operations issued (dense tiles)
    useful_flops: float        # 4 x ntaps a sample: the filter itself
    ideal_bytes_s: float       # traffic / peak bandwidth
    ideal_ops_s: float         # operations / their peak
    bound: str                 # "bytes" or "operations"

    @property
    def ideal_s(self) -> float:
        return max(self.ideal_bytes_s, self.ideal_ops_s)


def _staged_block(cfg) -> int:
    from qpsk_tpu_torch.ops.rrc import pick_block
    return pick_block(cfg.frame_size)


def frontend_cost(cfg, channels: int, nframes: int,
                  impl: str = "pallas") -> FrontendCost:
    """The cost of one front-end pass over (channels, nframes, frame_size)
    int16 PCM.  ``impl="pallas"``: the channel-major kernel
    (``frontend_kernel.rx_frontend``), priced as ``frontend_work`` (the
    fast instance's frames of 512 samples) or ``general_work``; its FIR
    issues three float16 passes at the tensor-core peak.  ``impl="xla"``:
    the staged plain chain (``frontend_kernel.frontend_xla``), int16 in
    (2 B a sample), the float32 raw plane written and re-read by the FIR
    (8 B), the filtered planes written (8 B), re-read by the energy
    reduction (8 B) and by the decimation (8 B), the picks written; its
    FIR a float32 Toeplitz product of (block + ntaps - 1) rows a sample
    and plane on the CUDA cores (TF32 off)."""
    c, n = channels, channels * nframes * cfg.frame_size
    useful = 4.0 * cfg.ntaps * n
    picks = 8.0 / cfg.cycles
    if impl == "pallas":
        nbytes, fir, rest = (
            _frontend_terms(c, nframes, cfg.cycles, False, False)
            if (cfg.frame_size, cfg.ntaps) == (512, 127)
            else _general_frontend_terms("cm", cfg, c, nframes))
        flops = 3.0 * fir
        t_ops = 3.0 * fir / PEAK_F16_S + rest / PEAK_FLOP_S
    elif impl == "xla":
        nbytes = (2.0 + 8.0 + 8.0 + 8.0 + 8.0 + picks) * n
        flops = 2.0 * 2.0 * (_staged_block(cfg) + cfg.ntaps - 1) * n
        t_ops = flops / PEAK_FLOP_S
    else:
        raise ValueError(f"unknown impl {impl!r}")
    t_bytes = nbytes / PEAK_BYTES_S
    return FrontendCost(bytes=float(nbytes), flops=float(flops),
                        useful_flops=useful, ideal_bytes_s=t_bytes,
                        ideal_ops_s=t_ops,
                        bound="bytes" if t_bytes >= t_ops else "operations")


def frontend_report(cfg, channels: int, nframes: int, measured_s: float,
                    impl: str) -> dict:
    """Measured-against-roofline record of one front-end lowering: the
    JAX record's keys, ``bound`` named by bytes or operations;
    ``mfu_dense`` is the issued FIR operations' share of their peak (the
    float16 tensor-core peak for the kernel, float32 for the staged
    chain), ``mfu_useful`` the filter's own operations' share."""
    c = frontend_cost(cfg, channels, nframes, impl)
    peak = PEAK_F16_S if impl == "pallas" else PEAK_FLOP_S
    return {
        "impl": impl,
        "channels": channels,
        "samples": channels * nframes * cfg.frame_size,
        "measured_s": round(measured_s, 9),
        "ideal_s": round(c.ideal_s, 9),
        "bound": c.bound,
        "roofline_fraction": round(c.ideal_s / measured_s, 3),
        "hbm_gbps": round(c.bytes / measured_s / 1e9, 1),
        "mfu_dense": round(c.flops / measured_s / peak, 3),
        "mfu_useful": round(c.useful_flops / measured_s / peak, 4),
    }


@dataclasses.dataclass(frozen=True)
class ComposedRxCost:
    """The itemized traffic of the time-major RX chain: the front-end
    kernel -> the Costas kernel, which writes the bits itself."""
    fe_bytes: float            # int16 read, picks, index, state
    costas_bytes: float        # picks read, derotated planes, bits, trace
    consumer_bytes: float      # the bits read once by their consumer
    ideal_bytes_s: float
    ideal_ops_s: float

    @property
    def total_bytes(self) -> float:
        return self.fe_bytes + self.costas_bytes + self.consumer_bytes

    @property
    def ideal_s(self) -> float:
        return max(self.ideal_bytes_s, self.ideal_ops_s)


def composed_rx_cost(cfg, channels: int, nframes: int,
                     packed_bytes_per_symbol: float | None = None
                     ) -> ComposedRxCost:
    """The traffic and operations of one ``rx_stream`` call over
    (channels, nframes, frame_size) int16 PCM on the time-major chain:
    the front-end as ``frontend_work`` (tm) prices it, the Costas kernel
    as ``costas_work``.  The bits are int32, one a bit, so
    ``packed_bytes_per_symbol`` defaults to 4 x bits per symbol (the JAX
    kernels pack them); their consumer reads them once."""
    bps = cfg.bits_per_symbol
    if packed_bytes_per_symbol is None:
        packed_bytes_per_symbol = 4.0 * bps
    nsym, c = cfg.symbols_per_frame, channels
    t = nframes * nsym
    fe, fir, rest = _frontend_terms(c, nframes, cfg.cycles, True, cfg.agc)
    dd = None if cfg.modulation == "qpsk" else cfg.modulation
    costas, cflops = _costas_terms(c, t, nsym, cfg.loop_bw_track > 0,
                                   cfg.agc, dd)
    consumer = packed_bytes_per_symbol * c * t
    return ComposedRxCost(
        fe_bytes=fe, costas_bytes=costas, consumer_bytes=consumer,
        ideal_bytes_s=(fe + costas + consumer) / PEAK_BYTES_S,
        ideal_ops_s=3 * fir / PEAK_F16_S + (rest + cflops) / PEAK_FLOP_S)


def composed_rx_report(cfg, channels: int, nframes: int,
                       measured_s: float,
                       packed_bytes_per_symbol: float | None = None) -> dict:
    """Measured-against-roofline record of the composed RX call: the
    traffic a pass, the achieved memory rate and its share of the peak,
    ``bound`` by bytes or operations of the call's least time, and the
    two kernels' bytes.  The Costas chain's serial latency, which
    ``costas_report`` prices, is what sets the measured time."""
    c = composed_rx_cost(cfg, channels, nframes, packed_bytes_per_symbol)
    return {
        "hbm_bytes_per_pass": round(c.total_bytes, 0),
        "hbm_gbps": round(c.total_bytes / measured_s / 1e9, 1),
        "hbm_roofline_fraction": round(c.ideal_bytes_s / measured_s, 3),
        "ideal_s": round(c.ideal_s, 9),
        "bound": "bytes" if c.ideal_bytes_s >= c.ideal_ops_s
        else "operations",
        "fe_bytes": round(c.fe_bytes, 0),
        "costas_bytes": round(c.costas_bytes, 0),
    }


def costas_report(channels: int, nsym: int, measured_pass_s: float,
                  step_ns_by_channels: dict | None = None) -> dict:
    """Measured-against-floor record of the Costas kernel: one pass is
    ``nsym`` dependent steps whatever the channel count (each symbol's
    derotation reads the phase the previous step updated), so its floor is
    the step's latency, in ns and in cycles at the card's top SM clock.
    ``step_ns_by_channels``, measured ns a step by channel count, shows
    the step time flat in the width when the chain is what bounds it."""
    ns = measured_pass_s / nsym * 1e9
    rec = {
        "serial_steps_per_pass": int(nsym),
        "ns_per_step": round(ns, 1),
        "cycles_per_step": round(ns * 1e-9 * SM_CLOCK_HZ, 0),
        "symbols_per_step": int(channels),
        "bound": "serial-step-issue",
    }
    if step_ns_by_channels:
        rec["step_ns_by_channels"] = {
            str(c): round(v, 1) for c, v in step_ns_by_channels.items()}
        vals = list(step_ns_by_channels.values())
        rec["step_time_flatness"] = round(min(vals) / max(vals), 3)
    return rec


def ldpc_report(code, batch: int, measured_s: float) -> dict:
    """Measured-against-roofline record of the LDPC kernel on ``batch``
    packets: LLRs in, bits out, about 8 float32 operations per edge and
    iteration (``_ldpc_terms``); the operations' and the bytes' shares of
    their peaks, and which bounds the least time."""
    from qpsk_tpu_torch.packet.ldpc import _edges

    _, _, dmax = _edges(code.k, code.dv, code.seed)
    nbytes, flops = _ldpc_terms(code, batch)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S
    return {
        "flops_per_decode": round(flops / batch, 0),
        "mfu": round(t_ops / measured_s, 3),
        "hbm_fraction": round(t_bytes / measured_s, 4),
        "bound": "bytes" if t_bytes >= t_ops else "operations",
        "dmax": int(dmax),
    }


def viterbi_report(nbits: int, states: int, batch: int,
                   measured_s: float) -> dict:
    """Measured-against-roofline record of the Viterbi kernel: ``batch``
    decodes of ``nbits`` trellis steps (the info bits plus the tail) over
    ``states`` states, rate 1/2: LLRs in, info bits out (int32), 64 x
    (2 adds, compare, select) a step; the path metrics and decisions stay
    on chip."""
    nbytes, flops = _viterbi_terms(nbits, states, batch)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S
    return {
        "hbm_bytes_per_decode": round(nbytes / batch, 0),
        "hbm_fraction": round(t_bytes / measured_s, 4),
        "ops_fraction": round(t_ops / measured_s, 4),
        "bound": "bytes" if t_bytes >= t_ops else "operations",
        "trellis_steps": int(nbits), "states": int(states),
    }
