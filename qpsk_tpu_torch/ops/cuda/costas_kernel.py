"""Costas-loop kernel wrapper (port of the time-major entry of
``qpsk_tpu/ops/pallas/costas_kernel.py``, ``costas_run_pallas_tm`` with
``emit_bits`` / ``emit_label`` and ``trace_every``, in its QPSK, gear,
gains and decision-directed (``dd``) modes, and of its channel-major entry
``costas_run_pallas_traced``).

``costas_run_tm`` consumes the (T, C) planes the front-end emits, any
T >= 1.  On a CUDA tensor it launches ``csrc/costas.cu`` once, which also
slices the derotated symbols and writes the (C, bps*T) bits the wrapper
returns (QPSK dibits; the dd mode's Gray labels, MSB first).  On a CPU
tensor it runs ``costas_run_tm_plain``: the gain-scaled
symbols through ``costas_run_traced`` (with ``modfam.dd_detector`` in dd
mode) or ``costas_run_gear_traced``, then ``demod_bits`` (dd mode:
``modfam.demod_bits_cmp``) and the frame-boundary frequency readback.
What a launch works out from its geometry alone (the checks, the loop's
host constants, the by-value arguments) is done once a geometry, in its
launch plan (``_Plan``, ``_lib.plan``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from qpsk_tpu_torch.ops import modfam
from qpsk_tpu_torch.ops.costas import (CostasGear, CostasParams, CostasState,
                                       costas_run_gear_traced,
                                       costas_run_traced)
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.cuda import _lib
from qpsk_tpu_torch.ops.modmap import demod_bits

# the kernel's detector kinds (csrc/costas.cu, enum Detector)
_DETECTOR = {"bpsk": 1, "8psk": 2, "16qam": 3}


def costas_run_tm(state: CostasState, zr_tm: torch.Tensor,
                  zi_tm: torch.Tensor, params: CostasParams,
                  trace_every: int, gear: CostasGear | None = None,
                  gains: torch.Tensor | None = None, dd=None,
                  impl: str = "auto"):
    """Run the loop over (T, C) symbol planes.

    ``gear`` (with a state from ``costas_init(..., gear=True)``) runs the
    gear-shift loop; ``gains``, a (F, C) float32 plane with ``T % F == 0``,
    scales each symbol by its frame's gain before the loop; ``dd``, a
    (modulation name, constellation scale) pair of the generic family,
    runs the decision-directed detector of ``modfam.dd_err_ops`` (not with
    ``gear``).  Returns ``(new_state, derot CF32 (T, C), freq_frames (C, T
    // trace_every), bits (C, bps*T) int32)``: ``freq_frames[:, k]`` is the
    loop frequency after symbol ``(k+1)*trace_every - 1`` and ``bits`` is
    ``modmap.demod_bits`` (dd: ``modfam.demod_bits_cmp``) of the derotated
    (C, T) symbols.  ``impl`` is ``ModemConfig.costas_impl``: "auto" (the
    tensor's device picks), "scan" (the plain version on any device) or
    "pallas" (the kernel; a CPU tensor raises).
    """
    if gear is not None and dd is not None:
        raise ValueError("the gear shift is QPSK-only: pass gear or dd")
    if _lib.use_kernel(impl, zr_tm, "costas_impl"):
        return _launch(state, zr_tm, zi_tm, params, trace_every, gear, gains,
                       dd)
    return costas_run_tm_plain(state, zr_tm, zi_tm, params, trace_every,
                               gear, gains, dd)


def costas_run_tm_plain(state, zr_tm, zi_tm, params, trace_every, gear=None,
                        gains=None, dd=None):
    """The plain PyTorch version of ``costas_run_tm``."""
    if gains is not None:
        g = gains.repeat_interleave(zr_tm.shape[0] // gains.shape[0], dim=0)
        zr_tm, zi_tm = zr_tm * g, zi_tm * g
    symbols = CF32(zr_tm.T, zi_tm.T)
    if gear is not None:
        new_state, derot, trace = costas_run_gear_traced(state, symbols,
                                                         params, gear)
    elif dd is not None:
        mod = modfam.get(dd[0])
        new_state, derot, trace = costas_run_traced(
            state, symbols, params, detector=modfam.dd_detector(mod, dd[1]))
    else:
        new_state, derot, trace = costas_run_traced(state, symbols, params)
    bits = (demod_bits(derot) if dd is None
            else modfam.demod_bits_cmp(derot, modfam.get(dd[0]), dd[1]))
    return (new_state, CF32(derot.re.T.contiguous(), derot.im.T.contiguous()),
            trace[:, trace_every - 1::trace_every], bits)


def costas_run_cm(state: CostasState, symbols: CF32, params: CostasParams,
                  trace_every: int, gear: CostasGear | None = None, dd=None,
                  impl: str = "auto"):
    """The channel-major entry: (C, T) symbols, transposed to (T, C) for
    ``costas_run_tm`` with ``impl``.  Returns ``(new_state, derot CF32
    (C, T), freq_frames, bits (C, bps*T))``."""
    new_state, derot, trace, bits = costas_run_tm(
        state, symbols.re.T.contiguous(), symbols.im.T.contiguous(), params,
        trace_every, gear=gear, dd=dd, impl=impl)
    return new_state, CF32(derot.re.T, derot.im.T), trace, bits


def unpack_bits_tm(packed: torch.Tensor) -> torch.Tensor:
    """(T/16, C) int32 words -> (C, 2T) bits (a CPU helper: the kernel
    writes the bits itself, in this order), the layout of
    ``modmap.demod_bits`` on the (C, T) derotated symbols: symbol ``t`` sits
    at bits ``2*(t%16)`` (b1, the low bit) and ``2*(t%16)+1`` (b0) of word
    ``t // 16``.  The shifts are arithmetic, so every shift is masked."""
    w = packed[:, None, :]                                  # (T/16, 1, C)
    j = torch.arange(16, dtype=torch.int32, device=packed.device)[None, :, None]
    bits = torch.stack([(w >> (2 * j)) & 1, (w >> (2 * j + 1)) & 1], dim=2)
    return bits.reshape(-1, packed.shape[1]).T              # (C, 2T)


def unpack_labels_tm(packed: torch.Tensor) -> torch.Tensor:
    """(T/8, C) int32 words -> (C, T) int32 labels (a CPU helper, as
    ``unpack_bits_tm``), the layout of
    ``modfam.slice_labels_cmp`` on the (C, T) derotated symbols: symbol
    ``t`` sits at bits ``4*(t%8)`` of word ``t // 8``.  A label of 8 or
    more in the top slot sets the sign bit, and the shifts are arithmetic,
    so every shift is masked."""
    w = packed[:, None, :]                                  # (T/8, 1, C)
    j = torch.arange(8, dtype=torch.int32, device=packed.device)[None, :, None]
    return ((w >> (4 * j)) & 15).reshape(-1, packed.shape[1]).T


class _Plan:
    """A Costas launch's work that follows from its geometry (T, C,
    trace_every, the gain rows, the loop's constants and mode, the device)
    alone, done once (``_lib.plan``): the geometry's checks, the by-value
    arguments (``args``, the C entry's from ``T`` to ``dd``), the shapes of
    the tensors it reads by pointer and of its outputs.  ``nf`` is the gain
    rows, None without gains."""

    def __init__(self, t: int, c: int, trace_every: int, nf, params,
                 gear, dd, device):
        if t < 1 or c < 1 or trace_every < 1 or t % trace_every:
            raise ValueError(
                f"the Costas kernel takes T > 0 with T % trace_every == 0, "
                f"got T={t}, C={c}, trace_every={trace_every}")
        if nf is not None and (nf < 1 or t % nf):
            raise ValueError(f"gains of {nf} rows do not divide T={t} "
                             f"into frames")
        mod = None if dd is None else modfam.get(dd[0])
        self.device, self.nf = device, nf
        self.z_shape, self.gains_shape = (t, c), (nf, c)
        self.fields = ("phase", "freq") + (("lev", "locked") if gear
                                           else ())
        self.trace_shape = (t // trace_every, c)
        self.bits_shape = (c, (2 if mod is None else mod.bps) * t)
        loop, consts = _constants(params, gear, dd)
        self.args = (t, c, trace_every, 0 if nf is None else t // nf,
                     0 if mod is None else _DETECTOR[mod.name],
                     loop.ctypes.data, consts.ctypes.data)

    def check(self, state, zr_tm=None, zi_tm=None, gains=None) -> list:
        """Raise ValueError unless the inputs given are the tensors the
        kernel reads by pointer; return the state's pointers in the C
        entry's order, ``phase0`` to ``locked0``."""
        dev, c = self.device, self.z_shape[1]
        for name, t, shape in (("zr_tm", zr_tm, self.z_shape),
                               ("zi_tm", zi_tm, self.z_shape),
                               ("gains", gains, self.gains_shape)):
            if t is not None:
                _lib.require(t, name, torch.float32, shape, dev)
        ptrs = []
        for name in self.fields:
            t = getattr(state, name)
            _lib.require(t, f"state.{name}", torch.float32, (c,), dev)
            ptrs.append(t.data_ptr())
        return ptrs + [None] * (4 - len(ptrs))


def _plan(t: int, c: int, trace_every: int, nf, params, gear, dd,
          device) -> _Plan:
    return _lib.plan(("costas", t, c, trace_every, nf, params, gear, dd,
                      device),
                     lambda: _Plan(t, c, trace_every, nf, params, gear, dd,
                                   device))


def _launch(state, zr_tm, zi_tm, params, trace_every, gear, gains, dd):
    t, c = zr_tm.shape
    dev = zr_tm.device
    plan = _plan(t, c, trace_every, None if gains is None else gains.shape[0],
                 params, gear, dd, dev)
    state_in = plan.check(state, zr_tm, zi_tm, gains)
    derot = CF32(torch.empty((t, c), device=dev),
                 torch.empty((t, c), device=dev))
    ftrace = torch.empty(plan.trace_shape, device=dev)
    new = [torch.empty((c,), device=dev) for _ in plan.fields]
    bits = torch.empty(plan.bits_shape, dtype=torch.int32, device=dev)
    _lib.launch("qpsk_costas_tm", zr_tm.data_ptr(), zi_tm.data_ptr(),
                *state_in, _lib.ptr(gains), derot.re.data_ptr(),
                derot.im.data_ptr(), ftrace.data_ptr(),
                *(x.data_ptr() for x in new), *[None] * (4 - len(new)),
                bits.data_ptr(), *plan.args, _lib.stream_ptr(dev))
    return CostasState(*new), derot, ftrace.T, bits


@functools.lru_cache(maxsize=None)
def _constants(params, gear, dd) -> tuple:
    """The kernel's host arrays: 9 loop constants (alpha, beta, min_freq,
    max_freq, then the gear's five or zeros) and the 49 detector
    constants, read by the kernel as ``modfam.dd_err_ops`` reads them
    (16QAM's 3*16 + 1; zeros for QPSK)."""
    vals = [params.alpha, params.beta, params.min_freq, params.max_freq]
    vals += [gear.alpha_trk, gear.beta_trk, gear.gamma, gear.enter,
             gear.exit] if gear else [0.0] * 5
    dd_consts = np.zeros(49, np.float32)
    if dd is not None:
        k = modfam.dd_constants(modfam.get(dd[0]), dd[1])
        dd_consts[:k.size] = k
    return np.asarray(vals, np.float32), dd_consts
