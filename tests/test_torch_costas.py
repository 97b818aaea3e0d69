"""The torch port's Costas loop (``ops/cuda/costas_kernel.py``, its plain
version on CPU) against the JAX package: ``costas_run_traced`` and the
Pallas tm kernel with ``emit_bits`` and ``trace_every`` in interpret mode.

Bits must be equal; derotated symbols and the loop frequency agree to 1e-4
(the frameworks' cos/sin may differ in the last ulp, so only decisions are
held equal across lowerings)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpsk_tpu import ModemConfig as JCfg, rx_init as j_rx_init
from qpsk_tpu.modem import frontend_xla as j_frontend_xla
from qpsk_tpu.ops import costas as jcostas
from qpsk_tpu.ops.cplx import CF32 as JCF32
from qpsk_tpu.ops.modmap import demod_bits as j_demod_bits
from qpsk_tpu.ops.pallas.costas_kernel import (costas_run_pallas_tm,
                                               unpack_bits_tm as j_unpack)
from qpsk_tpu_torch.ops import costas as tcostas
from qpsk_tpu_torch.ops.cuda.costas_kernel import costas_run_tm, unpack_bits_tm

torch.set_num_threads(2)

C, T, NSF = 128, 512, 128
BW = 2.0 * math.pi / 100.0


def _symbols(stimulus):
    """(T, C) float32 planes: Gaussian noise, or the matched-filter picks of
    a +50 Hz QPSK signal (the loop then pulls in and locks)."""
    rng = np.random.default_rng(7)
    if stimulus == "noise":
        return (rng.normal(size=(T, C)).astype(np.float32),
                rng.normal(size=(T, C)).astype(np.float32))
    cfg = JCfg()
    n = (T // NSF) * cfg.frame_size
    t = np.arange(n + 1024)
    sym = rng.integers(0, 4, (C, (n + 1024) // 4))
    phase = np.repeat(np.exp(1j * np.pi / 2 * sym), 4, axis=1)
    carrier = np.exp(1j * 2 * np.pi * (1500.0 + 50.0) / 9600.0 * t)
    pcm = (np.real(phase * carrier) * 8000.0
           + rng.normal(size=(C, t.size)) * 2000.0).astype(np.int16)
    pcm = pcm[:, 1024:1024 + n].reshape(C, T // NSF, cfg.frame_size)
    st = j_rx_init(cfg, batch_shape=(C,))
    picks, _, _, _ = j_frontend_xla(cfg, pcm, st.nco_phase, st.fir_tail)
    return (np.asarray(picks.re).reshape(C, T).T.copy(),
            np.asarray(picks.im).reshape(C, T).T.copy())


@pytest.mark.parametrize("stimulus", ["noise", "signal"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_costas_matches_jax(stimulus, warm):
    zr, zi = _symbols(stimulus)
    rng = np.random.default_rng(8)
    phase0 = (rng.uniform(-3, 3, C) if warm else np.zeros(C)).astype(np.float32)
    freq0 = (rng.uniform(-0.05, 0.05, C) if warm else np.zeros(C)).astype(np.float32)

    tp = tcostas.costas_params(BW)
    tst = tcostas.CostasState(torch.from_numpy(phase0), torch.from_numpy(freq0))
    st, derot, ftrace, bits = costas_run_tm(tst, torch.from_numpy(zr),
                                            torch.from_numpy(zi), tp,
                                            trace_every=NSF)
    assert derot.re.shape == (T, C) and ftrace.shape == (C, T // NSF)
    assert bits.shape == (C, 2 * T) and bits.dtype == torch.int32

    jp = jcostas.costas_params(BW)
    assert (tp.alpha, tp.beta) == (float(jp.alpha), float(jp.beta))
    jst = jcostas.CostasState(jnp.asarray(phase0), jnp.asarray(freq0))
    js, jd, jtr = jcostas.costas_run_traced(jst, JCF32(zr.T, zi.T), jp)
    ks, kd, kft, kbits = costas_run_pallas_tm(
        jst, jnp.asarray(zr), jnp.asarray(zi), jp, trace_every=NSF,
        emit_bits=True, interpret=True)

    np.testing.assert_array_equal(bits.numpy(), np.asarray(kbits))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(j_demod_bits(jd)))
    for ref_d, ref_f, ref_s in (
            ((np.asarray(jd.re).T, np.asarray(jd.im).T),
             np.asarray(jtr)[:, NSF - 1::NSF], js),
            ((np.asarray(kd.re), np.asarray(kd.im)), np.asarray(kft), ks)):
        np.testing.assert_allclose(derot.re.numpy(), ref_d[0], atol=1e-4)
        np.testing.assert_allclose(derot.im.numpy(), ref_d[1], atol=1e-4)
        np.testing.assert_allclose(ftrace.numpy(), ref_f, atol=1e-4)
        np.testing.assert_allclose(st.freq.numpy(), np.asarray(ref_s.freq), atol=1e-4)
        np.testing.assert_allclose(st.phase.numpy(), np.asarray(ref_s.phase), atol=1e-4)


def test_unpack_bits_tm_layout():
    """The kernel's packed words unpack in the JAX package's layout."""
    rng = np.random.default_rng(9)
    words = rng.integers(-2**31, 2**31, (T // 16, 5), dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(
        unpack_bits_tm(torch.from_numpy(words)).numpy(),
        np.asarray(j_unpack(jnp.asarray(words), T, 5)))


# ---------------------------------------------- the kernel's bit writer ---


def _brev(v, width):
    """__brev(v) >> (32 - width): the low ``width`` bits reversed."""
    out = np.zeros_like(v)
    for i in range(width):
        out |= ((v >> i) & 1) << (width - 1 - i)
    return out


def _kernel_bits(vals, bps):
    """csrc/costas.cu's ``BitWriter`` on (C, T) per-symbol values ``v`` (a
    symbol's bits in output order, the first in bit 0), the (C, BPS*T)
    output starting on a 16-byte boundary: each lane keeps the pending
    bits of the 16-byte chunk its row has reached (``q``, its first
    element, negative for a row that starts ``a`` elements into a chunk)
    and stores a chunk whole, as one aligned 16-byte store, once it holds
    4 bits from q >= 0; the row's first chunk (q = -a), kept in ``head``,
    and its last, cut one, after the last symbol, element by element where
    the element lies in the row.  Every element of the output is written
    exactly once."""
    c, t = vals.shape
    nbits = bps * t
    flat = np.full(c * nbits, -1, np.int64)

    def store(row0, q0, bits, m):
        for j in range(m):
            if 0 <= q0 + j < nbits:
                assert flat[row0 + q0 + j] == -1, "an element written twice"
                flat[row0 + q0 + j] = (bits >> j) & 1

    for ch in range(c):
        row0 = ch * nbits
        a = row0 % 4
        q, npend, pend, head = -a, a, 0, 0
        for s in range(t):
            pend |= int(vals[ch, s]) << npend
            npend += bps
            if npend >= 4:
                if q >= 0:
                    # one 16-byte store, aligned and inside the row
                    assert (row0 + q) % 4 == 0 and q + 4 <= nbits
                    store(row0, q, pend, 4)
                else:
                    head = pend
                pend >>= 4
                npend -= 4
                q += 4
        if a > 0 and q > -a:
            store(row0, -a, head, 4)
        store(row0, q, pend, npend)
    return flat.reshape(c, nbits)


@pytest.mark.parametrize("t", [16, 1024, 1, 17, 100])
def test_kernel_qpsk_bits_match_unpack_bits_tm(t):
    """QPSK: v = (Im < 0) | (Re < 0) << 1 through the writer equals
    ``demod_bits``, and for T % 16 == 0 ``unpack_bits_tm`` of the words
    the earlier kernel packed (16 dibits a word)."""
    rng = np.random.default_rng(t)
    c = 37
    re, im = rng.normal(size=(2, c, t)).astype(np.float32)
    v = (im < 0).astype(np.int64) | ((re < 0).astype(np.int64) << 1)
    got = _kernel_bits(v, 2)
    want = j_demod_bits(JCF32(jnp.asarray(re), jnp.asarray(im)))
    np.testing.assert_array_equal(got, np.asarray(want))
    if t % 16 == 0:
        words = np.zeros((t // 16, c), np.int64)
        for s in range(t):
            words[s // 16] |= v[:, s] << (2 * (s % 16))
        packed = torch.from_numpy(words.astype(np.uint32).view(np.int32))
        np.testing.assert_array_equal(got, unpack_bits_tm(packed).numpy())


@pytest.mark.parametrize("name", ["bpsk", "8psk", "16qam"])
@pytest.mark.parametrize("t", [1024, 8, 33, 91])
def test_kernel_label_bits_match_labels_to_bits(name, t):
    """dd: v = the label's bits reversed (MSB first) through the writer
    equals ``modfam.labels_to_bits`` of the labels."""
    from qpsk_tpu_torch.ops import modfam
    mod = modfam.get(name)
    rng = np.random.default_rng(t + mod.bps)
    labels = rng.integers(0, 1 << mod.bps, (45, t), dtype=np.int64)
    got = _kernel_bits(_brev(labels, mod.bps), mod.bps)
    want = modfam.labels_to_bits(torch.from_numpy(labels), mod)
    np.testing.assert_array_equal(got, want.numpy())
