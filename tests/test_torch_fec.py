"""The torch port's FEC layer against the JAX package (CPU): the
convolutional code and its Viterbi decoder (``ops/cuda/viterbi_kernel.py``,
its plain version on CPU), the LDPC code and its min-sum decoder
(``ops/cuda/ldpc_kernel.py``, its plain version on CPU).

Tolerances: the code tables, encoders and syndromes are integer work and
must be equal.  The plain Viterbi must decode bit for bit what the JAX scan
and the Pallas kernel (interpret mode) decode, hard-LLR ties included: its
op order is the scan's.  The plain LDPC must agree with both JAX lowerings
on >= 99.9 % of bits with equal frame errors, the JAX package's own bound
between its lowerings (their float32 message sums run in other orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpsk_tpu.ops.pallas.ldpc_kernel import ldpc_decode_pallas
from qpsk_tpu.ops.pallas.viterbi_kernel import viterbi_decode_pallas
from qpsk_tpu.packet import fec as jfec
from qpsk_tpu.packet import ldpc as jldpc
from qpsk_tpu_torch.ops.cuda import _lib, ldpc_kernel, viterbi_kernel
from qpsk_tpu_torch.packet import fec, ldpc

torch.set_num_threads(2)

CODE, JCODE = fec.ConvCode(), jfec.ConvCode()


def _conv_llrs(rng, nbits, batch, sigma):
    """(payload bits, LLRs) of noisy codewords; with ``sigma=None`` hard
    +-1 LLRs with 3 % of the coded bits flipped (ties everywhere)."""
    u = rng.integers(0, 2, batch + (nbits,), dtype=np.int32)
    c = np.asarray(jfec.conv_encode(JCODE, u))
    if sigma is None:
        flips = (rng.random(c.shape) < 0.03).astype(np.int32)
        return u, (1 - 2 * ((c + flips) % 2)).astype(np.float32)
    return u, ((1.0 - 2.0 * c) + rng.normal(0, sigma, c.shape)).astype(np.float32)


def _ldpc_llrs(rng, k, batch, sigma):
    code = jldpc.LdpcCode(k=k)
    u = rng.integers(0, 2, batch + (k,), dtype=np.int32)
    c = np.asarray(jldpc.ldpc_encode(code, u))
    return u, ((1.0 - 2.0 * c) + rng.normal(0, sigma, c.shape)).astype(np.float32)


def test_trellis_matches_jax():
    preds, sgns = fec._trellis(CODE)
    jpreds, jsgns = jfec._trellis(JCODE)
    np.testing.assert_array_equal(preds, jpreds)
    np.testing.assert_array_equal(sgns, jsgns)
    assert CODE.coded_bits(256) == JCODE.coded_bits(256) == 524


@pytest.mark.parametrize("k", [64, 128, 256])
def test_ldpc_tables_match_jax(k):
    a, h = ldpc._matrices(k, 3, 1)
    ja, jh = jldpc._matrices(k, 3, 1)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(h, jh)
    scat, valid, dmax = ldpc._edges(k, 3, 1)
    jscat, jvalid, jdmax = jldpc._edges(k, 3, 1)
    np.testing.assert_array_equal(scat, jscat)
    np.testing.assert_array_equal(valid, jvalid)
    assert dmax == jdmax
    # the compact tables hold exactly the one-hot edge matrix's edges
    check_var, var_edges = ldpc._index_tables(k, 3, 1)
    assert check_var.shape == (dmax, k)
    rows, cols = np.nonzero(jscat)
    np.testing.assert_array_equal(check_var.reshape(-1)[rows], cols)
    assert (check_var >= 0).sum() == rows.size
    for v in range(2 * k):
        edges = var_edges[v][var_edges[v] >= 0]
        np.testing.assert_array_equal(edges, np.flatnonzero(jscat[:, v]))
    if k == 256:
        # the slice's code: k = m = 256, n = 512, check degree <= 5,
        # variable degrees 1/2/3
        assert dmax == 5
        assert sorted(set((h.sum(axis=0)).tolist())) == [1, 2, 3]


def test_conv_encode_matches_jax():
    rng = np.random.default_rng(0)
    for shape in ((5, 120), (2, 3, 256), (77,)):
        u = rng.integers(0, 2, shape, dtype=np.int32)
        got = fec.conv_encode(CODE, torch.from_numpy(u))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jfec.conv_encode(JCODE, u)))
    np.testing.assert_array_equal(
        fec.hard_llrs(torch.tensor([0, 1, 1])).numpy(),
        np.asarray(jfec.hard_llrs(jnp.asarray([0, 1, 1]))))


@pytest.mark.parametrize("k", [64, 256])
def test_ldpc_encode_and_syndrome_match_jax(k):
    rng = np.random.default_rng(k)
    code, jcode = ldpc.LdpcCode(k=k), jldpc.LdpcCode(k=k)
    u = rng.integers(0, 2, (3, 4, k), dtype=np.int32)
    cw = ldpc.ldpc_encode(code, torch.from_numpy(u))
    jcw = np.asarray(jldpc.ldpc_encode(jcode, u))
    np.testing.assert_array_equal(cw.numpy(), jcw)
    noisy = jcw ^ (rng.random(jcw.shape) < 0.05)
    np.testing.assert_array_equal(
        ldpc.ldpc_syndrome_weight(code, torch.from_numpy(noisy)).numpy(),
        np.asarray(jldpc.ldpc_syndrome_weight(jcode, noisy)))
    assert int(ldpc.ldpc_syndrome_weight(code, cw).max()) == 0


# (nbits, batch, sigma or None for hard LLRs with flips)
_VITERBI_CASES = [(256, (48,), 0.7), (238, (5,), 0.7), (100, (3, 7), 0.7),
                  (256, (32,), None), (77, (9,), 0.4), (77, (9,), None),
                  (256, (1,), 0.7), (256, (), 0.7)]


@pytest.mark.parametrize("nbits,batch,sigma", _VITERBI_CASES,
                         ids=[f"{n}x{b}-{'hard' if s is None else s}"
                              for n, b, s in _VITERBI_CASES])
def test_viterbi_plain_matches_jax(nbits, batch, sigma):
    rng = np.random.default_rng(nbits + len(batch))
    u, llrs = _conv_llrs(rng, nbits, batch, sigma)
    got = viterbi_kernel.viterbi_decode_plain(CODE, torch.from_numpy(llrs),
                                              nbits)
    assert got.shape == batch + (nbits,) and got.dtype == torch.int32
    scan = np.asarray(jfec.viterbi_decode(JCODE, jnp.asarray(llrs), nbits,
                                          impl="scan"))
    np.testing.assert_array_equal(got.numpy(), scan)
    pallas = np.asarray(viterbi_decode_pallas(JCODE, jnp.asarray(llrs), nbits,
                                              interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)
    if sigma is not None and sigma <= 0.55:
        np.testing.assert_array_equal(got.numpy(), u)


def test_viterbi_decodes_through_noise_and_cpu_dispatch():
    """sigma 0.55 (about 5 dB Eb/N0) decodes clean; a CPU tensor runs the
    plain version and never counts a launch."""
    rng = np.random.default_rng(2)
    u, llrs = _conv_llrs(rng, 256, (64,), 0.55)
    before = dict(_lib.launches)
    got = fec.viterbi_decode(CODE, torch.from_numpy(llrs), 256)
    assert _lib.launches == before
    np.testing.assert_array_equal(got.numpy(), u)
    with pytest.raises(ValueError):
        fec.viterbi_decode(CODE, torch.from_numpy(llrs[:, :-2]), 256)


# (k, batch, sigma, iters)
_LDPC_CASES = [(256, (48,), 0.7, None), (128, (3, 7), 0.7, None),
               (64, (5,), 0.7, None), (128, (9,), 0.5, 8), (256, (1,), 0.8, None)]


@pytest.mark.parametrize("k,batch,sigma,iters", _LDPC_CASES,
                         ids=[f"k{k}x{b}-{s}-it{i}" for k, b, s, i in _LDPC_CASES])
def test_ldpc_plain_matches_jax(k, batch, sigma, iters):
    rng = np.random.default_rng(k + len(batch))
    u, llrs = _ldpc_llrs(rng, k, batch, sigma)
    code, jcode = ldpc.LdpcCode(k=k), jldpc.LdpcCode(k=k)
    got = ldpc_kernel.ldpc_decode_plain(code, torch.from_numpy(llrs), iters)
    assert got.shape == batch + (k,) and got.dtype == torch.int32
    got = got.numpy()
    for ref in (jldpc.ldpc_decode(jcode, jnp.asarray(llrs), iters=iters,
                                  impl="xla"),
                ldpc_decode_pallas(jcode, jnp.asarray(llrs), iters=iters,
                                   interpret=True)):
        ref = np.asarray(ref)
        assert (got == ref).mean() >= 0.999, (got == ref).mean()
        # equal frame errors against the payload sent
        assert (got != u).any(-1).sum() == (ref != u).any(-1).sum()


def test_ldpc_decodes_through_noise_and_cpu_dispatch():
    """sigma 0.6 (about 4.4 dB) decodes clean; a CPU tensor runs the plain
    version and never counts a launch."""
    rng = np.random.default_rng(2)
    u, llrs = _ldpc_llrs(rng, 256, (64,), 0.6)
    code = ldpc.LdpcCode(k=256)
    before = dict(_lib.launches)
    got = ldpc.ldpc_decode(code, torch.from_numpy(llrs))
    assert _lib.launches == before
    np.testing.assert_array_equal(got.numpy(), u)
    with pytest.raises(ValueError):
        ldpc.ldpc_decode(code, torch.from_numpy(llrs), iters=0)
