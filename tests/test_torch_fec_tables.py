"""The tables and the arithmetic of the torch port's two FEC decoder kernels
(``csrc/ldpc.cu``, ``csrc/viterbi.cu``), checked on the CPU.

A CUDA kernel runs only on the card, so what can be held here is what it is
built from: the per-slot edge table the LDPC kernel keeps in registers
(against ``_index_tables``) and its map of checks to threads past 1024
checks, the lane and register map of the Viterbi kernel's trellis and the
sign masks it takes for any K=7 rate-1/2 code (against ``fec._trellis``),
and numpy twins of the two kernels' schedules, operation for operation in
float32, against the plain PyTorch versions.

Tolerances: none.  The tables are integers.  The LDPC twin forms each
message as ``(llr[v] + ((e[ed0] + e[ed1]) + e[ed2])) - e[s]`` and picks
magnitudes without an argmin; both are the plain version's float32
operations in the same order, so messages and bits must be equal.  The
Viterbi twin computes a butterfly's four candidates from one branch value
and reads decisions off the sign of a difference; every operation rounds
as the plain version's, so the bits must be equal, hard-LLR ties included.

The general instances (codes the fast kernels do not take): the plain
decoders against the JAX package at those codes (Viterbi bit-equal to
the scan; LDPC >= 99.9 % and equal frame errors, the JAX package's own
bound between its lowerings), and numpy twins of the general Viterbi
instances (the branch-pattern table, each step's branch values built as
the kernel builds them, the maximum subtracted as the metrics are read,
decisions packed 32 states a word, traceback through the words) and of
the LDPC instances at the code's exact degrees, which must decode bit for
bit as the plain versions; the pattern table against ``fec._trellis``,
the Viterbi layout at every K and the LDPC instance over the coverage
grid.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpsk_tpu.packet import fec as jfec, ldpc as jldpc
from qpsk_tpu_torch.ops.cuda import ldpc_kernel, viterbi_kernel
from qpsk_tpu_torch.packet import fec, ldpc
from test_torch_kernel_coverage import _GATE_EDGE_K

torch.set_num_threads(2)

F32 = np.float32
POLYS = (0o133, 0o171)


# --------------------------------------------------------------- LDPC ---

@pytest.mark.parametrize("k", [64, 128, 256, 1032])
def test_slot_edge_table_lists_each_slots_variable_edges(k):
    check_var, var_edges = ldpc._index_tables(k, 3, 1)
    table = ldpc._slot_edge_table(k, 3, 1)
    dmax, m = check_var.shape
    assert table.shape == (dmax, var_edges.shape[1], m)
    assert table.dtype == np.int32 and table.flags.c_contiguous
    for s in range(dmax):
        for i in range(m):
            v = check_var[s, i]
            want = var_edges[v] if v >= 0 else np.full(var_edges.shape[1], -1)
            np.testing.assert_array_equal(table[s, :, i], want)
    # every real slot finds itself in its variable's list, once
    own = np.arange(dmax)[:, None, None] * m + np.arange(m)[None, None, :]
    hits = (table == own).sum(axis=1)
    np.testing.assert_array_equal(hits, (check_var >= 0).astype(int))
    assert table.max() < dmax * m < 2 ** 14     # offsets of 16 bits, in bytes


def _plain_next_messages(code, llrs, e):
    """``gather(totals(e)) - e`` with the plain version's torch operations
    (``ldpc_kernel.ldpc_decode_plain``)."""
    check_var, var_edges = ldpc_kernel._tables(code, torch.device("cpu"))
    dmax, m = check_var.shape
    batch = tuple(llrs.shape[:-1])
    valid = check_var >= 0
    gidx = check_var.clamp(min=0).reshape(-1).to(torch.int64)
    eidx = torch.where(var_edges >= 0, var_edges, dmax * m).to(torch.int64)
    zero = torch.zeros(batch + (1,), dtype=torch.float32)
    flat = torch.cat([e.reshape(batch + (dmax * m,)), zero], dim=-1)
    g = flat[..., eidx]
    s = g[..., 0]
    for j in range(1, g.shape[-1]):
        s = s + g[..., j]
    total = llrs + s
    gathered = torch.where(valid, total[..., gidx].reshape(batch + (dmax, m)),
                           0.0)
    return gathered - e, valid.numpy()


def _slot_next_messages(k, llrs, e):
    """The kernel's form: per slot, the channel LLR of its variable plus
    the messages on the variable's edge list in order (padding reads a
    zero), minus the own message; float32 numpy."""
    check_var, _ = ldpc._index_tables(k, 3, 1)
    table = ldpc._slot_edge_table(k, 3, 1)
    dmax, m = check_var.shape
    flat = np.concatenate([e.reshape(e.shape[:-2] + (dmax * m,)),
                           np.zeros(e.shape[:-2] + (1,), F32)], axis=-1)
    idx = np.where(table >= 0, table, dmax * m)
    sums = flat[..., idx[:, 0]] + flat[..., idx[:, 1]]
    sums = sums + flat[..., idx[:, 2]]
    return (llrs[..., check_var.clip(min=0)] + sums) - e


@pytest.mark.parametrize("k", [64, 128, 256])
def test_slot_messages_equal_plain_gather_of_totals(k):
    rng = np.random.default_rng(k)
    code = ldpc.LdpcCode(k=k)
    check_var, _ = ldpc._index_tables(k, 3, 1)
    llrs = rng.normal(0, 2, (7, 2 * k)).astype(F32)
    e = (rng.normal(0, 1.5, (7,) + check_var.shape)
         * (check_var >= 0)).astype(F32)
    want, valid = _plain_next_messages(code, torch.from_numpy(llrs),
                                       torch.from_numpy(e))
    got = _slot_next_messages(k, llrs, e)
    assert got.dtype == F32
    np.testing.assert_array_equal(got[:, valid], want.numpy()[:, valid])


def _ldpc_kernel_twin(code, llrs, iters=None):
    """The schedule of ``csrc/ldpc.cu`` in float32 numpy: LLRs through
    ``x + 0.0``, slots past a check's degree carrying 1e30, the running
    minimum and second minimum without an argmin, signs from sign bits,
    one message array an iteration, the posterior of the k message bits."""
    its = code.iters if iters is None else iters
    check_var, var_edges = ldpc._index_tables(code.k, code.dv, code.seed)
    dmax, m = check_var.shape
    real = check_var >= 0
    big, alpha = F32(1e30), F32(code.alpha)
    llrs = llrs.astype(F32) + F32(0.0)
    lv = np.where(real, llrs[..., check_var.clip(min=0)], big).astype(F32)
    mm = lv.copy()
    post = np.where(var_edges[:code.k] >= 0, var_edges[:code.k], dmax * m)
    for it in range(its):
        m1 = np.full(mm.shape[:-2] + (m,), big)
        m2 = m1.copy()
        for s in range(dmax):
            a = np.abs(mm[..., s, :])
            m2 = np.minimum(m2, np.maximum(m1, a))
            m1 = np.minimum(m1, a)
        parity = np.bitwise_xor.reduce(mm.view(np.uint32), axis=-2)
        mag = np.where(np.abs(mm) > m1[..., None, :], (alpha * m1)[..., None, :],
                       (alpha * m2)[..., None, :]).astype(F32)
        sign = (parity[..., None, :] ^ mm.view(np.uint32)) & np.uint32(1 << 31)
        e = (mag.view(np.uint32) | sign).view(F32)
        e_stored = np.where(real, e, F32(0.0))
        if it == its - 1:
            break
        mm = _slot_next_messages(code.k, llrs, e_stored)
        mm = np.where(real, mm, (lv + F32(0.0)) - e).astype(F32)
    flat = np.concatenate([e_stored.reshape(e.shape[:-2] + (dmax * m,)),
                           np.zeros(e.shape[:-2] + (1,), F32)], axis=-1)
    sums = flat[..., post[:, 0]] + flat[..., post[:, 1]]
    sums = sums + flat[..., post[:, 2]]
    return ((llrs[..., :code.k] + sums) < 0).astype(np.int32)


# (k, batch, sigma, iters)
@pytest.mark.parametrize("k,batch,sigma,iters",
                         [(256, 24, 0.7, None), (128, 9, 0.8, None),
                          (64, 11, 0.7, 8), (256, 6, None, None),
                          (1032, 3, 0.7, None)])
def test_ldpc_kernel_schedule_equals_plain(k, batch, sigma, iters):
    """Noisy codewords (or, with ``sigma=None``, LLRs with exact zeros and
    negative zeros planted) decode to the same bits."""
    rng = np.random.default_rng(3 * k + batch)
    code = ldpc.LdpcCode(k=k)
    u = torch.from_numpy(rng.integers(0, 2, (batch, k), dtype=np.int32))
    c = ldpc.ldpc_encode(code, u).numpy()
    llrs = ((1.0 - 2.0 * c) + rng.normal(0, sigma or 0.7, c.shape)).astype(F32)
    if sigma is None:
        llrs[:, ::3] = 0.0
        llrs[:, 1::7] = -0.0
    want = ldpc_kernel.ldpc_decode_plain(code, torch.from_numpy(llrs), iters)
    got = _ldpc_kernel_twin(code, llrs, iters)
    np.testing.assert_array_equal(got, want.numpy())


def _checks_of_threads(m):
    """The launch's check map: one check a thread up to 1024 checks, two
    up to 2048, four beyond; thread ``tid`` of a block of ``T`` (a whole
    number of warps) owns checks tid + j*T, j < CPT, those below m."""
    cpt = 1 if m <= 1024 else 2 if m <= 2048 else 4
    threads = -(-(-(-m // cpt)) // 32) * 32
    checks = np.arange(threads)[:, None] + threads * np.arange(cpt)[None, :]
    return threads, np.where(checks < m, checks, -1)


@pytest.mark.parametrize("m", [256, 1024, 1032, 2048, 2056, 3276])
def test_ldpc_checks_a_thread_cover_every_check_once(m):
    """A block of at most 1024 threads owns every check and every message
    bit (k = m) exactly once, and the 16-bit byte offsets of the messages
    reach the zero slot at check degree 5, the degree of every dv=3 code
    (the tables of the codes past 1032 checks are not built here: their
    dense edge matrices take 170 to 430 MB)."""
    threads, checks = _checks_of_threads(m)
    assert threads <= 1024 and threads % 32 == 0
    owned = np.sort(checks[checks >= 0])
    np.testing.assert_array_equal(owned, np.arange(m))
    assert 4 * 5 * m < 2 ** 16
    if m <= 1032:
        assert ldpc._index_tables(m, 3, 1)[0].shape[0] == 5
        assert ldpc_kernel.coverage(ldpc.LdpcCode(k=m)) is None


def test_ldpc_kernel_tables_at_1032_checks():
    """``PacketConfig(payload_bytes=127, fec="ldpc")``: the per-slot
    tables the check threads of a two-checks-a-thread block load, each
    thread's slots gathered through its check map, equal the whole
    table's columns; the kernel twin decodes as the plain version."""
    k = 1032
    table = ldpc._slot_edge_table(k, 3, 1)
    check_var, _ = ldpc._index_tables(k, 3, 1)
    threads, checks = _checks_of_threads(k)
    assert checks.shape == (threads, 2) and threads == 544
    for j in range(2):
        own = checks[:, j]
        live = own >= 0
        np.testing.assert_array_equal(check_var[:, own[live]],
                                      check_var[:, live.nonzero()[0] + j * threads])
        np.testing.assert_array_equal(table[:, :, own[live]],
                                      table[:, :, live.nonzero()[0] + j * threads])
    rng = np.random.default_rng(1032)
    code = ldpc.LdpcCode(k=k)
    u = torch.from_numpy(rng.integers(0, 2, (2, k), dtype=np.int32))
    c = ldpc.ldpc_encode(code, u).numpy()
    llrs = ((1.0 - 2.0 * c) + rng.normal(0, 0.75, c.shape)).astype(F32)
    want = ldpc_kernel.ldpc_decode(code, torch.from_numpy(llrs))
    np.testing.assert_array_equal(_ldpc_kernel_twin(code, llrs), want.numpy())


def test_ldpc_kernel_refuses_what_it_does_not_take():
    """Variables of degree 9, past the general instance's 8 (and past any
    code the TPU kernel's gate admits at these sizes), raise before any
    launch; degree 4 runs on the general instance."""
    assert ldpc_kernel.coverage(ldpc.LdpcCode(k=64, dv=4)) is None
    code = ldpc.LdpcCode(k=64, dv=9)
    with pytest.raises(NotImplementedError, match="dv=9"):
        ldpc_kernel._launch(code, torch.zeros(2, 128), None)


# ------------------------------------------------------------ Viterbi ---

def _out_bit(poly, j0):
    """``out_bit`` of ``csrc/viterbi.cu``: the output of generator ``poly``
    on the branch from predecessor j0 into state 2*j0."""
    return bin(poly & (j0 << 1)).count("1") & 1


def _masks(polys):
    """``code_mask`` of csrc/viterbi.cu for each generator."""
    return tuple(sum(_out_bit(p, j0) << j0 for j0 in range(32)) for p in polys)


def test_butterfly_branch_values_match_trellis():
    """The four branch metrics of a butterfly are +-one value, 0.5(l0+l1)
    or 0.5(l0-l1) with the sign of the first generator's output; the
    wrapper's sign masks of the default code are the masks the kernel's
    compile-time instance is built for."""
    code = fec.ConvCode()
    assert viterbi_kernel.code_masks(code) == _masks(POLYS)
    preds, sgns = fec._trellis(code)
    l0, l1 = F32(0.8125), F32(-1.71875)
    for j0 in range(32):
        s0, s1 = _out_bit(POLYS[0], j0), _out_bit(POLYS[1], j0)
        h = F32(0.5) * (l0 + l1) if s0 == s1 else F32(0.5) * (l0 - l1)
        bt = -h if s0 else h
        for q, p, want in ((0, 0, bt), (0, 1, -bt), (1, 0, -bt), (1, 1, bt)):
            state = 2 * j0 + q
            assert preds[state, p] == p * 32 + j0
            bm = F32(0.5) * (sgns[0, state, p] * l0 + sgns[1, state, p] * l1)
            assert bm == want


@pytest.mark.parametrize("lanes", [2, 4, 8])
def test_lane_register_map_fetches_the_predecessors(lanes):
    """Lane g holds states [g*N, (g+1)*N); the two shuffle rounds of the
    kernel hand butterfly i of lane g the metrics of the predecessors of
    states g*N + 2i and g*N + 2i + 1."""
    preds, _ = fec._trellis(fec.ConvCode())
    n, h = 64 // lanes, 32 // lanes
    pm = np.arange(64, dtype=F32).reshape(lanes, n)     # pm[g][r] = state
    for g in range(lanes):
        odd, src_even, src_odd = g & 1, g >> 1, lanes // 2 + (g >> 1)
        for i in range(h):
            def sent(lane, rnd):
                upper = lane >= lanes // 2
                first = pm[lane][h + i] if upper else pm[lane][i]
                second = pm[lane][i] if upper else pm[lane][h + i]
                return first if rnd == 1 else second
            r1 = sent(src_odd if odd else src_even, 1)
            r2 = sent(src_even if odd else src_odd, 2)
            p0, p1 = (r2, r1) if odd else (r1, r2)
            for q in (0, 1):
                state = g * n + 2 * i + q
                assert (p0, p1) == tuple(preds[state])


def _viterbi_kernel_twin(llrs, nbits, lanes, masks=None):
    """``viterbi_kernel<G>`` of ``csrc/viterbi.cu`` in float32 numpy: lane
    g owns states [g*N, (g+1)*N), butterflies from one branch value read
    off the code's sign masks (default: the default code's), decisions
    from the sign of c0 - c1 packed into a 64-bit word a step (bit s =
    state s), the maximum subtracted after every step, and the traceback
    over the words from state 0."""
    m0, m1 = _masks(POLYS) if masks is None else masks
    batch, nsteps = llrs.shape[0], nbits + 6
    n, h = 64 // lanes, 32 // lanes
    pm = np.full((batch, 64), -1e9, F32)
    pm[:, 0] = 0.0
    words = np.zeros((nsteps, batch), np.uint64)
    for t in range(nsteps):
        l0, l1 = llrs[:, 2 * t], llrs[:, 2 * t + 1]
        ha, hb = F32(0.5) * (l0 + l1), F32(0.5) * (l0 - l1)
        new = np.empty_like(pm)
        for g in range(lanes):
            for i in range(h):
                j0 = g * h + i
                s0, s1 = m0 >> j0 & 1, m1 >> j0 & 1
                hval = ha if s0 == s1 else hb
                bt = -hval if s0 else hval
                p0, p1 = pm[:, j0], pm[:, 32 + j0]
                for q, (c0, c1) in enumerate(((p0 + bt, p1 - bt),
                                              (p0 - bt, p1 + bt))):
                    state = g * n + 2 * i + q
                    new[:, state] = np.maximum(c0, c1)
                    won = np.signbit(c0 - c1)
                    words[t] |= won.astype(np.uint64) << np.uint64(state)
        pm = new - new.max(axis=1, keepdims=True)
    s = np.zeros(batch, np.uint64)
    bits = np.zeros((batch, nsteps), np.int32)
    one = np.uint64(1)
    for t in range(nsteps - 1, -1, -1):
        bits[:, t] = (s & one).astype(np.int32)
        won = (words[t] >> s) & one
        s = (s >> one) | (won << np.uint64(5))
    return bits[:, :nbits]


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("hard", [False, True], ids=["noisy", "hard"])
def test_viterbi_kernel_schedule_equals_plain(lanes, hard):
    rng = np.random.default_rng(lanes + 10 * hard)
    code = fec.ConvCode()
    nbits = 96
    u = torch.from_numpy(rng.integers(0, 2, (13, nbits), dtype=np.int32))
    c = fec.conv_encode(code, u).numpy()
    if hard:     # +-1 LLRs with 3 % flips: ties at every step
        flips = (rng.random(c.shape) < 0.03).astype(np.int32)
        llrs = (1 - 2 * ((c + flips) % 2)).astype(F32)
    else:
        llrs = ((1.0 - 2.0 * c) + rng.normal(0, 0.7, c.shape)).astype(F32)
    want = viterbi_kernel.viterbi_decode_plain(code, torch.from_numpy(llrs),
                                               nbits)
    np.testing.assert_array_equal(_viterbi_kernel_twin(llrs, nbits, lanes),
                                  want.numpy())


def test_viterbi_shape_follows_the_batch_size():
    """The coded paths' batches: a channel's tracked extraction (156), the
    rate point (4096), the QPSK and 8PSK sync hunts (16 768, 67 072)."""
    picks = [viterbi_kernel._lanes(b) for b in (1, 156, 2048, 4096, 8192,
                                                16768, 67072)]
    assert picks == [32, 32, 32, 8, 8, 1, 1]


_OTHER_CODES = [(0o171, 0o133), (0o117, 0o155)]


@pytest.mark.parametrize("polys", _OTHER_CODES, ids=["171_133", "117_155"])
def test_sign_masks_rebuild_the_trellis(polys):
    """Another K=7 rate-1/2 code: the masks the wrapper hands the kernel
    expand, through the butterfly symmetry, into ``fec._trellis``'s whole
    (2, 64, 2) sign table."""
    code = fec.ConvCode(polys=polys)
    masks = viterbi_kernel.code_masks(code)
    assert masks == _masks(polys)
    _, sgns = fec._trellis(code)
    for k in range(2):
        s = np.array([1.0 - 2.0 * (masks[k] >> j0 & 1) for j0 in range(32)],
                     F32)
        want = np.empty((64, 2), F32)
        want[0::2, 0], want[0::2, 1] = s, -s
        want[1::2, 0], want[1::2, 1] = -s, s
        np.testing.assert_array_equal(sgns[k], want)


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("polys", _OTHER_CODES, ids=["171_133", "117_155"])
def test_viterbi_kernel_schedule_equals_plain_other_code(polys, lanes):
    rng = np.random.default_rng(lanes)
    code = fec.ConvCode(polys=polys)
    nbits = 64
    u = torch.from_numpy(rng.integers(0, 2, (9, nbits), dtype=np.int32))
    c = fec.conv_encode(code, u).numpy()
    llrs = ((1.0 - 2.0 * c) + rng.normal(0, 0.7, c.shape)).astype(F32)
    want = viterbi_kernel.viterbi_decode_plain(code, torch.from_numpy(llrs),
                                               nbits)
    got = _viterbi_kernel_twin(llrs, nbits, lanes,
                               viterbi_kernel.code_masks(code))
    np.testing.assert_array_equal(got, want.numpy())


def test_viterbi_kernel_refuses_other_generators():
    """A generator without the oldest tap breaks the butterfly symmetry
    the fast kernels run on: the general instance takes it (no sign
    masks); a constraint length past 15 raises before any launch."""
    code = fec.ConvCode(polys=(0o132, 0o171))
    assert viterbi_kernel.code_masks(code) is None
    assert viterbi_kernel.coverage(code) is None
    code = fec.ConvCode(constraint=16, polys=(0o100003, 0o170001))
    with pytest.raises(NotImplementedError, match="constraint=16"):
        viterbi_kernel._launch(code, torch.zeros(2, 2 * 23), 8)


# ------------------------------------------- the general instances ---

# codes the TPU kernels' gates admit beyond the fast kernels: Viterbi
# (K, generators), LDPC (k, dv)
_GEN_CONV = [(5, (0o23, 0o35)), (9, (0o561, 0o753)),
             (7, (0o117, 0o127, 0o155, 0o171)), (5, (0o31,)),
             (7, (0o132, 0o171))]
_GEN_LDPC = [(128, 2), (128, 5), (64, 8)]
# and the general Viterbi instances' other shapes: K = 11 (a warp a packet,
# 32 states a lane) and K = 15 (a block of 512 threads a packet), K = 12
# without the butterflies' +- symmetry (the block instance's general
# branch), K = 5 at rate 1/8 (2^rd = 256 branch values > 16 states: summed
# a butterfly, no table); LDPC at dv 4 and 7
_GEN_CONV_MORE = [(11, (0o3345, 0o3613)), (15, (0o46321, 0o51271)),
                  (12, (0o5262, 0o6711)),
                  (5, (0o23, 0o35, 0o27, 0o31, 0o37, 0o25, 0o33, 0o21))]
_GEN_LDPC_MORE = [(128, 4), (96, 7)]


def _conv_ids(codes):
    return [f"K{k}-r{len(p)}" for k, p in codes]


@pytest.mark.parametrize("k,polys", _GEN_CONV + _GEN_CONV_MORE,
                         ids=_conv_ids(_GEN_CONV + _GEN_CONV_MORE))
def test_plain_viterbi_matches_jax_at_new_codes(k, polys):
    """The plain Viterbi (the general instance's reference) against the
    JAX scan at the codes the widened kernel takes: bits equal."""
    rng = np.random.default_rng(k * 10 + len(polys))
    nbits = 40 if k < 11 else 16
    code, jcode = fec.ConvCode(k, polys), jfec.ConvCode(k, polys)
    u = rng.integers(0, 2, (6 if k < 11 else 3, nbits), dtype=np.int32)
    c = fec.conv_encode(code, torch.from_numpy(u)).numpy()
    llrs = ((1.0 - 2.0 * c) + rng.normal(0, 0.7, c.shape)).astype(F32)
    got = viterbi_kernel.viterbi_decode_plain(code, torch.from_numpy(llrs),
                                              nbits)
    want = np.asarray(jfec.viterbi_decode(jcode, jnp.asarray(llrs), nbits,
                                          impl="scan"))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,dv", _GEN_LDPC + _GEN_LDPC_MORE,
                         ids=[f"k{k}-dv{dv}" for k, dv in
                              _GEN_LDPC + _GEN_LDPC_MORE])
def test_plain_ldpc_matches_jax_at_new_codes(k, dv):
    """The plain min-sum against the JAX XLA lowering at variable degrees
    other than 3: >= 99.9 % bit agreement and equal frame errors."""
    rng = np.random.default_rng(k + dv)
    code, jcode = ldpc.LdpcCode(k, dv=dv), jldpc.LdpcCode(k, dv=dv)
    u = rng.integers(0, 2, (8, k), dtype=np.int32)
    c = ldpc.ldpc_encode(code, torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(c, np.asarray(jldpc.ldpc_encode(jcode, u)))
    llrs = ((1.0 - 2.0 * c) + rng.normal(0, 0.7, c.shape)).astype(F32)
    got = ldpc_kernel.ldpc_decode_plain(code, torch.from_numpy(llrs)).numpy()
    ref = np.asarray(jldpc.ldpc_decode(jcode, jnp.asarray(llrs), impl="xla"))
    assert (got == ref).mean() >= 0.999
    assert (got != u).any(-1).sum() == (ref != u).any(-1).sum()


@pytest.mark.parametrize("k,polys", _GEN_CONV + _GEN_CONV_MORE,
                         ids=_conv_ids(_GEN_CONV + _GEN_CONV_MORE))
def test_pattern_table_matches_trellis(k, polys):
    """``_pattern_table``: word j holds butterfly j's four branch patterns,
    the branch from predecessor p into state 2j + u at byte p + 2u, bit r
    set where ``_trellis``'s sign of output r is -1; ``_complementary``
    holds exactly where every generator taps the newest and oldest bit."""
    code = fec.ConvCode(k, polys)
    _, sgns = fec._trellis(code)                  # (rd, S, 2)
    words = viterbi_kernel._pattern_table(code, torch.device("cpu")).numpy()
    assert words.shape == (code.nstates // 2,) and words.dtype == np.int32
    words = words.view(np.uint32).astype(np.int64)
    for p in range(2):
        for u in range(2):
            pat = (words >> (8 * (p + 2 * u))) & 0xff
            for r in range(code.rate_den):
                np.testing.assert_array_equal((pat >> r) & 1,
                                              sgns[r, u::2, p] < 0)
    ends = all(g & 1 and g >> (k - 1) & 1 for g in polys)
    assert viterbi_kernel._complementary(code) == ends


@pytest.mark.parametrize("k", range(2, 16))
def test_general_viterbi_layout(k):
    """The general instance's states a thread at each constraint length: a
    power of two that divides the states, a packet in at most one warp up
    to K = 11 (S / spt <= 32 lanes), and from K = 12 the block instance's
    32 a thread, S/32 <= 512 threads a block."""
    s = 1 << (k - 1)
    spt = viterbi_kernel._states_per_thread(k)
    assert spt in (2, 4, 8, 16, 32) and s % spt == 0
    if k <= 11:
        assert s // spt <= 32
    else:
        assert spt == 32 and s // spt <= 512


def _branch_table(l, rd, builders):
    """One step's 2^rd branch values (..., 2^rd) as ``build_table`` forms
    them: builder g of ``builders`` (a power of two) takes the patterns
    g + builders*i, sums the shared low log2(builders) bits of them in
    order, then doubles a tree over the high bits (x - l for a one), and
    halves each sum."""
    gb = builders.bit_length() - 1
    pre = min(gb, rd)
    table = np.zeros(l.shape[:-1] + (1 << rd,), F32)
    for g in range(min(builders, 1 << rd)):
        acc = np.zeros(l.shape[:-1], F32)
        for j in range(pre):
            acc = (acc + (-l[..., j] if g >> j & 1 else l[..., j])).astype(F32)
        vals = [acc]
        for lev in range(rd - pre):
            lj = l[..., gb + lev]
            vals = ([(v + lj).astype(F32) for v in vals]
                    + [(v - lj).astype(F32) for v in vals])
        for i, v in enumerate(vals):
            table[..., g + builders * i] = F32(0.5) * v
    return table


def _direct_value(l, pattern, rd):
    """A pattern's branch value summed a butterfly (no table), (..., n)
    for (n,) patterns."""
    acc = np.zeros(l.shape[:-1] + pattern.shape, F32)
    for j in range(rd):
        lj = l[..., j:j + 1]
        acc = (acc + np.where((pattern >> j) & 1, -lj, lj)).astype(F32)
    return (F32(0.5) * acc).astype(F32)


def test_branch_table_equals_plain_sums():
    """Every builder count gives each pattern the plain version's value
    ``0.5 * (((0 + s0*l0) + s1*l1) + ...)``: the tree reorders nothing."""
    rng = np.random.default_rng(5)
    for rd in range(1, 9):
        l = rng.normal(0, 2, (7, rd)).astype(F32)
        want = _direct_value(l, np.arange(1 << rd), rd)
        for builders in (1, 2, 4, 8, 32, 64, 512):
            np.testing.assert_array_equal(_branch_table(l, rd, builders), want)


def _viterbi_general_twin(code, llrs, nbits):
    """The schedule of the general instances in float32 numpy: a step's
    branch values built into a table by the instance's S / spt threads
    (``_branch_table``) where 2^rd <= S, else summed a butterfly; each
    butterfly's values looked up by its patterns of ``_pattern_table`` (one
    value and its negative on a ``_complementary`` code); the predecessors
    read with the maximum of the step before subtracted, (nm - mx) + bm;
    decision c1 > c0 as the sign of c0 - c1; the new metrics stored
    un-normalised beside their maximum; the decisions packed a word per 32
    states (bit s & 31 of word s >> 5), then the traceback through the
    words."""
    k, s_count, rd = code.constraint, code.nstates, code.rate_den
    nsteps = nbits + k - 1
    half = s_count // 2
    builders = s_count // viterbi_kernel._states_per_thread(k)
    words = viterbi_kernel._pattern_table(code, torch.device("cpu")).numpy()
    pat = [(words.view(np.uint32) >> (8 * c)) & 0xff for c in range(4)]
    cpl = viterbi_kernel._complementary(code)
    direct = (1 << rd) > s_count
    b = llrs.shape[0]
    ll = llrs.reshape(b, nsteps, rd).astype(F32)
    nm = np.full((b, s_count), F32(-1e9), F32)
    nm[:, 0] = 0.0
    mx = np.zeros((b, 1), F32)
    dw = max(s_count // 32, 1)
    dec = np.zeros((b, nsteps, dw), np.uint32)
    sp = np.arange(s_count)
    for t in range(nsteps):
        l = ll[:, t]
        if direct:
            def val(p):
                return _direct_value(l, p, rd)
        else:
            table = _branch_table(l, rd, builders)

            def val(p):
                return table[:, p]
        q0 = (nm[:, :half] - mx).astype(F32)
        q1 = (nm[:, half:] - mx).astype(F32)
        if cpl:
            v = val(pat[0])
            x0, x1, y0, y1 = q0 + v, q1 - v, q0 - v, q1 + v
        else:
            x0, x1 = q0 + val(pat[0]), q1 + val(pat[1])
            y0, y1 = q0 + val(pat[2]), q1 + val(pat[3])
        new = np.empty_like(nm)
        new[:, 0::2], new[:, 1::2] = np.maximum(x0, x1), np.maximum(y0, y1)
        d = np.empty((b, s_count), bool)
        d[:, 0::2] = np.signbit((x0 - x1).astype(F32))
        d[:, 1::2] = np.signbit((y0 - y1).astype(F32))
        nm, mx = new, new.max(-1, keepdims=True)
        bits = d.astype(np.uint32) << (sp & 31).astype(np.uint32)
        for w in range(dw):
            dec[:, t, w] = np.bitwise_or.reduce(bits[:, 32 * w:32 * w + 32],
                                                axis=-1)
    out = np.zeros((b, nbits), np.int32)
    for i in range(b):
        s = 0
        for t in range(nsteps - 1, -1, -1):
            if t < nbits:
                out[i, t] = s & 1
            won = (int(dec[i, t, s >> 5]) >> (s & 31)) & 1
            s = (s >> 1) | (won << (k - 2))
    return out


@pytest.mark.parametrize("k,polys", _GEN_CONV + _GEN_CONV_MORE,
                         ids=_conv_ids(_GEN_CONV + _GEN_CONV_MORE))
@pytest.mark.parametrize("hard", [False, True])
def test_viterbi_general_schedule_equals_plain(k, polys, hard):
    """The general instances' twin decodes as the plain version, hard-LLR
    ties included (bit-equal)."""
    rng = np.random.default_rng(k + 3 * len(polys) + hard)
    code = fec.ConvCode(k, polys)
    assert viterbi_kernel.code_masks(code) is None
    nbits, npkt = (30, 5) if k < 11 else (12, 3)
    u = rng.integers(0, 2, (npkt, nbits), dtype=np.int32)
    c = fec.conv_encode(code, torch.from_numpy(u)).numpy()
    if hard:
        llrs = (1.0 - 2.0 * (c ^ (rng.random(c.shape) < 0.05))).astype(F32)
    else:
        llrs = ((1.0 - 2.0 * c) + rng.normal(0, 0.8, c.shape)).astype(F32)
    want = viterbi_kernel.viterbi_decode_plain(code, torch.from_numpy(llrs),
                                               nbits)
    np.testing.assert_array_equal(_viterbi_general_twin(code, llrs, nbits),
                                  want.numpy())


def _ldpc_general_twin(code, llrs):
    """``_ldpc_kernel_twin`` at the instance of the code's exact degrees
    (``ldpc_kernel._instance``): DMAX = dv + 2 slots a check and edge lists
    of VMAX = max(dv, 2), as the general instances are compiled (at dv = 3
    the fast instances' 5 and 3).  Up to dv = 3 each slot's next message
    sums its variable's VMAX list in order (padding reads the zero slot)
    plus the LLR, less its own message; from dv = 4 (``ldpc_totals_kernel``)
    each variable's total, LLR plus its list in order, is formed once and
    a slot's message is its variable's total less its own message; a slot
    past the check's degree carries BIG."""
    check_var, var_edges = ldpc._index_tables(code.k, code.dv, code.seed)
    table = ldpc._slot_edge_table(code.k, code.dv, code.seed)
    dmax, m = check_var.shape
    vmax = var_edges.shape[1]
    assert (dmax, vmax) == (code.dv + 2, max(code.dv, 2))
    if code.dv != 3:
        assert ldpc_kernel._instance(dmax, vmax) == code.dv
    totals = code.dv >= 4
    real = check_var >= 0
    big, alpha = F32(1e30), F32(code.alpha)
    llrs = llrs.astype(F32) + F32(0.0)
    lv = np.where(real, llrs[..., check_var.clip(min=0)], big).astype(F32)
    mm = lv.copy()
    idx = np.where(table >= 0, table, dmax * m)
    edges = np.where(var_edges >= 0, var_edges, dmax * m)

    def edge_sum(flat, cols):
        s = flat[..., cols[0]]
        for j in range(1, vmax):
            s = s + flat[..., cols[j]]
        return s
    for it in range(code.iters):
        m1 = np.full(mm.shape[:-2] + (m,), big)
        m2 = m1.copy()
        for s in range(dmax):
            a = np.abs(mm[..., s, :])
            m2 = np.minimum(m2, np.maximum(m1, a))
            m1 = np.minimum(m1, a)
        parity = np.bitwise_xor.reduce(mm.view(np.uint32), axis=-2)
        mag = np.where(np.abs(mm) > m1[..., None, :], (alpha * m1)[..., None, :],
                       (alpha * m2)[..., None, :]).astype(F32)
        sign = (parity[..., None, :] ^ mm.view(np.uint32)) & np.uint32(1 << 31)
        e = (mag.view(np.uint32) | sign).view(F32)
        e_stored = np.where(real, e, F32(0.0))
        flat = np.concatenate([e_stored.reshape(e.shape[:-2] + (dmax * m,)),
                               np.zeros(e.shape[:-2] + (1,), F32)], axis=-1)
        if it == code.iters - 1:
            break
        if totals:
            tot = llrs + edge_sum(flat, [edges[:, j] for j in range(vmax)])
            nxt = np.where(real, tot[..., check_var.clip(min=0)], big) - e
        else:
            nxt = (lv + edge_sum(flat, [idx[:, j] for j in range(vmax)])) - e
        mm = np.where(real, nxt, (lv + F32(0.0)) - e).astype(F32)
    sums = edge_sum(flat, [edges[:code.k, j] for j in range(vmax)])
    return ((llrs[..., :code.k] + sums) < 0).astype(np.int32)


_LDPC_TWIN = _GEN_LDPC + [(128, 3)] + _GEN_LDPC_MORE


@pytest.mark.parametrize("k,dv", _LDPC_TWIN,
                         ids=[f"k{k}-dv{dv}" for k, dv in _LDPC_TWIN])
def test_ldpc_general_schedule_equals_plain(k, dv):
    """The general instances' twin (the code's exact degrees, the totals
    schedule from dv = 4) decodes as the plain version; at dv=3 it is the
    fast instances' schedule."""
    rng = np.random.default_rng(7 * k + dv)
    code = ldpc.LdpcCode(k, dv=dv)
    u = torch.from_numpy(rng.integers(0, 2, (6, k), dtype=np.int32))
    c = ldpc.ldpc_encode(code, u).numpy()
    llrs = ((1.0 - 2.0 * c) + rng.normal(0, 0.75, c.shape)).astype(F32)
    want = ldpc_kernel.ldpc_decode_plain(code, torch.from_numpy(llrs))
    np.testing.assert_array_equal(_ldpc_general_twin(code, llrs), want.numpy())


@pytest.mark.parametrize("dv", range(1, 9))
def test_ldpc_instance_choice(dv):
    """Over the grid the coverage test walks (k 64..512 and the gate's
    largest code), each code of dv != 3 the wrapper covers has the exact
    degrees of one general instance, dmax = dv + 2 and vmax = max(dv, 2),
    and ``_instance`` picks that one; dv = 3 picks none (the fast
    instances)."""
    for k in list(range(64, 513, 64)) + [_GATE_EDGE_K.get(dv, 64)]:
        code = ldpc.LdpcCode(k, dv=dv)
        if ldpc_kernel.coverage(code) is not None:
            continue
        check_var, var_edges = ldpc._index_tables(k, dv, code.seed)
        dmax, vmax = check_var.shape[0], var_edges.shape[1]
        assert (dmax, vmax) == (dv + 2, max(dv, 2)), (k, dv)
        assert ldpc_kernel._instance(dmax, vmax) == (None if dv == 3 else dv)
