"""Soft-decision Viterbi kernel wrapper (port of
``qpsk_tpu/ops/pallas/viterbi_kernel.py``, ``viterbi_decode_pallas``).

``viterbi_decode`` decodes (..., rd*(nbits+K-1)) LLRs to (..., nbits)
bits.  On a CUDA tensor it launches ``csrc/viterbi.cu``: for a K=7
rate-1/2 code whose generators tap the newest and the oldest bit (handed
to the kernel as the two bit masks of its sign table, ``code_masks``) the
fast kernels, a packet's trellis in the registers of 1, 8 or 32 lanes of a
warp, by batch size; for every other code the TPU kernel's gate takes
(rate 1/1, 1/2, 1/4 or 1/8, K >= 5, any generators) up to K = 15 the
general instances (a packet's states in the registers of one warp or part
of one up to K = 11, ``_states_per_thread`` of them a lane, of a block of
S/32 threads beyond; each butterfly's four branch patterns as one word of
``_pattern_table``, a step's branch values summed once into a table; the
decisions packed as bits in shared or device memory and traced back by
the packet's lanes together); past K = 15 it raises
``NotImplementedError`` naming ``constraint`` before any launch.
``impl="scan"`` runs the plain version on any device, as the JAX
package's ``impl`` does.  On a CPU tensor it runs
``viterbi_decode_plain``, the JAX package's scan twin
(``packet/fec.py``) in PyTorch with the same op order: path metrics start
at -1e9 with 0 in state 0, ``bm = 0.5*(sgn0*l0 + sgn1*l1)``, gather-free
predecessors ``p*32 + (s'>>1)``, decisions ``c1 > c0``, the metrics
renormalized by their maximum after every step, traceback from state 0.
Every operation rounds once in both, so the kernel and the plain version
decode bit-identically, hard-LLR ties included.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from qpsk_tpu_torch.ops.cuda import _lib
from qpsk_tpu_torch.packet.fec import ConvCode, _trellis

# the general instance's largest constraint length (16 384 states, two
# 64 KB metric arrays in shared memory) and rate denominator
_MAX_K, _MAX_RD = 15, 8


def _nsteps(code: ConvCode, llrs: torch.Tensor, nbits: int) -> int:
    nsteps = nbits + code.constraint - 1
    if nbits < 1 or llrs.shape[-1] != code.rate_den * nsteps:
        raise ValueError(
            f"{llrs.shape[-1]} LLRs per packet for {nbits} bits, expected "
            f"{code.rate_den * nsteps}")
    return nsteps


def viterbi_decode(code: ConvCode, llrs: torch.Tensor, nbits: int,
                   impl: str = "auto") -> torch.Tensor:
    """(..., rd*(nbits+K-1)) LLRs (positive = bit 0) -> (..., nbits) int32
    bits; ``impl`` "auto" (the tensor's device) or "scan" (the plain
    version on any device)."""
    if impl not in ("auto", "scan"):
        raise ValueError(f"unknown viterbi impl {impl!r}")
    if impl == "auto" and llrs.is_cuda:
        return _launch(code, llrs, nbits)
    return viterbi_decode_plain(code, llrs, nbits)


def viterbi_decode_plain(code: ConvCode, llrs: torch.Tensor,
                         nbits: int) -> torch.Tensor:
    """The plain PyTorch version of ``viterbi_decode``: one ACS step per
    trellis step over the (..., 2, S) candidate grid, decisions kept as a
    (T, ..., S) bool tensor, then the traceback."""
    k, s_count, rd = code.constraint, code.nstates, code.rate_den
    nsteps = _nsteps(code, llrs, nbits)
    dev = llrs.device
    _, sgns_np = _trellis(code)
    # (rd, 2, S): branch-metric signs with the predecessor choice p leading
    sgns = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(sgns_np, -1, 1))).to(dev)
    batch = tuple(llrs.shape[:-1])
    ll = llrs.to(torch.float32).reshape(batch + (nsteps, rd)).movedim(-2, 0)

    pm = torch.full(batch + (s_count,), -1e9, dtype=torch.float32, device=dev)
    pm[..., 0] = 0.0
    decisions = torch.empty((nsteps,) + batch + (s_count,), dtype=torch.bool,
                            device=dev)
    for t in range(nsteps):
        l = ll[t]
        bm = 0.5 * sum(sgns[j] * l[..., j:j + 1, None] for j in range(rd))
        # pred(s', p) = p*(S/2) + (s' >> 1): each half of pm, every element
        # repeated twice
        pred = pm.reshape(batch + (2, s_count // 2)).repeat_interleave(2, -1)
        cand = pred + bm
        decisions[t] = cand[..., 1, :] > cand[..., 0, :]
        pm = torch.maximum(cand[..., 0, :], cand[..., 1, :])
        pm = pm - pm.amax(dim=-1, keepdim=True)

    # traceback from state 0 (tail-terminated), newest decision first
    s = torch.zeros(batch + (1,), dtype=torch.int64, device=dev)
    us = torch.empty((nsteps,) + batch, dtype=torch.int32, device=dev)
    for t in range(nsteps - 1, -1, -1):
        us[t] = (s & 1)[..., 0]
        won = torch.gather(decisions[t], -1, s).to(torch.int64)
        s = (s >> 1) | (won << (k - 2))
    return us.movedim(0, -1)[..., :nbits].contiguous()


@functools.lru_cache(maxsize=None)
def code_masks(code: ConvCode) -> tuple[int, int] | None:
    """The kernel's form of ``code``'s sign table: for each output k the
    32-bit mask whose bit j is set where that output is a one on the branch
    from state j to state 2j (``fec._trellis``: ``sgns[k, 2j, 0] < 0``).
    None unless the code is K=7 rate 1/2 with the butterfly symmetry the
    kernel runs on (both generators tap the newest and the oldest bit):
    the branches into 2j + 1 and from 32 + j carry the same signs, negated
    once each.  Cached: its numpy work costs the host more than the
    kernel takes on the card at 4096 packets (PERF.md § 7)."""
    if code.constraint != 7 or code.rate_den != 2:
        return None
    _, sgns = _trellis(code)
    s = sgns[:, 0::2, 0]                  # (2, 32): branch j -> 2j
    if not (np.array_equal(sgns[:, 0::2, 1], -s)
            and np.array_equal(sgns[:, 1::2, 0], -s)
            and np.array_equal(sgns[:, 1::2, 1], s)):
        return None
    weights = 1 << np.arange(32, dtype=np.int64)
    return tuple(int(((s[k] < 0) * weights).sum()) for k in range(2))


def coverage(code: ConvCode):
    """None if the kernel covers ``code``, else (field, value, what the
    kernel takes)."""
    if code.constraint > _MAX_K or code.constraint < 2:
        return ("constraint", code.constraint,
                f"constraint lengths 2..{_MAX_K} (up to 16 384 states)")
    if code.rate_den > _MAX_RD:
        return "polys", tuple(oct(g) for g in code.polys), \
            f"rate 1/{_MAX_RD} or above"
    return None


@functools.lru_cache(maxsize=None)
def _branch_patterns(code: ConvCode) -> np.ndarray:
    """(S/2, 4) uint8: the four branch patterns of butterfly j, the
    branches from predecessor p (states j and S/2 + j) into state 2j + u
    in column p + 2u; bit k of a pattern is set where ``_trellis``'s
    ``sgns[k, s', p]`` is -1 (output k of the branch is a one)."""
    _, sgns = _trellis(code)                      # (rd, S, 2)
    pat = ((sgns < 0).astype(np.int64) << np.arange(
        code.rate_den)[:, None, None]).sum(0)     # (S, 2): [s', p]
    return np.stack([pat[0::2, 0], pat[0::2, 1], pat[1::2, 0],
                     pat[1::2, 1]], axis=1).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _complementary(code: ConvCode) -> bool:
    """Whether each butterfly's branches carry one value and its negative:
    the patterns (1, 0) and (0, 1) are the complement of (0, 0) and (1, 1)
    is (0, 0), as where every generator taps the newest and the oldest
    bit.  The general instance then reads one table value a butterfly."""
    pat = _branch_patterns(code).astype(np.int64)
    full = (1 << code.rate_den) - 1
    return bool((pat[:, 1] == pat[:, 0] ^ full).all()
                and (pat[:, 2] == pat[:, 0] ^ full).all()
                and (pat[:, 3] == pat[:, 0]).all())


@functools.lru_cache(maxsize=None)
def _pattern_table(code: ConvCode, device) -> torch.Tensor:
    """The general instance's branch patterns: (S/2,) int32, butterfly j's
    four ``_branch_patterns`` as the bytes of one word, column c at bits
    8c."""
    words = _branch_patterns(code).view("<u4")[:, 0].view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(words)).to(device)


def _states_per_thread(constraint: int) -> int:
    """The states a thread of the general instance holds at constraint
    length K: all 2 or 4 at K = 2, 3 (one lane a packet); 8 up to K = 9 (a
    warp a packet at K = 9), 16 at K = 10, 32 at K = 11 (a warp a packet);
    32 from K = 12, where a block of S/32 threads holds a packet."""
    s = 1 << (constraint - 1)
    if s <= 4:
        return s
    return 8 if constraint <= 9 else 16 if constraint == 10 else 32


def _lanes(b: int) -> int:
    """How many lanes of a warp hold one packet's trellis for a batch of
    ``b`` packets: the fastest of the kernel's shapes at that size on the
    H100 (``chip_smoke.py --fec`` measures them all; PERF.md has the
    table).  One lane a packet needs the fewest instructions but 16 896
    packets to give each of the card's 528 warp schedulers a warp; below
    that more lanes a packet shorten a step's dependent chain instead:
    8 lanes up to 8192 packets, the whole warp (two states a lane) up to
    2048, where a launch is one packet's latency."""
    if b <= 2048:
        return 32
    return 8 if b <= 8192 else 1


def _launch(code: ConvCode, llrs: torch.Tensor, nbits: int,
            lanes: int | None = None) -> torch.Tensor:
    _lib.check_geometry(coverage(code))
    nsteps = _nsteps(code, llrs, nbits)
    dev = llrs.device
    batch = tuple(llrs.shape[:-1])
    b = math.prod(batch)
    rd = code.rate_den
    flat = llrs.to(torch.float32).reshape(b, rd * nsteps).contiguous()
    out = torch.empty((b, nbits), dtype=torch.int32, device=dev)
    if b == 0:
        return out.reshape(batch + (nbits,))
    masks = code_masks(code)
    if masks is None:
        # a decision bit a state and step
        dec = torch.empty((b, nsteps, max(code.nstates // 32, 1)),
                          dtype=torch.int32, device=dev)
        _lib.launch(
            "qpsk_viterbi_gen",
            flat.data_ptr(), _pattern_table(code, dev).data_ptr(),
            dec.data_ptr(), out.data_ptr(), b, code.constraint, rd, nsteps,
            nbits, _states_per_thread(code.constraint),
            int(_complementary(code)), _lib.stream_ptr(dev))
        return out.reshape(batch + (nbits,))
    # one 64-bit word of decisions per trellis step and packet
    dec = torch.empty((nsteps, b, 2), dtype=torch.int32, device=dev)
    _lib.launch(
        "qpsk_viterbi",
        flat.data_ptr(), dec.data_ptr(), out.data_ptr(), b, nsteps, nbits,
        lanes or _lanes(b), *masks, _lib.stream_ptr(dev))
    return out.reshape(batch + (nbits,))
