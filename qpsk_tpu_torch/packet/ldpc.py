"""Rate-1/2 LDPC (IRA structure) with a batched min-sum decoder (port of
``qpsk_tpu.packet.ldpc``).

``H = [A | B]``: A (m x k) has column weight ``dv`` (greedy row-balanced,
free of 4-cycles), B is the lower-bidiagonal accumulator.  The matrices are
drawn in numpy with the JAX package's ``default_rng(seed)`` order, so H is
the same bit for bit.  Encoding is A u over GF(2) plus a prefix XOR; the
syndrome is an XOR per check.  Both are gathers over the compact index
tables below, so they run on any device without an integer matmul.

``ldpc_decode`` hands the LLRs to ``ops/cuda/ldpc_kernel.py``: a CUDA
tensor launches ``csrc/ldpc.cu``, a CPU tensor runs the plain PyTorch
min-sum with the JAX XLA lowering's semantics.  LLRs follow
``modmap.demod_soft``: positive = bit 0.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from qpsk_tpu_torch import tracing


@dataclasses.dataclass(frozen=True)
class LdpcCode:
    """Rate-1/2 IRA LDPC for ``k`` message bits (n = 2k, m = k checks)."""
    k: int
    dv: int = 3          # message-column weight
    seed: int = 1        # deterministic construction seed
    iters: int = 25      # min-sum iterations
    alpha: float = 0.8   # min-sum normalization

    @property
    def m(self) -> int:
        return self.k

    @property
    def n(self) -> int:
        return 2 * self.k


@functools.lru_cache(maxsize=None)
def _matrices(k: int, dv: int, seed: int):
    """(A, H) numpy uint8: A (m x k) message part, H = [A | B] (m x n).

    Each message column takes the ``dv`` least-loaded check rows (ties
    broken by a uniform draw), re-drawn while any row pair is already used
    by another column or by the accumulator: no 4-cycles."""
    m = k
    rng = np.random.default_rng(seed)
    a = np.zeros((m, k), np.uint8)
    load = np.zeros(m, np.int64)
    used = {(i, i + 1) for i in range(m - 1)}   # accumulator pairs
    for j in range(k):
        for _ in range(200):
            order = np.argsort(load + rng.uniform(0.0, 0.9, m))
            rows = np.sort(order[:dv])
            pairs = [(int(rows[x]), int(rows[y]))
                     for x in range(dv) for y in range(x + 1, dv)]
            if all(p not in used for p in pairs):
                break
        used.update(pairs)
        a[rows, j] = 1
        load[rows] += 1
    b = np.eye(m, dtype=np.uint8)
    b[np.arange(1, m), np.arange(0, m - 1)] = 1   # accumulator
    h = np.concatenate([a, b], axis=1)
    return a, h


@functools.lru_cache(maxsize=None)
def _edges(k: int, dv: int, seed: int):
    """The JAX package's dense edge tables ``(scat, valid, dmax)``:
    ``scat`` (dmax*m, n) float32 has row ``s*m + i`` one-hot on the
    variable of check i's slot s (zero for slots past the check's degree),
    ``valid`` (dmax, m) masks the real slots."""
    _, h = _matrices(k, dv, seed)
    m, n = h.shape
    dmax = int(h.sum(axis=1).max())
    scat = np.zeros((dmax * m, n), np.float32)
    valid = np.zeros((dmax, m), np.float32)
    for i in range(m):
        for s, v in enumerate(np.flatnonzero(h[i])):
            scat[s * m + i, v] = 1.0
            valid[s, i] = 1.0
    return scat, valid, dmax


@functools.lru_cache(maxsize=None)
def _index_tables(k: int, dv: int, seed: int):
    """The compact form of ``_edges`` that the decoders use.

    Returns ``(check_var, var_edges)``, int32 with -1 for padding:
    ``check_var`` (dmax, m) is the variable of check i's slot s;
    ``var_edges`` (n, vmax) lists each variable's edges as flat slot
    indices ``s*m + i`` in ascending order, the order in which the
    decoders sum a variable's incoming messages."""
    scat, valid, dmax = _edges(k, dv, seed)
    n = scat.shape[1]
    check_var = np.where(valid > 0, scat.reshape(dmax, k, n).argmax(-1),
                         -1).astype(np.int32)
    var_edges = np.full((n, int(scat.sum(axis=0).max())), -1, np.int32)
    for v in range(n):
        rows = np.flatnonzero(scat[:, v])
        var_edges[v, :rows.size] = rows
    return check_var, var_edges


@functools.lru_cache(maxsize=None)
def _slot_edge_table(k: int, dv: int, seed: int) -> np.ndarray:
    """The per-slot edge lists the LDPC kernel keeps in registers:
    (dmax, vmax, m) int32 with ``table[s, :, i] = var_edges[check_var[s,
    i]]``, the edge list (same order, same -1 padding) of the variable on
    check i's slot s; all -1 where the slot itself is padding.  A check
    thread forms the slot's next message from it alone: the channel LLR
    plus the messages on these edges, minus its own."""
    check_var, var_edges = _index_tables(k, dv, seed)
    table = np.where(check_var[:, None, :] >= 0,
                     var_edges[check_var.clip(min=0)].transpose(0, 2, 1), -1)
    return np.ascontiguousarray(table, dtype=np.int32)


def _xor_rows(bits: torch.Tensor, cols: np.ndarray) -> torch.Tensor:
    """(..., n) 0/1 int32 bits -> (..., rows) parity of the bits at each
    row of ``cols`` ((rows, w) int32 column indices, -1 = none)."""
    zero = torch.zeros(bits.shape[:-1] + (1,), dtype=torch.int32,
                       device=bits.device)
    padded = torch.cat([bits, zero], dim=-1)
    idx = torch.from_numpy(np.where(cols >= 0, cols, bits.shape[-1]))
    tracing.count("sync.ldpc.rows")
    return padded[..., idx.to(bits.device)].sum(-1) % 2


def ldpc_encode(code: LdpcCode, bits: torch.Tensor) -> torch.Tensor:
    """(..., k) message bits -> (..., 2k) systematic codeword [u | p]:
    s = A u over GF(2), p = prefix-XOR(s) (the accumulator)."""
    u = bits.to(torch.int32)
    if u.shape[-1] != code.k:
        raise ValueError(f"{u.shape[-1]} message bits, expected {code.k}")
    check_var, _ = _index_tables(code.k, code.dv, code.seed)
    msg = np.where(check_var < code.k, check_var, -1).T      # A's rows
    s = _xor_rows(u, msg)
    p = (torch.cumsum(s, dim=-1) % 2).to(torch.int32)
    return torch.cat([u, p], dim=-1)


def ldpc_syndrome_weight(code: LdpcCode, bits: torch.Tensor) -> torch.Tensor:
    """Number of violated parity checks of (..., n) hard bits (0 for a
    codeword): the decode-free sync metric."""
    check_var, _ = _index_tables(code.k, code.dv, code.seed)
    return _xor_rows(bits.to(torch.int32), check_var.T).sum(-1).to(torch.int32)


def ldpc_decode(code: LdpcCode, llrs: torch.Tensor,
                iters: int | None = None, impl: str = "auto") -> torch.Tensor:
    """Normalized min-sum decode of (..., n) LLRs to (..., k) int32 bits,
    ``code.iters`` (or ``iters``) flooding iterations.  ``impl``: "auto",
    the tensor's device picks the lowering (the kernel on CUDA); "xla",
    the plain version on any device (the JAX package's ``impl``)."""
    from qpsk_tpu_torch.ops.cuda import ldpc_kernel
    return ldpc_kernel.ldpc_decode(code, llrs, iters, impl)
