"""Convolutional FEC: rate-1/2 encoder and soft-decision Viterbi decoder
(port of ``qpsk_tpu.packet.fec``).

The default code is the K=7 (133, 171) code.  The trellis tables are
built once per code on the host.  ``viterbi_decode`` hands the LLRs to
``ops/cuda/viterbi_kernel.py``: a CUDA tensor launches ``csrc/viterbi.cu``,
a CPU tensor runs the plain PyTorch twin of the JAX package's scan.  LLRs
follow ``modmap.demod_soft``: positive = bit 0.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ConvCode:
    """Rate 1/(len(polys)) convolutional code, octal generator polys."""
    constraint: int = 7
    polys: tuple = (0o133, 0o171)

    @property
    def nstates(self) -> int:
        return 1 << (self.constraint - 1)

    @property
    def rate_den(self) -> int:
        return len(self.polys)

    def coded_bits(self, nbits: int) -> int:
        """Coded length for ``nbits`` payload bits, tail-terminated."""
        return self.rate_den * (nbits + self.constraint - 1)


@functools.lru_cache(maxsize=None)
def _trellis(code: ConvCode):
    """Static trellis tables ``(preds (S, 2) int32, sgns (rd, S, 2)
    float32)``.

    State s packs the last K-1 input bits, newest in the LSB.  Next-state
    s' consumed input ``u = s' & 1``; its predecessors are
    ``(s' >> 1) | (p << (K-2))`` for p in {0, 1}, and ``sgns[j, s', p] =
    1 - 2*out_j(pred_p, u)`` is the branch-metric sign of output j.
    """
    k, s_count = code.constraint, code.nstates
    sp = np.arange(s_count, dtype=np.int64)
    u = sp & 1
    preds = np.stack([(sp >> 1), (sp >> 1) | (1 << (k - 2))], axis=1)
    sgns = []
    for g in code.polys:
        r = (preds << 1) | u[:, None]
        out = np.zeros_like(r)
        for bit in range(k):
            if (g >> bit) & 1:
                out ^= (r >> bit) & 1
        sgns.append((1 - 2 * out).astype(np.float32))
    return preds.astype(np.int32), np.stack(sgns, axis=0)


def conv_encode(code: ConvCode, bits: torch.Tensor) -> torch.Tensor:
    """(..., n) payload bits -> (..., rate_den*(n+K-1)) coded bits int32,
    tail-terminated: K-1 zero flush bits return the encoder to state 0."""
    k = code.constraint
    b = bits.to(torch.int32)
    zeros = torch.zeros(b.shape[:-1] + (k - 1,), dtype=torch.int32,
                        device=b.device)
    flushed = torch.cat([b, zeros], dim=-1)
    padded = torch.cat([zeros, flushed], dim=-1)
    n = flushed.shape[-1]
    outs = []
    for g in code.polys:
        acc = torch.zeros_like(flushed)
        for bit in range(k):
            if (g >> bit) & 1:
                acc = acc ^ padded[..., k - 1 - bit:k - 1 - bit + n]
        outs.append(acc)
    return torch.stack(outs, dim=-1).reshape(b.shape[:-1] + (code.rate_den * n,))


def viterbi_decode(code: ConvCode, llrs: torch.Tensor, nbits: int,
                   impl: str = "auto") -> torch.Tensor:
    """Soft-decision Viterbi decode of (..., rate_den*(nbits+K-1)) LLRs to
    (..., nbits) int32 bits.  ``impl``: "auto", the tensor's device picks
    the lowering (the kernel on CUDA); "scan", the plain version on any
    device (the JAX package's ``impl``)."""
    from qpsk_tpu_torch.ops.cuda import viterbi_kernel
    return viterbi_kernel.viterbi_decode(code, llrs, nbits, impl)


def hard_llrs(bits: torch.Tensor) -> torch.Tensor:
    """Hard bits -> unit LLRs (positive = bit 0), for hard-input decoding."""
    return (1 - 2 * bits.to(torch.int32)).to(torch.float32)
