"""LDPC min-sum kernel wrapper (port of
``qpsk_tpu/ops/pallas/ldpc_kernel.py``, ``ldpc_decode_pallas``).

``ldpc_decode`` decodes (..., n) LLRs to (..., k) bits with normalized
min-sum over the code's compact index tables (``packet/ldpc.py``,
``_index_tables``).  On a CUDA tensor it launches ``csrc/ldpc.cu`` (one
block per packet, one barrier an iteration, every index in registers):
the instances for variable degree 3 (``PacketConfig`` builds ``dv=3``
only), check degree <= 8 and k <= m <= ``_KERNEL_M`` = 3276 checks
(``PacketConfig(payload_bytes=407, fec="ldpc")``), one check a thread up
to 1024 checks and two or four beyond; and the general instances for
every other ``LdpcCode(k, dv)`` of variable degree <= 8 and m <= 512
checks (the most threads their registers allow a block), one a variable
degree with the code's exact degrees (check degree dv + 2, edge lists of
max(dv, 2): ``_instance``; from dv = 4 each variable's total is summed
once an iteration, for a second barrier), which hold every code the TPU
kernel's gate admits (``dmax*m*n*4 <= 6 MiB``, so m <= 443).  Past that
it raises
``NotImplementedError`` naming the field before any launch.
``impl="xla"`` runs the plain version on any device, as the JAX package's
``impl`` does.  On a CPU tensor it runs
``ldpc_decode_plain``, the JAX XLA lowering's semantics in PyTorch:
``code.iters`` flooding iterations, first-wins argmin, normalization
``code.alpha``, posterior ``total[:k] < 0``, float32 throughout.  Both sum
a variable's incoming messages in the same fixed order (ascending slot
index, then the channel LLR), where the JAX package's matmuls leave the
order to the BLAS; the contract against the JAX package is its own:
>= 99.9 % bit agreement and equal frame errors.
"""

from __future__ import annotations

import functools
import math

import torch

from qpsk_tpu_torch.ops.cuda import _lib
from qpsk_tpu_torch.packet.ldpc import (LdpcCode, _index_tables,
                                        _slot_edge_table)

_BIG = 1e30
# the dv = 3 instances' register arrays hold this many slots of a check and
# this many edges of a variable; 16-bit byte offsets of the messages bound
# dmax*m below 16384 (m <= 3276 at the codes' check degree 5), and with
# four checks a thread a block of 1024 threads takes 4096 checks
_KERNEL_DMAX, _KERNEL_VMAX, _KERNEL_M = 8, 3, 3276
# the general instances': largest variable degree, checks (one a thread,
# GEN_THREADS of csrc/ldpc.cu)
_GEN_VMAX, _GEN_M = 8, 512


def _iters(code: LdpcCode, llrs: torch.Tensor, iters) -> int:
    if llrs.shape[-1] != code.n:
        raise ValueError(f"{llrs.shape[-1]} LLRs per packet, expected {code.n}")
    its = code.iters if iters is None else iters
    if its < 1:
        raise ValueError(f"min-sum needs at least one iteration, got {its}")
    return its


@functools.lru_cache(maxsize=None)
def _tables(code: LdpcCode, device: torch.device):
    """(check_var (dmax, m), var_edges (n, vmax)) int32 on ``device``."""
    check_var, var_edges = _index_tables(code.k, code.dv, code.seed)
    return (torch.from_numpy(check_var).to(device),
            torch.from_numpy(var_edges).to(device))


@functools.lru_cache(maxsize=None)
def _kernel_tables(code: LdpcCode, device: torch.device):
    """``_tables`` and the per-slot edge lists (dmax, vmax, m) that the
    kernel loads into registers, int32 on ``device``."""
    slot_edges = _slot_edge_table(code.k, code.dv, code.seed)
    return _tables(code, device) + (torch.from_numpy(slot_edges).to(device),)


def ldpc_decode(code: LdpcCode, llrs: torch.Tensor,
                iters: int | None = None, impl: str = "auto") -> torch.Tensor:
    """(..., n) LLRs (positive = bit 0) -> (..., k) int32 bits; ``impl``
    "auto" (the tensor's device) or "xla" (the plain version on any
    device)."""
    if impl not in ("auto", "xla"):
        raise ValueError(f"unknown ldpc impl {impl!r}")
    if impl == "auto" and llrs.is_cuda:
        return _launch(code, llrs, iters)
    return ldpc_decode_plain(code, llrs, iters)


def ldpc_decode_plain(code: LdpcCode, llrs: torch.Tensor,
                      iters: int | None = None) -> torch.Tensor:
    """The plain PyTorch version of ``ldpc_decode``: messages in a
    (..., dmax, m) block, index gathers in place of the JAX package's
    one-hot matmuls."""
    its = _iters(code, llrs, iters)
    check_var, var_edges = _tables(code, llrs.device)
    dmax, m = check_var.shape
    llrs = llrs.to(torch.float32)
    batch = tuple(llrs.shape[:-1])
    valid = check_var >= 0
    validf = valid.to(torch.float32)
    gidx = check_var.clamp(min=0).reshape(-1).to(torch.int64)
    # padded edges read a zero appended after the dmax*m messages
    eidx = torch.where(var_edges >= 0, var_edges, dmax * m).to(torch.int64)
    slot = torch.arange(dmax, device=llrs.device)[:, None]
    zero = torch.zeros(batch + (1,), dtype=torch.float32, device=llrs.device)

    def gather(total):
        """(..., n) variable totals -> (..., dmax, m) per-edge values."""
        g = total[..., gidx].reshape(batch + (dmax, m))
        return torch.where(valid, g, 0.0)

    def totals(e):
        """The channel LLR plus each variable's incoming messages, summed
        in edge-list order."""
        flat = torch.cat([e.reshape(batch + (dmax * m,)), zero], dim=-1)
        g = flat[..., eidx]                              # (..., n, vmax)
        s = g[..., 0]
        for j in range(1, g.shape[-1]):
            s = s + g[..., j]
        return llrs + s

    def check_update(mm):
        """Check-node min-sum: var->check to check->var messages."""
        amag = torch.where(valid, mm.abs(), _BIG)
        am = torch.argmin(amag, dim=-2, keepdim=True)   # first wins
        m1 = amag.amin(dim=-2, keepdim=True)
        m2 = torch.where(slot == am, _BIG, amag).amin(dim=-2, keepdim=True)
        neg = ((mm < 0) & valid).sum(dim=-2, keepdim=True) % 2
        srow = 1.0 - 2.0 * neg.to(torch.float32)
        sj = torch.where(mm < 0, -1.0, 1.0)
        mag = torch.where(slot == am, m2, m1)
        return code.alpha * srow * sj * mag * validf

    mm = gather(llrs)
    for _ in range(its - 1):
        e = check_update(mm)
        mm = gather(totals(e)) - e
    total = totals(check_update(mm))
    return (total[..., :code.k] < 0).to(torch.int32)


def coverage(code: LdpcCode):
    """None if the kernel covers ``code``, else (field, value, what the
    kernel takes) of the first field off it; the check count is asked
    before the index tables of a large code are built."""
    fast = code.dv == _KERNEL_VMAX
    if code.m > (_KERNEL_M if fast else _GEN_M):
        return ("m", code.m, f"m <= {_KERNEL_M} checks at dv={_KERNEL_VMAX}, "
                f"m <= {_GEN_M} at other dv")
    if code.dv > _GEN_VMAX:
        return "dv", code.dv, f"variable degree <= {_GEN_VMAX}"
    check_var, var_edges = _index_tables(code.k, code.dv, code.seed)
    dmax, m = check_var.shape
    if fast and dmax > _KERNEL_DMAX:
        return "dmax", dmax, f"check degrees <= {_KERNEL_DMAX} at dv=3"
    if not fast and _instance(dmax, var_edges.shape[1]) != code.dv:
        return ("dmax", dmax, f"check degree dv + 2 = {code.dv + 2} and "
                f"edge lists of {max(code.dv, 2)} at dv={code.dv}")
    if dmax * m >= 16384:
        return "m", m, "dmax*m < 16384 (16-bit message offsets)"
    return None


def _instance(dmax: int, vmax: int) -> int | None:
    """The variable degree of the general instance that runs a code of
    check degree ``dmax`` and edge lists of ``vmax`` (the shapes of its
    ``check_var`` and ``var_edges``), or None: each instance is compiled for
    its exact degrees, dmax = dv + 2 and vmax = max(dv, 2), for dv 1..8
    but 3 (the fast instances')."""
    dv = dmax - 2
    if dv in (1, 2, 4, 5, 6, 7, 8) and vmax == max(dv, 2):
        return dv
    return None


def _launch(code: LdpcCode, llrs: torch.Tensor, iters) -> torch.Tensor:
    its = _iters(code, llrs, iters)
    _lib.check_geometry(coverage(code))
    dev = llrs.device
    check_var, var_edges, slot_edges = _kernel_tables(code, dev)
    dmax, m = check_var.shape
    vmax = var_edges.shape[1]
    batch = tuple(llrs.shape[:-1])
    b = math.prod(batch)
    flat = llrs.to(torch.float32).reshape(b, code.n).contiguous()
    out = torch.empty((b, code.k), dtype=torch.int32, device=dev)
    if b == 0:
        return out.reshape(batch + (code.k,))
    _lib.launch(
        "qpsk_ldpc",
        flat.data_ptr(), check_var.data_ptr(), slot_edges.data_ptr(),
        var_edges.data_ptr(), out.data_ptr(), b, m, code.n, code.k, dmax,
        vmax, its, code.alpha, _lib.stream_ptr(dev))
    return out.reshape(batch + (code.k,))
