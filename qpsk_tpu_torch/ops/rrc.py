"""Root-raised-cosine pulse shaping (port of ``qpsk_tpu.ops.rrc``).

``rrc_design`` is the same float64 closed form as the JAX package (the
reference's rrc_fir.c:32-76, quirks included: GAIN baked into the taps on
top of a second per-output GAIN multiply).  ``fir_block`` and
``fir_block_modulated`` are the plain PyTorch block FIRs: one banded
Toeplitz matmul per tile, split at the tail/block seam so the block operand
is a free reshape of the input.  They run in float32, the precision of the
JAX package's CPU lowering; ``fir_block(exact=True)`` (``fir_precision=
"exact"``) takes one full-float32 product over each tile's window, with
TF32 off on the card.  ``fir_reference_order`` is the C loop's order, a
sample at a time.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from qpsk_tpu_torch.ops.cplx import CF32


def rrc_design(fs: float, rs: float, alpha: float, ntaps: int = 127,
               gain: float = 1.85) -> np.ndarray:
    """RRC taps (float32) with ``sum(taps) == gain``."""
    spb = fs / rs
    half = ntaps // 2
    coeffs = np.zeros(ntaps, dtype=np.float64)
    for i in range(ntaps):
        xindx = float(i - half)
        x1 = np.pi * xindx / spb
        x2 = 4.0 * alpha * xindx / spb
        x3 = x2 * x2 - 1.0
        if abs(x3) >= 1e-6:
            if i != half:
                num = (np.cos((1.0 + alpha) * x1)
                       + np.sin((1.0 - alpha) * x1) / (4.0 * alpha * xindx / spb))
            else:
                num = np.cos((1.0 + alpha) * x1) + (1.0 - alpha) * np.pi / (4.0 * alpha)
            den = x3 * np.pi
        else:
            if alpha == 1.0:
                coeffs[i] = -1.0
                continue
            x3s = (1.0 - alpha) * x1
            x2s = (1.0 + alpha) * x1
            num = (np.sin(x2s) * (1.0 + alpha) * np.pi
                   - np.cos(x3s) * ((1.0 - alpha) * np.pi * spb) / (4.0 * alpha * xindx)
                   + np.sin(x3s) * spb * spb / (4.0 * alpha * xindx * xindx))
            den = -32.0 * np.pi * alpha * alpha * xindx / spb
        coeffs[i] = 4.0 * alpha * num / den
    scale = coeffs.sum()
    coeffs = coeffs * gain / scale
    return coeffs.astype(np.float32)


@functools.lru_cache(maxsize=None)
def taps_for(cfg) -> np.ndarray:
    """The RRC taps of a ``ModemConfig``."""
    return rrc_design(cfg.fs, cfg.rs, cfg.alpha, cfg.ntaps, cfg.gain)


def pick_block(n: int) -> int:
    """The largest of 512, 256, 128 that divides ``n`` (else ``n``): the
    tile of the block FIRs."""
    for b in (512, 256, 128):
        if n % b == 0:
            return b
    return n


def tile_block(n: int) -> int:
    """``pick_block(n)``, or for a length no power-of-two tile divides,
    the largest divisor of ``n`` up to 512, so that a long call's
    Toeplitz tile stays small (a push of many 8PSK packets modulates
    344 samples a row)."""
    block = pick_block(n)
    if block < n or n <= 512:
        return block
    return next(d for d in range(512, 0, -1) if n % d == 0)


@functools.lru_cache(maxsize=None)
def _toeplitz_np(taps_key: tuple, block: int) -> np.ndarray:
    taps = np.asarray(taps_key, dtype=np.float32)
    tmat = np.zeros((block + taps.shape[0] - 1, block), dtype=np.float32)
    for j in range(block):
        tmat[j:j + taps.shape[0], j] = taps
    return tmat


def toeplitz_taps(taps: np.ndarray, block: int) -> np.ndarray:
    """Banded Toeplitz matrix T with T[j + k, j] = taps[k]:
    ``y_tile = x_window @ T`` over ``block + ntaps - 1`` input samples."""
    return _toeplitz_np(tuple(np.asarray(taps, np.float32).tolist()), block)


def fir_init_tail(ntaps: int, batch_shape=(), device=None) -> CF32:
    """Zero delay-line tail of ``ntaps - 1`` samples."""
    shape = tuple(batch_shape) + (ntaps - 1,)
    return CF32(torch.zeros(shape, dtype=torch.float32, device=device),
                torch.zeros(shape, dtype=torch.float32, device=device))


@contextlib.contextmanager
def _full_f32():
    """Float32 matmuls at full precision (no TF32) on the card while the
    block runs; the setting is restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _windowed_matmul(x: torch.Tensor, tail: torch.Tensor, tmat: torch.Tensor,
                     block: int) -> torch.Tensor:
    """y = window @ tmat per tile, one product over the [tail | x] window
    of ``block + ntaps - 1`` samples (the JAX package's HIGHEST-precision
    branch, one accumulation a tile)."""
    n = x.shape[-1]
    ext = torch.cat([tail, x], dim=-1)
    win = ext.unfold(-1, block + tail.shape[-1], block)    # (..., nb, width)
    return (win @ tmat).reshape(x.shape[:-1] + (n,))


def _split_matmul(x: torch.Tensor, tail: torch.Tensor, tmat: torch.Tensor,
                  block: int, exact: bool = False) -> torch.Tensor:
    """y = window @ tmat per tile, as tail_part @ T[:ntaps-1] +
    block_part @ T[ntaps-1:] (the JAX DEFAULT-precision branch); a tile
    shorter than the tail (a call of fewer samples than ntaps-1), or
    ``exact``, takes the windowed branch."""
    n = x.shape[-1]
    ntaps_m1 = tail.shape[-1]
    if n % block:
        raise ValueError(f"block FIR needs n % block == 0, got n={n}, "
                         f"block={block}")
    if exact:
        with _full_f32():
            return _windowed_matmul(x, tail, tmat, block)
    if block < ntaps_m1:
        return _windowed_matmul(x, tail, tmat, block)
    nb = n // block
    blocks = x.reshape(x.shape[:-1] + (nb, block))
    prev = torch.cat([tail.unsqueeze(-2),
                      blocks[..., :-1, block - ntaps_m1:]], dim=-2)
    y = prev @ tmat[:ntaps_m1] + blocks @ tmat[ntaps_m1:]
    return y.reshape(x.shape[:-1] + (n,))


def fir_block(x: CF32, tail: CF32, tmat: torch.Tensor, gain: float,
              block: int, exact: bool = False):
    """Streaming RRC FIR over ``(..., n)`` CF32 samples with the carried
    ``(..., ntaps-1)`` tail; ``gain`` is the per-output GAIN multiply.
    ``exact`` (``fir_precision="exact"``) sums each output tile in one
    full-float32 product over its window.  Returns (y, new_tail)."""
    n = x.shape[-1]
    y = CF32(_split_matmul(x.re, tail.re, tmat, block, exact) * gain,
             _split_matmul(x.im, tail.im, tmat, block, exact) * gain)
    return y, CF32(*(torch.cat([t, p], dim=-1)[..., n:].contiguous()
                     for t, p in zip(tail, x)))


def fir_block_modulated(x: torch.Tensor, tail: torch.Tensor,
                        tmat_re: torch.Tensor, tmat_im: torch.Tensor,
                        gain: float, block: int):
    """Mix-free matched filter: REAL ``(..., n)`` input, complex modulated
    taps (``ops/frontend.py``).  Returns (u CF32, new_raw_tail)."""
    n = x.shape[-1]
    u = CF32(_split_matmul(x, tail, tmat_re, block) * gain,
             _split_matmul(x, tail, tmat_im, block) * gain)
    return u, torch.cat([tail, x], dim=-1)[..., n:]


def fir_reference_order(x: CF32, tail: CF32, taps, gain: float) -> CF32:
    """The FIR with the C MAC loop's ascending tap order (rrc_fir.c:24-26),
    a sample at a time over a 1-D stream ``x`` (n,) and its ``tail``
    (ntaps-1,): slow, for parity checks of ``fir_block``.  Each output is
    ``sum(mem * taps) * gain`` over the delay line ``mem``, whose oldest
    slot (shifted out before it is read) starts at zero."""
    taps = torch.as_tensor(np.asarray(taps, np.float32), device=x.re.device)
    mem_re = torch.cat([torch.zeros(1, device=x.re.device), tail.re])
    mem_im = torch.cat([torch.zeros(1, device=x.re.device), tail.im])
    yr = torch.empty_like(x.re)
    yi = torch.empty_like(x.im)
    for j in range(x.re.shape[-1]):
        mem_re = torch.cat([mem_re[1:], x.re[j:j + 1]])
        mem_im = torch.cat([mem_im[1:], x.im[j:j + 1]])
        yr[j] = torch.sum(mem_re * taps) * gain
        yi[j] = torch.sum(mem_im * taps) * gain
    return CF32(yr, yi)
