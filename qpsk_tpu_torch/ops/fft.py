"""DFT with the reference's normalization (port of ``qpsk_tpu.ops.fft``).

The reference (algorithms/fft.c) divides by N in the forward transform
and not in the inverse, so ``ifft(fft(x)) == x``.  The JAX package
computes it as a matmul DFT for the TPU; here it is ``torch.fft`` with
``norm="forward"`` on the split (re, im) planes.  The host twins use
``np.fft``.
"""

from __future__ import annotations

import numpy as np
import torch

from qpsk_tpu_torch.ops.cplx import CF32


def _split(z: torch.Tensor) -> CF32:
    return CF32(z.real.contiguous(), z.imag.contiguous())


def fft(x: CF32) -> CF32:
    """Forward DFT over the last axis, scaled by 1/N."""
    return _split(torch.fft.fft(torch.complex(x.re, x.im), norm="forward"))


def ifft(x: CF32) -> CF32:
    """Unnormalized inverse DFT over the last axis."""
    return _split(torch.fft.ifft(torch.complex(x.re, x.im), norm="forward"))


def fft_np(x: np.ndarray) -> np.ndarray:
    """Host twin: complex in and out, the same convention."""
    return np.fft.fft(x, axis=-1) / x.shape[-1]


def ifft_np(x: np.ndarray) -> np.ndarray:
    return np.fft.ifft(x, axis=-1) * x.shape[-1]
