"""Complex arithmetic as explicit (re, im) float32 tensor planes.

The port keeps the JAX package's split-plane layout (``qpsk_tpu.ops.cplx``)
at every public function, so tests compare like with like and the CUDA
kernels read and write plain float32 planes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CF32(NamedTuple):
    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return self.re.shape


def czeros(shape, device=None) -> CF32:
    return CF32(torch.zeros(shape, dtype=torch.float32, device=device),
                torch.zeros(shape, dtype=torch.float32, device=device))


def cmul(a: CF32, b: CF32) -> CF32:
    """(a.re + j a.im)(b.re + j b.im); same op order as C complex mul."""
    return CF32(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def cexp_conj(theta: torch.Tensor) -> CF32:
    """cos(theta) - j sin(theta)."""
    return CF32(torch.cos(theta), -torch.sin(theta))


def cnormalize(a: CF32) -> CF32:
    """a / |a| — the per-block NCO renormalization."""
    inv = 1.0 / torch.sqrt(a.re * a.re + a.im * a.im)
    return CF32(a.re * inv, a.im * inv)


def cmap(fn, a: CF32) -> CF32:
    """Apply ``fn`` to both planes (slicing, reshapes, transposes)."""
    return CF32(fn(a.re), fn(a.im))
