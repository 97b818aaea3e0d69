"""Complex arithmetic as explicit (re, im) float32 tensor planes.

The port keeps the JAX package's split-plane layout (``qpsk_tpu.ops.cplx``)
at every public function, so tests compare like with like and the CUDA
kernels read and write plain float32 planes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CF32(NamedTuple):
    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.dim()


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def czeros(shape, device=None) -> CF32:
    return CF32(torch.zeros(shape, dtype=torch.float32, device=device),
                torch.zeros(shape, dtype=torch.float32, device=device))


def cones(shape, device=None) -> CF32:
    """Unit phasors at angle 0."""
    return CF32(torch.ones(shape, dtype=torch.float32, device=device),
                torch.zeros(shape, dtype=torch.float32, device=device))


def cfull(shape, value: complex, device=None) -> CF32:
    return CF32(torch.full(shape, float(np.float32(value.real)),
                           dtype=torch.float32, device=device),
                torch.full(shape, float(np.float32(value.imag)),
                           dtype=torch.float32, device=device))


def from_parts(re, im, device=None) -> CF32:
    return CF32(_f32(re, device), _f32(im, device))


def from_real(re, device=None) -> CF32:
    re = _f32(re, device)
    return CF32(re, torch.zeros_like(re))


def from_complex(z, device=None) -> CF32:
    """Host boundary: numpy complex -> CF32."""
    z = np.asarray(z)
    return CF32(_f32(z.real.astype(np.float32), device),
                _f32(z.imag.astype(np.float32), device))


def to_complex(z: CF32) -> np.ndarray:
    """Host boundary: CF32 -> numpy complex64 (copies to the host)."""
    return (z.re.detach().cpu().numpy().astype(np.complex64)
            + 1j * z.im.detach().cpu().numpy())


def cadd(a: CF32, b: CF32) -> CF32:
    return CF32(a.re + b.re, a.im + b.im)


def csub(a: CF32, b: CF32) -> CF32:
    return CF32(a.re - b.re, a.im - b.im)


def cmul(a: CF32, b: CF32) -> CF32:
    """(a.re + j a.im)(b.re + j b.im); same op order as C complex mul."""
    return CF32(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def cmul_conj(a: CF32, b: CF32) -> CF32:
    """a * conj(b)."""
    return CF32(a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im)


def cscale(a: CF32, s) -> CF32:
    return CF32(a.re * s, a.im * s)


def cconj(a: CF32) -> CF32:
    return CF32(a.re, -a.im)


def cneg(a: CF32) -> CF32:
    return CF32(-a.re, -a.im)


def cabs2(a: CF32) -> torch.Tensor:
    return a.re * a.re + a.im * a.im


def cabs(a: CF32) -> torch.Tensor:
    return torch.sqrt(cabs2(a))


def cexp(theta) -> CF32:
    """cos(theta) + j sin(theta)."""
    theta = _f32(theta)
    return CF32(torch.cos(theta), torch.sin(theta))


def cexp_conj(theta: torch.Tensor) -> CF32:
    """cos(theta) - j sin(theta)."""
    return CF32(torch.cos(theta), -torch.sin(theta))


def cnormalize(a: CF32) -> CF32:
    """a / |a| — the per-block NCO renormalization."""
    inv = 1.0 / torch.sqrt(a.re * a.re + a.im * a.im)
    return CF32(a.re * inv, a.im * inv)


def cangle(a: CF32) -> torch.Tensor:
    return torch.atan2(a.im, a.re)


def cstack(parts, axis=0) -> CF32:
    return CF32(torch.stack([p.re for p in parts], dim=axis),
                torch.stack([p.im for p in parts], dim=axis))


def cconcat(parts, axis=-1) -> CF32:
    return CF32(torch.cat([p.re for p in parts], dim=axis),
                torch.cat([p.im for p in parts], dim=axis))


def ctake(a: CF32, idx, axis=-1) -> CF32:
    idx = torch.as_tensor(idx, device=a.re.device)
    return cmap(lambda p: _take(p, idx, axis), a)


def _take(p: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``numpy.take``: the entries of ``p`` at ``idx`` along ``axis``, the
    index's shape in the axis's place."""
    out = torch.index_select(p, axis, idx.reshape(-1))
    axis %= p.dim()
    return out.reshape(p.shape[:axis] + idx.shape + p.shape[axis + 1:])


def ctake_along_axis(a: CF32, idx, axis=-1) -> CF32:
    idx = torch.as_tensor(idx, device=a.re.device)
    return cmap(lambda p: torch.take_along_dim(p, idx, dim=axis), a)


def cmoveaxis(a: CF32, src, dst) -> CF32:
    return cmap(lambda p: torch.movedim(p, src, dst), a)


def creshape(a: CF32, shape) -> CF32:
    return cmap(lambda p: p.reshape(shape), a)


def cslice_last(a: CF32, start: int, stop: int) -> CF32:
    return cmap(lambda p: p[..., start:stop], a)


def cwhere(pred, a: CF32, b: CF32) -> CF32:
    return CF32(torch.where(pred, a.re, b.re), torch.where(pred, a.im, b.im))


def cbroadcast_to(a: CF32, shape) -> CF32:
    return cmap(lambda p: torch.broadcast_to(p, shape), a)


def cmap(fn, a: CF32) -> CF32:
    """Apply ``fn`` to both planes (slicing, reshapes, transposes)."""
    return CF32(fn(a.re), fn(a.im))
