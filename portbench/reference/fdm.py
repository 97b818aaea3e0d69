"""Plain reference of the FDM gateway's analysis filterbank, from its
published design: a critically sampled polyphase-DFT bank of ``N`` slots
over one real wideband stream at ``N fs``, the usable subchannels in slots
``1 .. N/2 - 1``.

* Prototype: a Kaiser-windowed sinc (``beta``), ``taps_per_branch N``
  taps, cut at ``1 / N`` of the wideband Nyquist and scaled to sum to 1
  (the synthesis prototype is the same shape scaled to sum to ``N``).
* Analysis: wideband samples in blocks of ``N``; block ``m`` read in
  reversed phase order, ``v[m, p] = x[m N - p]`` (zeros before the
  stream); branch FIRs ``u[m, p] = sum_k h[k N + p] v[m - k, p]``; slot
  ``c`` is ``y_c[m] = 2 nchan sum_p u[m, p] cos(2 pi c p / N)``, rounded
  half to even and saturated to int16.

Float64 here; the control computes the cosine product in TF32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def prototype(nslots: int, taps_per_branch: int, beta: float,
              total: float) -> np.ndarray:
    """The Kaiser-windowed sinc of ``taps_per_branch * nslots`` taps cut at
    ``1 / nslots``, scaled to sum to ``total``."""
    n = taps_per_branch * nslots
    fc = 1.0 / nslots
    i = np.arange(n, dtype=np.float64)
    h = fc * np.sinc(fc * (i - (n - 1) / 2.0)) * np.kaiser(n, beta)
    return h * (total / h.sum())


def cosines(nslots: int) -> np.ndarray:
    """(N, nchan) ``cos(2 pi c p / N)`` for the usable slots."""
    p = np.arange(nslots)
    return np.cos(2.0 * np.pi * np.outer(p, np.arange(1, nslots // 2))
                  / nslots)


def demux(wide: torch.Tensor, prev: torch.Tensor | None, nslots: int,
          taps_per_branch: int, beta: float, tf32: bool = False
          ) -> torch.Tensor:
    """(M N,) int16 wideband of one call, ``prev`` the call before it (None
    at the stream's start) -> (nchan, M) int16 subchannel PCM."""
    n = nslots
    q = taps_per_branch
    nchan = n // 2 - 1
    dev = wide.device
    need = (q - 1) * n + (n - 1)
    before = (torch.zeros(need, dtype=torch.int16, device=dev) if prev is None
              else prev[-need:])
    x = torch.cat([before, wide]).to(torch.float64)
    m = wide.shape[0] // n
    # the q - 1 history rows, then this call's m rows, each read reversed:
    # v[r, p] = x[r N - p] in the call's own sample count; the call's last
    # N - 1 samples open the next call's first row
    v = x[:(q - 1 + m) * n].reshape(q - 1 + m, n).flip(-1)
    h = torch.as_tensor(prototype(n, q, beta, 1.0).reshape(q, n),
                        device=dev)
    u = torch.zeros((m, n), dtype=torch.float64, device=dev)
    for k in range(q):
        u = u + h[k] * v[q - 1 - k:q - 1 - k + m]
    wc = torch.as_tensor(cosines(n), device=dev)
    if tf32:
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            y = (u.to(torch.float32) @ wc.to(torch.float32)).to(torch.float64)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
    else:
        y = u @ wc
    y = y * (2.0 * nchan)
    return torch.clamp(torch.round(y.T), -32768, 32767).to(torch.int16)
