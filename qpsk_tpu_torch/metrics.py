"""Link-quality metrics (port of ``qpsk_tpu.metrics``): reductions over the
last axis, batched over the leading ones."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from qpsk_tpu_torch.ops.cplx import CF32


class LinkMetrics(NamedTuple):
    evm_rms: torch.Tensor        # (...,) RMS error vector magnitude
    phase_err_rms: torch.Tensor  # (...,) rad
    power: torch.Tensor          # (...,) mean |sym|^2


def ber(bits_hat: torch.Tensor, bits_ref: torch.Tensor) -> torch.Tensor:
    """Bit error rate over the last axis."""
    errs = bits_hat.to(torch.int32) ^ bits_ref.to(torch.int32)
    return errs.to(torch.float32).mean(dim=-1)


def per(crc_ok: torch.Tensor) -> torch.Tensor:
    """Packet error rate from a (..., npackets) CRC verdict tensor."""
    return 1.0 - crc_ok.to(torch.float32).mean(dim=-1)


def snr_estimate_db(symbols: CF32) -> torch.Tensor:
    """Blind SNR estimate (dB) of derotated PSK symbols, the M2M4 moments
    estimator: signal S = sqrt(2 M2^2 - M4), noise N = M2 - S."""
    p = symbols.re ** 2 + symbols.im ** 2
    m2 = p.mean(dim=-1)
    m4 = (p * p).mean(dim=-1)
    s = torch.sqrt(torch.clamp(2.0 * m2 * m2 - m4, min=1e-30))
    n = torch.maximum(m2 - s, 1e-30 * m2 + 1e-30)
    return 10.0 * torch.log10(s / n)


def snr_estimate_db_host(re: np.ndarray, im: np.ndarray) -> float:
    """The numpy twin of ``snr_estimate_db`` for the streaming runtime's
    link counters: the M2M4 moments of one bucket's symbols, in float64 on
    the host, which already holds them."""
    p = np.asarray(re, np.float64) ** 2 + np.asarray(im, np.float64) ** 2
    m2 = float(p.mean())
    m4 = float((p * p).mean())
    s = math.sqrt(max(2.0 * m2 * m2 - m4, 1e-30))
    n = max(m2 - s, 1e-30 * m2 + 1e-30)
    return 10.0 * math.log10(s / n)


def evm(symbols: CF32, normalize: bool = True) -> LinkMetrics:
    """EVM of derotated QPSK symbols against the nearest diagonal point
    (+-1, +-1)/sqrt(2); with ``normalize`` the cloud is first scaled to
    unit RMS, so the chain's passband gain does not read as error."""
    p = (symbols.re ** 2 + symbols.im ** 2).mean(dim=-1)
    re, im = symbols.re, symbols.im
    if normalize:
        scale = torch.where(p > 0, 1.0 / torch.sqrt(p), 1.0)[..., None]
        re, im = re * scale, im * scale
    c = 1.0 / math.sqrt(2.0)
    ir = torch.where(re >= 0, c, -c)
    ii = torch.where(im >= 0, c, -c)
    err2 = (re - ir) ** 2 + (im - ii) ** 2
    phase = torch.atan2(im, re) - torch.atan2(ii, ir)
    phase = torch.remainder(phase + math.pi, 2 * math.pi) - math.pi
    return LinkMetrics(evm_rms=torch.sqrt(err2.mean(dim=-1)),
                       phase_err_rms=torch.sqrt((phase ** 2).mean(dim=-1)),
                       power=p)
