"""Channel models on int16 PCM (port of ``qpsk_tpu.channel``: AWGN and
static multipath).

Noise comes from an explicit ``torch.Generator`` on the PCM's device, so a
run is reproducible from its seed.  The JAX package's PRNG keys give other
numbers: tests that compare the two packages make their noise with numpy.
"""

from __future__ import annotations

import torch


def awgn_pcm(generator: torch.Generator, pcm: torch.Tensor, snr_db,
             signal_power: float, pcm_scale: float = 16384.0) -> torch.Tensor:
    """Add real AWGN to int16 PCM at ``snr_db`` (a scalar, or one value per
    leading channel).  ``signal_power`` is the mean power of the analog
    signal before the ``pcm_scale`` multiply."""
    snr_db = torch.as_tensor(snr_db, dtype=torch.float32, device=pcm.device)
    sigma = torch.sqrt(signal_power / (10.0 ** (snr_db / 10.0)))
    while sigma.dim() < pcm.dim():
        sigma = sigma[..., None]
    noise = torch.randn(pcm.shape, generator=generator, dtype=torch.float32,
                        device=pcm.device)
    y = pcm.to(torch.float32) + noise * sigma * pcm_scale
    return torch.clamp(torch.round(y), -32768, 32767).to(torch.int16)


def multipath_pcm(pcm: torch.Tensor, paths) -> torch.Tensor:
    """Static multipath on int16 passband PCM along the last axis:
    ``y[n] = sum_d gain_d * x[n - delay_d]`` for ``paths`` of
    (delay_samples >= 0, gain), the echoes silent before sample 0.  The
    symbol-level ISI is what ``ModemConfig(eq_taps=...)`` removes."""
    x = pcm.to(torch.float32)
    y = torch.zeros_like(x)
    for delay, gain in paths:
        d = int(delay)
        if d < 0:
            raise ValueError(f"acausal path delay {d}")
        shifted = x if d == 0 else torch.cat(
            [torch.zeros(x.shape[:-1] + (d,), dtype=x.dtype, device=x.device),
             x[..., :-d]], dim=-1)
        y = y + float(gain) * shifted
    return torch.clamp(torch.round(y), -32768, 32767).to(torch.int16)
