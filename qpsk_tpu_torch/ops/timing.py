"""Symbol timing, "power" mode (port of ``qpsk_tpu.ops.timing``).

Pick the decimation phase with the largest mean squared envelope after the
matched filter (Oerder & Meyr style), first maximum winning ties, and take
one sample per symbol at that phase.
"""

from __future__ import annotations

import torch

from qpsk_tpu_torch.ops.cplx import CF32


def timing_power(frames: CF32, cycles: int) -> torch.Tensor:
    """argmax_p mean |x[i*cycles + p]|^2 over (..., frame_size) frames."""
    nsym = frames.shape[-1] // cycles
    e = frames.re * frames.re + frames.im * frames.im
    energy = e.reshape(frames.shape[:-1] + (nsym, cycles)).mean(dim=-2)
    return torch.argmax(energy, dim=-1).to(torch.int32)


def decimate_select(frames: CF32, index: torch.Tensor, cycles: int) -> CF32:
    """Pick sample ``s*cycles + index`` of each symbol ``s``; ``index`` is
    batch-shaped over the frames and lies in [0, cycles)."""
    nsym = frames.shape[-1] // cycles
    idx = index.long()[..., None, None].expand(frames.shape[:-1] + (nsym, 1))

    def one(plane):
        r = plane.reshape(frames.shape[:-1] + (nsym, cycles))
        return torch.gather(r, -1, idx)[..., 0]
    return CF32(one(frames.re), one(frames.im))


def estimate_and_decimate(frames: CF32, cycles: int, mode: str = "power"):
    """(picks (..., nframes, nsym), index (..., nframes) int32)."""
    if mode != "power":
        raise NotImplementedError(f"timing_mode={mode!r} is not ported")
    index = timing_power(frames, cycles)
    return decimate_select(frames, index, cycles), index
