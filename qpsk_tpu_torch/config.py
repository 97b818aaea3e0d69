"""Modem configuration, field for field the same as ``qpsk_tpu.config``.

The JAX package's ``qpsk_tpu/__init__.py`` imports its modem and with it
jax, so the port keeps its own copy of the dataclass.  A test pins the two
to equal fields, defaults and validation; ``from_dict`` builds this config
from ``dataclasses.asdict`` of the JAX one.

The port runs every config this class accepts.
"""

from __future__ import annotations

import dataclasses
import math

from qpsk_tpu_torch.ops import modfam

TAU = 2.0 * math.pi

# bits per symbol: QPSK's 2 and the generic family's (ops/modfam.py)
_BPS = {"qpsk": 2, **{name: m.bps for name, m in modfam.MODULATIONS.items()}}


@dataclasses.dataclass(frozen=True)
class ModemConfig:
    """Static parameters of one modem instance.

    Defaults are the reference design point: 2400 baud QPSK at 9600
    samples/s on a 1500 Hz carrier, 127-tap RRC with alpha=0.35 and
    GAIN=1.85, Costas bandwidth TAU/100 with damping sqrt(2)/2 and a
    +/-1 rad/symbol frequency clamp.  See ``qpsk_tpu.config.ModemConfig``
    for what each mode switch selects.
    """

    fs: float = 9600.0
    rs: float = 2400.0
    center: float = 1500.0
    alpha: float = 0.35
    ntaps: int = 127
    gain: float = 1.85
    frame_size: int = 512
    loop_bw: float = TAU / 100.0
    loop_bw_track: float = 0.0
    damping: float = math.sqrt(2.0) / 2.0
    min_freq: float = -1.0
    max_freq: float = 1.0
    pcm_scale: float = 16384.0
    modulation: str = "qpsk"
    timing_mode: str = "power"
    nco_mode: str = "fast"
    slicer: str = "diagonal"
    acquisition: str = "fft"
    differential: bool = False
    # The *_impl fields select a lowering: "auto", the tensor's device
    # picks kernel (CUDA) or plain version (CPU); "scan" / "xla", the
    # plain version on any device; "pallas", the kernel (CUDA only).
    costas_impl: str = "auto"
    frontend_impl: str = "auto"
    tx_impl: str = "auto"
    fir_precision: str = "fast"
    eq_taps: int = 0
    eq_mu: float = 0.2
    eq_modulus: float = 2.1
    agc: bool = False
    agc_target: float = 1.45
    agc_mu: float = 0.5
    nfft: int = 512
    scramble_seed: int = 0x4A80

    def __post_init__(self):
        if self.fs % self.rs != 0:
            raise ValueError(f"fs={self.fs} must be an integer multiple of rs={self.rs}")
        if self.frame_size % int(self.fs / self.rs) != 0:
            raise ValueError(
                f"frame_size={self.frame_size} must be divisible by "
                f"cycles={int(self.fs / self.rs)} (samples per symbol) — "
                "the timing/decimation pipeline reshapes frames into whole "
                "symbol groups")
        if self.ntaps % 2 != 1:
            raise ValueError("ntaps must be odd")
        if self.timing_mode not in ("histogram", "power", "fractional",
                                    "tracking"):
            raise ValueError(f"unknown timing_mode {self.timing_mode!r}")
        if self.modulation not in _BPS:
            raise ValueError(f"unknown modulation {self.modulation!r}")
        if self.modulation != "qpsk":
            if self.differential:
                raise ValueError(
                    f"differential=True is the DQPSK mode; "
                    f"modulation={self.modulation!r} is coherent-only")
            if self.slicer == "reference":
                raise ValueError(
                    "slicer='reference' replicates the C QPSK slicer; "
                    f"not meaningful for modulation={self.modulation!r}")
            if self.loop_bw_track > 0:
                raise ValueError(
                    "loop_bw_track (gear-shift Costas) is tuned on the "
                    "QPSK lock statistic; set 0 for "
                    f"modulation={self.modulation!r}")
        if self.nco_mode not in ("fast", "exact"):
            raise ValueError(f"unknown nco_mode {self.nco_mode!r}")
        if self.slicer not in ("diagonal", "reference"):
            raise ValueError(f"unknown slicer {self.slicer!r}")
        if self.costas_impl not in ("auto", "scan", "pallas"):
            raise ValueError(f"unknown costas_impl {self.costas_impl!r}")
        if self.frontend_impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown frontend_impl {self.frontend_impl!r}")
        if self.tx_impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown tx_impl {self.tx_impl!r}")
        if self.fir_precision not in ("fast", "exact"):
            raise ValueError(f"unknown fir_precision {self.fir_precision!r}")
        if self.acquisition not in ("none", "fft"):
            raise ValueError(f"unknown acquisition {self.acquisition!r}")
        if self.loop_bw_track < 0 or self.loop_bw_track > self.loop_bw:
            raise ValueError(
                f"loop_bw_track={self.loop_bw_track} must be in "
                f"[0, loop_bw={self.loop_bw}] — the tracking gear is the "
                "narrower bandwidth (0 disables the gear shift)")
        if self.eq_taps < 0:
            raise ValueError(f"eq_taps={self.eq_taps} must be >= 0")
        if not 0.0 < self.agc_mu <= 1.0:
            raise ValueError(f"agc_mu={self.agc_mu} must be in (0, 1]")
        if self.agc_target <= 0.0:
            raise ValueError(f"agc_target={self.agc_target} must be > 0")

    @property
    def cycles(self) -> int:
        """Samples per symbol."""
        return int(self.fs / self.rs)

    @property
    def bits_per_symbol(self) -> int:
        return _BPS[self.modulation]

    @property
    def bits_per_frame(self) -> int:
        """Channel bits carried by one modem frame."""
        return self.bits_per_symbol * self.symbols_per_frame

    @property
    def symbols_per_frame(self) -> int:
        return self.frame_size // self.cycles

    @property
    def omega_center(self) -> float:
        """Carrier phase increment, rad/sample."""
        return TAU * self.center / self.fs


def from_dict(fields: dict) -> ModemConfig:
    """The port's config from ``dataclasses.asdict`` of a JAX config."""
    return ModemConfig(**fields)


def config_2400() -> ModemConfig:
    """Reference design point: 2400 baud VHF/UHF mode."""
    return ModemConfig()


def config_1200() -> ModemConfig:
    """1200 baud 10 m band mode: 8 samples per symbol, 64-symbol frames,
    received on the composed path (channel-major front-end)."""
    return ModemConfig(rs=1200.0)


def config_parity() -> ModemConfig:
    """Bit/behaviour parity with the C reference: histogram timing, the
    sequential NCO, the exact FIR, cold-start Costas, the rotate-45
    slicer."""
    return ModemConfig(timing_mode="histogram", nco_mode="exact",
                       acquisition="none", slicer="reference",
                       fir_precision="exact")
