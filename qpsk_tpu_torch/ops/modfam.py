"""Generic linear-modulation family: BPSK, 8PSK, 16QAM (port of
``qpsk_tpu.ops.modfam``).

QPSK keeps its own mapping and slicer (``ops/modmap.py``); this module
carries the rest of the family through the same frame, packet and sync
stack.

* Constellations are unit average power and Gray-labelled; bits serialize
  MSB-first per symbol (``label = sum(bits[i] << (bps-1-i))``).
* The decision-directed carrier loop leaves an ``n_rot``-fold phase
  ambiguity; ``rot_labels[r]`` maps a decided label to the TX label under
  hypothesis ``r``, resolved by the CRC-scored sync hunt (``sync.py``).
* Soft output is max-log LLRs (positive = bit 0) off one ``(..., n, M)``
  score matrix, relabelled per rotation hypothesis.
* ``dd_err_ops`` is the loop's detector and slicer: boundary-exact
  comparisons pick float32 constants from ``dd_constants``, and the error
  is ``(im*cr - re*ci) * ic2`` with each product rounded on its own.
  Eager PyTorch rounds every operation, so this plain program and the
  Costas kernel's dd mode (``csrc/costas.cu``), which pins the same
  operations, give the same bits on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qpsk_tpu_torch import tracing
from qpsk_tpu_torch.ops.cplx import CF32


class Modulation(NamedTuple):
    """One constellation: Gray-labelled points and its ambiguity group.
    ``rot_labels[r][k]`` is the TX label of decided label ``k`` when the
    lock sits ``r`` steps of ``tau/n_rot`` from the TX constellation."""
    name: str
    bps: int                 # bits per symbol
    points_re: np.ndarray    # (M,) float32, indexed by Gray label
    points_im: np.ndarray    # (M,)
    n_rot: int               # rotational symmetry (ambiguity) order
    rot_labels: np.ndarray   # (n_rot, M) int32 relabelling per hypothesis

    @property
    def M(self) -> int:
        return 1 << self.bps


def _nearest_label(pre: np.ndarray, pim: np.ndarray, re: float,
                   im: float) -> int:
    return int(np.argmin((pre - re) ** 2 + (pim - im) ** 2))


def _build(name: str, bps: int, pre: np.ndarray, pim: np.ndarray,
           n_rot: int) -> Modulation:
    m = 1 << bps
    if pre.shape != (m,) or pim.shape != (m,):
        raise ValueError(f"{name}: {m} points expected")
    step = 2.0 * np.pi / n_rot
    c, s = np.cos(step), np.sin(step)
    # perm[k] = label decided when TX label k arrives rotated one step CCW
    perm = np.array([_nearest_label(pre, pim, c * pre[k] - s * pim[k],
                                    s * pre[k] + c * pim[k])
                     for k in range(m)], dtype=np.int32)
    if sorted(perm.tolist()) != list(range(m)):
        raise ValueError(f"{name}: not invariant under its ambiguity step")
    inv = np.argsort(perm).astype(np.int32)   # TX label from decided label
    rot = [np.arange(m, dtype=np.int32)]
    for _ in range(n_rot - 1):
        rot.append(inv[rot[-1]])
    return Modulation(name=name, bps=bps, points_re=pre.astype(np.float32),
                      points_im=pim.astype(np.float32), n_rot=n_rot,
                      rot_labels=np.stack(rot))


def _make_bpsk() -> Modulation:
    return _build("bpsk", 1, np.array([1.0, -1.0]), np.zeros(2), 2)


def _make_8psk() -> Modulation:
    # circle position k at angle (2k+1)*pi/8 carries Gray label k ^ (k >> 1)
    k = np.arange(8)
    ang = (2 * k + 1) * np.pi / 8.0
    gray = k ^ (k >> 1)
    pre, pim = np.zeros(8), np.zeros(8)
    pre[gray] = np.cos(ang)
    pim[gray] = np.sin(ang)
    return _build("8psk", 3, pre, pim, 8)


def _make_16qam() -> Modulation:
    # levels [-3, -1, +1, +3]/sqrt(10) carry axis labels [0, 1, 3, 2];
    # label = (gray_I << 2) | gray_Q
    lev = np.array([-3.0, -1.0, 1.0, 3.0]) / np.sqrt(10.0)
    gray2 = np.array([0, 1, 3, 2])
    pre, pim = np.zeros(16), np.zeros(16)
    for i in range(4):
        for q in range(4):
            lab = (gray2[i] << 2) | gray2[q]
            pre[lab] = lev[i]
            pim[lab] = lev[q]
    return _build("16qam", 4, pre, pim, 4)


MODULATIONS: dict[str, Modulation] = {
    m.name: m for m in (_make_bpsk(), _make_8psk(), _make_16qam())}

# The acquisition's modulation-strip power (``ops/acquire.py``): z^power
# leaves a spectral line at power * offset.
ACQUIRE_POWER = {"bpsk": 2, "qpsk": 4, "8psk": 8, "16qam": 4}


def get(name: str) -> Modulation:
    try:
        return MODULATIONS[name]
    except KeyError:
        raise ValueError(f"unknown modulation {name!r} "
                         f"(generic family: {sorted(MODULATIONS)})") from None


def _table(values: np.ndarray, device) -> torch.Tensor:
    tracing.count("sync.modfam.table")
    return torch.from_numpy(np.ascontiguousarray(values)).to(device)


# --- mapping (TX) ----------------------------------------------------------

def bits_to_labels(bits: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """(..., bps*n) bits -> (..., n) int32 labels, MSB-first per symbol."""
    if bits.shape[-1] % mod.bps:
        raise ValueError(f"{bits.shape[-1]} bits do not divide into "
                         f"{mod.bps}-bit symbols")
    g = bits.to(torch.int32).reshape(bits.shape[:-1] + (-1, mod.bps))
    lab = torch.zeros(g.shape[:-1], dtype=torch.int32, device=bits.device)
    for i in range(mod.bps):
        lab = (lab << 1) | g[..., i]
    return lab


def labels_to_bits(labels: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """(..., n) labels -> (..., bps*n) int32 bits, MSB-first per symbol."""
    lab = labels.to(torch.int32)
    bits = torch.stack([(lab >> (mod.bps - 1 - i)) & 1
                        for i in range(mod.bps)], dim=-1)
    return bits.reshape(lab.shape[:-1] + (lab.shape[-1] * mod.bps,))


def labels_to_symbols(labels: torch.Tensor, mod: Modulation) -> CF32:
    """Constellation lookup of (..., n) labels."""
    idx = labels.to(torch.int64)
    return CF32(_table(mod.points_re, labels.device)[idx],
                _table(mod.points_im, labels.device)[idx])


def bits_to_symbols_mod(bits: torch.Tensor, mod: Modulation) -> CF32:
    """(..., bps*n) bits -> (..., n) unit-average-power symbols."""
    return labels_to_symbols(bits_to_labels(bits, mod), mod)


# --- slicing (RX) ----------------------------------------------------------

def symbol_scores(sym: CF32, mod: Modulation, scale=1.0) -> torch.Tensor:
    """(..., n) symbols -> (..., n, M) nearest-point scores
    ``2*(z . s*c_k) - |s*c_k|^2 = |z|^2 - |z - s*c_k|^2``: the argmax is
    the minimum-distance decision, and score differences are max-log LLR
    terms."""
    s = np.float32(scale)
    dev = sym.re.device
    cre = _table(mod.points_re * s, dev)
    cim = _table(mod.points_im * s, dev)
    return (2.0 * (sym.re[..., None] * cre + sym.im[..., None] * cim)
            - (cre * cre + cim * cim))


def slice_labels(sym: CF32, mod: Modulation, scale=1.0) -> torch.Tensor:
    """Minimum-distance decisions by score argmax: (..., n) int32 labels."""
    return torch.argmax(symbol_scores(sym, mod, scale), dim=-1).to(torch.int32)


def demod_bits_mod(sym: CF32, mod: Modulation, scale=1.0,
                   rotation: int = 0) -> torch.Tensor:
    """(..., n) symbols -> (..., bps*n) hard bits (score argmax) under
    rotation hypothesis ``rotation``."""
    lab = slice_labels(sym, mod, scale)
    if rotation:
        lab = _table(mod.rot_labels[rotation], lab.device)[lab.to(torch.int64)]
    return labels_to_bits(lab, mod)


def rotate_bits_mod(bits: torch.Tensor, r, mod: Modulation) -> torch.Tensor:
    """Re-slice a symbol-aligned bit stream (..., bps*n) under rotation
    hypothesis ``r`` (an int or an integer scalar tensor)."""
    lab = bits_to_labels(bits, mod).to(torch.int64)
    perm = _table(mod.rot_labels, bits.device)[r]
    return labels_to_bits(perm[lab], mod)


# --- soft output -----------------------------------------------------------

def _bit_masks(mod: Modulation, rotation: int) -> np.ndarray:
    """(M, bps) float32: bit b (MSB-first) of the TX label hypothesis for
    decided label k under ``rotation``."""
    lab = mod.rot_labels[rotation]
    return np.stack([(lab >> (mod.bps - 1 - b)) & 1
                     for b in range(mod.bps)], axis=-1).astype(np.float32)


_BIG = float(np.float32(1e30))


def soft_from_scores(scores: torch.Tensor, mod: Modulation,
                     rotation: int = 0) -> torch.Tensor:
    """(..., n, M) scores -> (..., bps*n) max-log LLRs (positive = bit 0)
    under ``rotation``: ``max_{bit=0} score - max_{bit=1} score``."""
    masks = _table(_bit_masks(mod, rotation), scores.device)   # (M, bps)
    s = scores[..., None]                                      # (..., n, M, 1)
    llr = (torch.amax(s - masks * _BIG, dim=-2)
           - torch.amax(s - (1.0 - masks) * _BIG, dim=-2))     # (..., n, bps)
    return llr.reshape(scores.shape[:-2] + (scores.shape[-2] * mod.bps,))


def demod_soft_mod(sym: CF32, mod: Modulation, scale=1.0,
                   rotation: int = 0) -> torch.Tensor:
    """(..., n) symbols -> (..., bps*n) max-log LLRs (positive = bit 0)."""
    return soft_from_scores(symbol_scores(sym, mod, scale), mod, rotation)


# --- the decision-directed detector ---------------------------------------

def dd_constants(mod: Modulation, scale=1.0) -> np.ndarray:
    """The detector's float32 constants, read alike by ``dd_err_ops`` and
    the Costas kernel's dd mode: ``[cre(M), cim(M), 1/|c|^2(M)]``, then
    for 16QAM the axis decision threshold ``2/sqrt(10) * scale``.  The
    inverse |c|^2 is precomputed so both sides multiply."""
    s = float(scale)
    cre = (mod.points_re * np.float32(s)).astype(np.float32)
    cim = (mod.points_im * np.float32(s)).astype(np.float32)
    ip2 = (np.float32(1.0)
           / ((mod.points_re ** 2 + mod.points_im ** 2)
              * np.float32(s * s) + np.float32(1e-12))).astype(np.float32)
    extras = []
    if mod.name == "16qam":
        extras = [np.float32(np.float32(2.0 / np.sqrt(10.0)) * np.float32(s))]
    return np.concatenate([cre, cim, ip2, np.asarray(extras, np.float32)])


def dd_err_ops(name: str, m: int, outr: torch.Tensor, outi: torch.Tensor,
               get, want_label: bool = False):
    """The per-step decision-directed error of derotated symbols
    ``(outr, outi)``, and with ``want_label`` the decided Gray label
    (int32).  ``get(i)`` is the i-th ``dd_constants`` value as a float.

    Decisions are exact comparisons only (BPSK: sign; 8PSK: sign(re),
    sign(im), |im| > |re|; 16QAM: per-axis sign and |x| > threshold), so
    they do not depend on how a compiler rounds.  The selected constants
    give ``err = (outi*cr - outr*ci) * ic2``, each product rounded on its
    own, which ``csrc/costas.cu`` repeats with round-to-nearest
    intrinsics."""
    def pick(cond, a: int, b: int):
        return torch.where(cond, get(a), get(b))

    def ret(err, lab):
        return (err, lab.to(torch.int32)) if want_label else err

    if name == "bpsk":
        neg = outr < 0.0
        u, v = outi * pick(neg, 1, 0), outr * 0.0
        return ret((u - v) * get(2 * m), neg)
    if name == "8psk":
        s_im, s_re = outi < 0.0, outr < 0.0
        diag = torch.abs(outi) > torch.abs(outr)

        def tree(base):
            return torch.where(
                s_im,
                torch.where(s_re, pick(diag, base + 7, base + 6),
                            pick(diag, base + 5, base + 4)),
                torch.where(s_re, pick(diag, base + 3, base + 2),
                            pick(diag, base + 1, base + 0)))
        u, v = outi * tree(0), outr * tree(m)
        lab = ((s_im.to(torch.int32) << 2) | (s_re.to(torch.int32) << 1)
               | diag.to(torch.int32)) if want_label else None
        return ret((u - v) * get(2 * m), lab)
    if name == "16qam":
        thr = get(3 * m)
        neg_i, far_i = outr < 0.0, torch.abs(outr) > thr
        neg_q, far_q = outi < 0.0, torch.abs(outi) > thr
        # level -> Gray axis label: -3 -> 0, -1 -> 1, +1 -> 3, +3 -> 2
        cr = torch.where(neg_i, pick(far_i, 0 << 2, 1 << 2),
                         pick(far_i, 2 << 2, 3 << 2))
        ci = torch.where(neg_q, pick(far_q, m + 0, m + 1),
                         pick(far_q, m + 2, m + 3))
        ic2 = torch.where(far_i, pick(far_q, 2 * m + 0, 2 * m + 1),
                          pick(far_q, 2 * m + 4, 2 * m + 5))
        lab = None
        if want_label:
            def axis(neg, far):
                return torch.where(neg, torch.where(far, 0, 1),
                                   torch.where(far, 2, 3))
            lab = (axis(neg_i, far_i) << 2) | axis(neg_q, far_q)
        u, v = outi * cr, outr * ci
        return ret((u - v) * ic2, lab)
    raise ValueError(f"no decision program for modulation {name!r}")


def _getter(consts: np.ndarray):
    vals = [float(v) for v in consts]
    return vals.__getitem__


def slice_labels_cmp(sym: CF32, mod: Modulation, scale=1.0) -> torch.Tensor:
    """Decisions by the comparison program (``dd_err_ops``): the labels
    the loop itself decides, and that the kernel packs.  The same regions
    as ``slice_labels``; the two can differ only on exact ties."""
    _, lab = dd_err_ops(mod.name, mod.M, sym.re, sym.im,
                        _getter(dd_constants(mod, scale)), want_label=True)
    return lab


def demod_bits_cmp(sym: CF32, mod: Modulation, scale=1.0,
                   rotation: int = 0) -> torch.Tensor:
    """Hard bits by the comparison program (the modem's receive slicer)."""
    lab = slice_labels_cmp(sym, mod, scale)
    if rotation:
        lab = _table(mod.rot_labels[rotation], lab.device)[lab.to(torch.int64)]
    return labels_to_bits(lab, mod)


def dd_detector(mod: Modulation, scale=1.0):
    """The decision-directed phase detector for ``costas_run_traced``:
    ``err = Im(z * conj(c)) / |c|^2`` with ``c`` the decided point of the
    constellation scaled by ``scale`` (the AGC target; only 16QAM's
    decisions depend on it)."""
    get = _getter(dd_constants(mod, scale))

    def detector(z: CF32) -> torch.Tensor:
        return dd_err_ops(mod.name, mod.M, z.re, z.im, get)
    return detector


# --- metrics ---------------------------------------------------------------

def evm_mod(sym: CF32, mod: Modulation, normalize: bool = True):
    """RMS error against the nearest constellation point over the last
    axis; with ``normalize`` the cloud is first scaled to unit RMS."""
    p = torch.mean(sym.re ** 2 + sym.im ** 2, dim=-1)
    if normalize:
        sc = torch.where(p > 0, 1.0 / torch.sqrt(p), 1.0)[..., None]
    else:
        sc = 1.0
    z = CF32(sym.re * sc, sym.im * sc)
    ideal = labels_to_symbols(slice_labels(z, mod, scale=1.0), mod)
    err2 = (z.re - ideal.re) ** 2 + (z.im - ideal.im) ** 2
    return torch.sqrt(torch.mean(err2, dim=-1))
