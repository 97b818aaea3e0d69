"""The port's public surface against the JAX package's.

(a) Every module of ``qpsk_tpu`` has a twin in ``qpsk_tpu_torch`` at the
    same path, and every public name of the JAX module (its ``__all__``,
    else each name not starting with "_" that is not a module, nor a
    class or function of another package) exists in the twin; every
    keyword option of a JAX function (a parameter with a default) is a
    parameter of the port's.  The written allow-list below holds the
    deliberate differences: the Pallas kernel modules (the port's kernels
    are ``qpsk_tpu_torch.ops.cuda``), the native IO library, the TPU's
    constants, the JAX-only options ``unroll=`` (scan unrolling) and
    ``precision=`` (XLA's matmul precision; the port's ``fir_block`` takes
    ``exact=``).  Since the scale-out modules (``parallel.channels``,
    ``.stream``, ``.multihost``) and records (``benchmarks.
    scaling_efficiency``, ``sp_bound_record``, ``sp_scaling_decomposition``)
    have been ported, the list holds nothing else.  A JAX ``key``
    argument is positional, a ``torch.Generator`` in the port, so (a)
    does not compare it.
(b) The names the port once lacked, each held against JAX on the same
    inputs: ``config.ROTATE45``; ``ops.modmap``'s ``TAU``, ``ROTATE45``,
    ``CONSTELLATION``, ``mod_symbols``; ``packet.bits_to_dibits`` /
    ``dibits_to_bits``; ``utils.save_state`` / ``load_state``;
    ``ops.timing.cabs2``; the complex helpers of ``ops.cplx``;
    ``channel.multipath_pcm(pcm_scale=)``.
"""

import importlib
import inspect
import pkgutil
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import qpsk_tpu
import qpsk_tpu.ops.cplx as jc
import qpsk_tpu_torch.ops.cplx as tc
from qpsk_tpu_torch.ops.cplx import CF32

# JAX module -> why the port has no twin
MISSING_MODULES = {
    **{f"qpsk_tpu.ops.pallas{s}": "a Pallas TPU kernel module; the port's "
       "CUDA kernels are qpsk_tpu_torch.ops.cuda"
       for s in ("", ".costas_kernel", ".frontend_kernel", ".ldpc_kernel",
                 ".tx_kernel", ".viterbi_kernel")},
    "qpsk_tpu.io.libqpsk_io": "the native IO library, not a Python module "
    "(the port builds its own, qpsk_tpu_torch/io/qpsk_io.cc)",
}
# (JAX module, name) -> why the port has no such name
MISSING_NAMES = {
    **{("qpsk_tpu.utils.roofline", n): "a TPU v5e constant; the port's "
       "roofline holds the H100's" for n in ("PEAK_MATMUL_FLOPS",
                                             "PEAK_HBM_BPS", "V5E_CLOCK_HZ")},
}
# keyword options of the JAX functions that the port does not take
JAX_ONLY_OPTIONS = {"unroll": "lax.scan unrolling",
                    "precision": "XLA's matmul precision (fir_block takes "
                    "exact=)"}


def _public(mod) -> dict:
    names = getattr(mod, "__all__", None)
    out = {}
    for n in (names if names is not None else dir(mod)):
        if n.startswith("_"):
            continue
        obj = getattr(mod, n)
        if isinstance(obj, types.ModuleType):
            continue
        if inspect.isclass(obj) or inspect.isroutine(obj):
            if not getattr(obj, "__module__", "").startswith("qpsk_tpu"):
                continue
        elif type(obj).__module__ in ("typing", "__future__"):
            continue
        out[n] = obj
    return out


def _jax_modules() -> list:
    return sorted(info.name for info in pkgutil.walk_packages(
        qpsk_tpu.__path__, "qpsk_tpu.")
        if not info.name.endswith("__main__"))


def test_every_public_name_has_a_twin():
    missing, options = [], []
    for name in _jax_modules():
        if name in MISSING_MODULES:
            continue
        jm = importlib.import_module(name)
        tm = importlib.import_module("qpsk_tpu_torch" + name[len("qpsk_tpu"):])
        jp, tp = _public(jm), _public(tm)
        missing += [(name, n) for n in sorted(set(jp) - set(tp))
                    if (name, n) not in MISSING_NAMES]
        for n in sorted(set(jp) & set(tp)):
            if not (inspect.isfunction(jp[n]) and callable(tp[n])):
                continue
            jsig = inspect.signature(jp[n]).parameters
            tsig = inspect.signature(tp[n]).parameters
            options += [(name, n, p) for p, v in jsig.items()
                        if v.default is not inspect.Parameter.empty
                        and p not in tsig and p not in JAX_ONLY_OPTIONS]
    assert not missing, missing
    assert not options, options


def test_allow_list_is_current():
    """Every allow-listed module or name is still missing from the port
    (a port that gains one must leave the list)."""
    for name in MISSING_MODULES:
        with pytest.raises(ImportError):
            importlib.import_module("qpsk_tpu_torch" + name[len("qpsk_tpu"):])
    for mod, n in MISSING_NAMES:
        tm = importlib.import_module("qpsk_tpu_torch" + mod[len("qpsk_tpu"):])
        assert not hasattr(tm, n), (mod, n)


def test_constants_match_jax():
    import qpsk_tpu.config as jcfg
    import qpsk_tpu.ops.modmap as jmm
    import qpsk_tpu_torch.config as tcfg
    import qpsk_tpu_torch.ops.modmap as tmm
    assert tcfg.ROTATE45 == jcfg.ROTATE45 and tcfg.TAU == jcfg.TAU
    assert tmm.TAU == jmm.TAU and tmm.ROTATE45 == jmm.ROTATE45
    np.testing.assert_array_equal(tmm.CONSTELLATION, jmm.CONSTELLATION)
    assert tmm.CONSTELLATION.dtype == jmm.CONSTELLATION.dtype
    idx = np.random.default_rng(0).integers(0, 4, (3, 17))
    got, want = tmm.mod_symbols(torch.from_numpy(idx)), jmm.mod_symbols(
        jnp.asarray(idx))
    np.testing.assert_array_equal(got.re.numpy(), np.asarray(want.re))
    np.testing.assert_array_equal(got.im.numpy(), np.asarray(want.im))


def test_dibits_match_jax():
    import qpsk_tpu.packet as jp
    import qpsk_tpu_torch.packet as tp
    from qpsk_tpu_torch.packet import bits as tbits
    assert tp.bits_to_dibits is tbits.bits_to_dibits
    assert tp.dibits_to_bits is tbits.dibits_to_bits
    bits = np.random.default_rng(1).integers(0, 2, (4, 38), dtype=np.int32)
    d = tp.bits_to_dibits(torch.from_numpy(bits))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jp.bits_to_dibits(bits)))
    back = tp.dibits_to_bits(d)
    np.testing.assert_array_equal(back.numpy(), bits)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jp.dibits_to_bits(np.asarray(d.numpy()))))
    assert back.dtype == torch.int32


def test_utils_reexports_checkpoint(tmp_path):
    import qpsk_tpu_torch.utils as tu
    from qpsk_tpu_torch import ModemConfig, rx_init
    from qpsk_tpu_torch.utils import checkpoint
    assert tu.save_state is checkpoint.save_state
    assert tu.load_state is checkpoint.load_state
    st = rx_init(ModemConfig(), (2,), acq_freq=0.25, device="cpu")
    tu.save_state(str(tmp_path / "s.npz"), st)
    back = tu.load_state(str(tmp_path / "s.npz"),
                         rx_init(ModemConfig(), (2,), device="cpu"))
    assert torch.equal(back.costas.freq, st.costas.freq)


def _pair(rng, shape):
    re, im = (rng.standard_normal(shape).astype(np.float32) for _ in "ri")
    return (CF32(torch.from_numpy(re), torch.from_numpy(im)),
            jc.CF32(jnp.asarray(re), jnp.asarray(im)))


def _same(got, want, exact=True):
    if isinstance(want, jc.CF32):
        _same(got.re, want.re, exact)
        _same(got.im, want.im, exact)
        return
    g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    if exact:
        np.testing.assert_array_equal(g, np.asarray(want))
    else:
        np.testing.assert_allclose(g, np.asarray(want), rtol=2e-6, atol=2e-6)


def test_timing_cabs2_matches_jax():
    import qpsk_tpu.ops.timing as jt
    import qpsk_tpu_torch.ops.timing as tt
    a, ja = _pair(np.random.default_rng(2), (3, 8))
    _same(tt.cabs2(a), jt.cabs2(ja))


def test_cplx_helpers_match_jax():
    rng = np.random.default_rng(3)
    (a, ja), (b, jb) = _pair(rng, (2, 3, 4)), _pair(rng, (2, 3, 4))
    theta = rng.uniform(-4, 4, (5,)).astype(np.float32)
    idx = np.asarray([2, 0, 3])
    idx_along = rng.integers(0, 4, (2, 3, 2))
    pred = rng.integers(0, 2, (2, 3, 4)).astype(bool)
    z = (rng.standard_normal(6) + 1j * rng.standard_normal(6)).astype(
        np.complex64)
    cases = {
        "cadd": ((a, b), (ja, jb)), "csub": ((a, b), (ja, jb)),
        "cmul_conj": ((a, b), (ja, jb)), "cscale": ((a, 1.5), (ja, 1.5)),
        "cconj": ((a,), (ja,)), "cneg": ((a,), (ja,)),
        "cabs2": ((a,), (ja,)), "cabs": ((a,), (ja,)),
        "cangle": ((a,), (ja,)),
        "cstack": (([a, b], 1), ([ja, jb], 1)),
        "cconcat": (([a, b], -1), ([ja, jb], -1)),
        "ctake": ((a, torch.from_numpy(idx), -1), (ja, jnp.asarray(idx), -1)),
        "ctake_along_axis": ((a, torch.from_numpy(idx_along), -1),
                             (ja, jnp.asarray(idx_along), -1)),
        "cmoveaxis": ((a, 0, -1), (ja, 0, -1)),
        "creshape": ((a, (6, 4)), (ja, (6, 4))),
        "cslice_last": ((a, 1, 3), (ja, 1, 3)),
        "cwhere": ((torch.from_numpy(pred), a, b), (jnp.asarray(pred), ja, jb)),
        "cbroadcast_to": ((CF32(a.re[0], a.im[0]), (5, 3, 4)),
                          (jc.CF32(ja.re[0], ja.im[0]), (5, 3, 4))),
        "cones": (((2, 3),), ((2, 3),)), "cfull": (((2, 3), 0.5 - 2j),
                                                   ((2, 3), 0.5 - 2j)),
        "from_parts": ((a.re.numpy(), a.im.numpy()),
                       (ja.re, ja.im)),
        "from_real": ((a.re.numpy(),), (ja.re,)),
        "from_complex": ((z,), (z,)),
    }
    for name, (targs, jargs) in cases.items():
        _same(getattr(tc, name)(*targs), getattr(jc, name)(*jargs),
              exact=name not in ("cabs", "cangle")), name
    _same(tc.cexp(torch.from_numpy(theta)), jc.cexp(jnp.asarray(theta)),
          exact=False)
    np.testing.assert_array_equal(tc.to_complex(a), jc.to_complex(ja))
    assert tc.to_complex(a).dtype == jc.to_complex(ja).dtype
    assert a.ndim == ja.ndim == 3
    assert len(cases) + 2 == 25


def test_multipath_pcm_scale_keyword_matches_jax():
    from qpsk_tpu.channel import multipath_pcm as jmp
    from qpsk_tpu_torch.channel import multipath_pcm as tmp
    pcm = np.random.default_rng(4).integers(-9000, 9000, (2, 300),
                                            dtype=np.int16)
    paths = ((0, 1.0), (4, 0.5))
    got = tmp(torch.from_numpy(pcm), paths, pcm_scale=8192.0)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jmp(pcm, paths, pcm_scale=8192.0)))
