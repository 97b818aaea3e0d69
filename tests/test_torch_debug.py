"""The port's debug taps (``qpsk_tpu_torch.utils.debug``), the JAX suite's
tests of ``qpsk_tpu.utils.debug`` (``tests/test_utils.py``) on CPU
tensors: the eager finite check, the deferred one (``checkify`` +
``assert_finite``, raising only at ``throw()``), the scatter tap against
JAX's on the same symbols, and a ``torch.profiler`` trace written to a
directory."""

import glob
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from qpsk_tpu.ops.cplx import CF32 as JCF32
from qpsk_tpu.utils.debug import ScatterTap as JScatterTap
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.state import rx_init
from qpsk_tpu_torch import ModemConfig
from qpsk_tpu_torch.utils.debug import (ScatterTap, assert_finite, checkify,
                                        eager_assert_finite, trace)


def test_eager_assert_finite():
    eager_assert_finite({"a": torch.ones(3)})
    eager_assert_finite(rx_init(ModemConfig(), (2,), device="cpu"))
    with pytest.raises(FloatingPointError, match=r"x\[leaf 1\]"):
        eager_assert_finite((torch.ones(2), torch.tensor([1.0, np.nan])),
                            "x")


def test_checkify_assert_finite():
    def fn(x):
        assert_finite(x, "x")
        return x * 2

    err, out = checkify(fn)(torch.ones(4))
    err.throw()  # no error
    assert torch.equal(out, torch.full((4,), 2.0))
    err, out = checkify(fn)(torch.tensor([1.0, float("inf")]))
    with pytest.raises(FloatingPointError):
        err.throw()
    # outside checkify the returned error carries the flags; ints are not
    # checked
    err = assert_finite(CF32(torch.zeros(3), torch.tensor([0.0, np.nan, 1.0])),
                        "sym")
    with pytest.raises(FloatingPointError, match=r"sym\[leaf 1\]"):
        err.throw()
    assert_finite({"n": torch.arange(3)}).throw()


def test_scatter_tap_matches_jax():
    rng = np.random.default_rng(5)
    re, im = (rng.standard_normal((2, 8)).astype(np.float32) for _ in range(2))
    tap = ScatterTap()

    def fn(z):
        tap.tap(z)
        return z.re + z.im

    fn(CF32(torch.from_numpy(re), torch.from_numpy(im)))
    pts = tap.as_array()
    assert pts.shape == (16, 2)

    jtap = JScatterTap()

    @jax.jit
    def jfn(z):
        jtap.tap(z)
        return z.re + z.im

    jfn(JCF32(jnp.asarray(re), jnp.asarray(im))).block_until_ready()
    np.testing.assert_array_equal(pts, jtap.as_array())
    assert ScatterTap().as_array().shape == (0, 2)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        x = torch.ones(64)
        (x * 3.0).sum()
    files = glob.glob(str(tmp_path / "tr" / "trace-*.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mul" in e.get("name", "") for e in events)
