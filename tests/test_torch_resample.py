"""The port's rational resampler (``qpsk_tpu_torch.ops.resample``) against
the JAX package's (``qpsk_tpu.ops.resample``) on the same numpy-seeded
inputs, on CPU tensors: the host tables (ratio, float64 prototype,
polyphase matrix) equal, ``resample_stream`` within 1e-4 relative at the
sound-card ratios, chunked calls within float32 rounding of one call
(chunks shorter than the carried history included), ``resample_pcm``
within 1 LSB, and the same refusals."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpsk_tpu.ops import resample as jr
from qpsk_tpu_torch.ops import resample as tr

torch.set_num_threads(2)

RATIOS = [(5, 1), (1, 5), (147, 32), (32, 147)]


@pytest.mark.parametrize("fs_in,fs_out", [
    (9600, 48000), (48000, 9600), (44100, 9600), (9600, 44100),
    (9600, 8000), (8000, 9600), (9600, 9600)])
def test_rational_ratio_matches_jax(fs_in, fs_out):
    assert tr.rational_ratio(fs_in, fs_out) == jr.rational_ratio(fs_in,
                                                                 fs_out)


@pytest.mark.parametrize("l,m", RATIOS)
def test_tables_equal_jax(l, m):
    np.testing.assert_array_equal(tr.resampler_taps(l, m),
                                  jr.resampler_taps(l, m))
    assert tr.resampler_taps(l, m).dtype == np.float64
    g, q = tr._poly_matrix(l, m, 16, 8.0)
    jg, jq = jr._poly_matrix(l, m, 16, 8.0)
    assert q == jq and g.dtype == np.float32
    np.testing.assert_array_equal(g, jg)
    st = tr.resample_init(l, m, batch_shape=(3,), device="cpu")
    assert tuple(st.shape) == tuple(jr.resample_init(l, m, batch_shape=(3,))
                                    .shape)
    assert st.dtype == torch.float32 and not st.any()


@pytest.mark.parametrize("l,m", RATIOS)
def test_resample_stream_matches_jax(l, m):
    """Two chained calls on (2, n) with a carried state from random
    history: the outputs and the new states within 1e-4 relative."""
    rng = np.random.default_rng(l * 1000 + m)
    _, q = tr._poly_matrix(l, m, 16, 8.0)
    x = rng.normal(0, 3000, (2, 2 * 5 * 147 * 32)).astype(np.float32)
    st = rng.normal(0, 3000, (2, q * m)).astype(np.float32)
    half = x.shape[1] // 2
    js, ts = jnp.asarray(st), torch.from_numpy(st)
    for part in (x[:, :half], x[:, half:]):
        jy, js = jr.resample_stream(jnp.asarray(part), js, l, m)
        ty, ts = tr.resample_stream(torch.from_numpy(part), ts, l, m)
        jy = np.asarray(jy)
        scale = np.abs(jy).max()
        np.testing.assert_allclose(ty.numpy(), jy, rtol=1e-4,
                                   atol=1e-4 * scale)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    one = tr.resample(torch.from_numpy(x), l, m).numpy()
    jone = np.asarray(jr.resample(jnp.asarray(x), l, m))
    np.testing.assert_allclose(one, jone, rtol=1e-4,
                               atol=1e-4 * np.abs(jone).max())


@pytest.mark.parametrize("l,m", RATIOS)
def test_chunked_equals_one_shot(l, m):
    """Chunked calls chain with one call to float32 rounding: whole
    multiples of M of many sizes, then single-group chunks, shorter than
    the carried history Q*M (the new state is the tail of [state | chunk],
    not of the chunk alone)."""
    rng = np.random.default_rng(7 + l + m)
    _, q = tr._poly_matrix(l, m, 16, 8.0)
    x = torch.from_numpy(rng.normal(0, 1, (40 * m + q * m,))
                         .astype(np.float32))
    one = tr.resample(x, l, m)
    st = tr.resample_init(l, m, device="cpu")
    sizes = [m] * 6 + [3 * m, 17 * m] + [m] * 4
    outs, pos = [], 0
    for s in sizes + [x.numel()]:
        take = min(s, x.numel() - pos)
        if take == 0:
            break
        y, st = tr.resample_stream(x[pos:pos + take], st, l, m)
        outs.append(y)
        pos += take
    assert pos == x.numel()
    torch.testing.assert_close(torch.cat(outs), one, rtol=2e-7, atol=1e-6)


@pytest.mark.parametrize("fs_in,fs_out", [(9600, 48000), (48000, 9600),
                                          (44100, 9600), (9600, 44100)])
def test_resample_pcm_within_one_lsb_of_jax(fs_in, fs_out):
    """int16 PCM of a length M does not divide (the tail padded): the port
    within 1 LSB of JAX, of the same length."""
    rng = np.random.default_rng(fs_in + fs_out)
    n = fs_in // 4 + 3
    pcm = np.clip(rng.normal(0, 6000, n), -32768, 32767).astype(np.int16)
    got = tr.resample_pcm(torch.from_numpy(pcm), fs_in, fs_out).numpy()
    want = np.asarray(jr.resample_pcm(jnp.asarray(pcm), fs_in, fs_out))
    assert got.dtype == np.int16 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want).max() <= 1


def test_refusals_match_jax():
    """A length that M does not divide and a ratio that is not a small
    rational raise the JAX package's ValueError, message and all."""
    x = np.zeros(7, np.float32)
    with pytest.raises(ValueError) as je:
        jr.resample_stream(jnp.asarray(x), jr.resample_init(1, 5), 1, 5)
    with pytest.raises(ValueError) as te:
        tr.resample_stream(torch.from_numpy(x),
                           tr.resample_init(1, 5, device="cpu"), 1, 5)
    assert str(te.value) == str(je.value)
    assert "multiple of M=5" in str(te.value)
    with pytest.raises(ValueError) as je:
        jr.rational_ratio(9600, 7777.77)
    with pytest.raises(ValueError) as te:
        tr.rational_ratio(9600, 7777.77)
    assert str(te.value) == str(je.value)


def test_tables_cached_by_device():
    """The float32 polyphase matrix is copied to a device once: repeated
    calls on one device reuse the same tensor."""
    a = tr._poly_on(5, 1, 16, 8.0, torch.device("cpu"))
    b = tr._poly_on(5, 1, 16, 8.0, torch.device("cpu"))
    assert a is b
    np.testing.assert_array_equal(a.numpy(), tr._poly_matrix(5, 1, 16,
                                                              8.0)[0])
