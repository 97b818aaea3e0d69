"""The torch port's uncoded QPSK slice as a whole:

(a) the same PCM (JAX TX + numpy AWGN) through JAX ``rx_stream`` and the
    port's ``rx_stream``: equal timing decisions and bits, frequency
    readback within 0.05 Hz;
(b) a torch-only loopback: packets -> ``tx_stream`` at +50 Hz -> ``awgn_pcm``
    at 10 dB -> ``rx_stream`` -> ``find_sync`` -> ``extract_packets``;
(c) the package imports no jax and nothing of the JAX package;
(d) the modes and options that were once off the port run and match JAX
    on the same PCM, and inputs of the wrong shape raise;
(e) the geometries the kernels were widened to (2, 3 and 16 samples per
    symbol, 63 taps, 256- to 4096-sample frames, the AGC power output at
    384 symbols a frame) run their plain versions on CPU tensors and match
    JAX, and the kernels' gates pass them; past the kernels' coverage the
    gate names the field.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from qpsk_tpu import ModemConfig as JCfg, rx_init as j_rx_init, tx_init as j_tx_init
from qpsk_tpu.modem import rx_stream as j_rx_stream, tx_stream as j_tx_stream
from qpsk_tpu.packet import PacketConfig as JPacketConfig, assemble_packet as j_assemble
from qpsk_tpu.sync import default_max_lag as j_default_max_lag, find_sync as j_find_sync
from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream, tx_init, tx_stream
from qpsk_tpu_torch.channel import awgn_pcm
from qpsk_tpu_torch.packet import PacketConfig, assemble_packet
from qpsk_tpu_torch.sync import default_max_lag, extract_packets, find_sync

torch.set_num_threads(2)

CFG, JC = ModemConfig(), JCfg()
PCFG = PacketConfig(payload_bytes=30)     # 256 channel bits = one RX frame
C, NFRAMES, SKIP = 2, 40, 8


def test_rx_stream_matches_jax():
    rng = np.random.default_rng(11)
    payload = rng.integers(0, 2, (C, NFRAMES, 240), dtype=np.int32)
    chan = np.asarray(j_assemble(JPacketConfig(payload_bytes=30), payload))
    _, pcm = j_tx_stream(JC, j_tx_init(JC, batch_shape=(C,)), chan,
                         tx_offset_hz=50.0)
    x = np.asarray(pcm).astype(np.float64)
    sigma = np.sqrt((x ** 2).mean() / 10.0)
    pcm = np.clip(np.round(x + rng.normal(size=x.shape) * sigma),
                  -32768, 32767).astype(np.int16)

    jst, jout = j_rx_stream(JC, j_rx_init(JC, batch_shape=(C,)), pcm)
    st, out = rx_stream(CFG, rx_init(CFG, (C,), device="cpu"), torch.from_numpy(pcm))
    assert out.bits.shape == (C, NFRAMES, 256) and out.bits.dtype == torch.int32
    np.testing.assert_array_equal(out.timing_index.numpy(),
                                  np.asarray(jout.timing_index))
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(jout.bits))
    np.testing.assert_allclose(out.freq_hz.numpy(), np.asarray(jout.freq_hz),
                               atol=0.05)
    np.testing.assert_allclose(out.symbols.re.numpy(),
                               np.asarray(jout.symbols.re), atol=1e-3)
    np.testing.assert_allclose(st.costas.freq.numpy(),
                               np.asarray(jst.costas.freq), atol=1e-4)
    # one stream without a channel axis gives the same decisions
    _, one = rx_stream(CFG, rx_init(CFG, device="cpu"), torch.from_numpy(pcm[1]))
    assert torch.equal(one.bits, out.bits[1])


def _recover(bits, payload):
    """Sync, extract, and check every packet against the TX payloads."""
    stream = bits.reshape(-1)[SKIP * PCFG.frame_bits:]
    sync = find_sync(PCFG, stream, max_lag=600, probe_frames=4)
    navail = (stream.numel() - int(sync.bit_lag)) // PCFG.frame_bits
    rx = extract_packets(PCFG, stream, sync, navail)
    got = rx.payload_bits
    k0 = next(k for k in range(NFRAMES) if torch.equal(got[0], payload[k]))
    return stream, sync, rx, k0


def test_torch_only_loopback():
    gen = torch.Generator().manual_seed(0)
    payload = torch.randint(0, 2, (C, NFRAMES, 240), generator=gen,
                            dtype=torch.int32)
    _, pcm = tx_stream(CFG, tx_init(CFG, (C,), device="cpu"), assemble_packet(PCFG, payload),
                       tx_offset_hz=50.0)
    power = float(((pcm.to(torch.float32) / 16384.0) ** 2).mean())
    _, out = rx_stream(CFG, rx_init(CFG, (C,), device="cpu"), awgn_pcm(gen, pcm, 10.0, power))
    for ch in range(C):
        offset = float(out.freq_hz[ch, NFRAMES // 2:].mean())
        assert abs(offset - 50.0) < 2.0, offset
        stream, sync, rx, k0 = _recover(out.bits[ch], payload[ch])
        assert int(sync.score) == 4
        assert bool(rx.crc_ok.all())
        n = rx.crc_ok.numel()
        assert n >= NFRAMES - SKIP - 2
        assert torch.equal(rx.payload_bits, payload[ch, k0:k0 + n])
        jsync = j_find_sync(JPacketConfig(payload_bytes=30),
                            jnp.asarray(stream.numpy()), max_lag=600,
                            probe_frames=4)
        assert (int(jsync.rotation), int(jsync.bit_lag), int(jsync.score)) \
            == (int(sync.rotation), int(sync.bit_lag), int(sync.score))
    for nbytes in (30, 400):
        assert default_max_lag(PacketConfig(payload_bytes=nbytes)) == \
            j_default_max_lag(JPacketConfig(payload_bytes=nbytes))


def test_package_imports_no_jax():
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            "import qpsk_tpu_torch, qpsk_tpu_torch.sync, qpsk_tpu_torch.channel\n"
            "import qpsk_tpu_torch.packet, qpsk_tpu_torch.ops.cuda._lib\n"
            "import qpsk_tpu_torch.metrics, qpsk_tpu_torch.ops.cuda.viterbi_kernel\n"
            "import qpsk_tpu_torch.ops.cuda.ldpc_kernel\n"
            "import qpsk_tpu_torch.ops.modfam, qpsk_tpu_torch.ops.acquire\n"
            "import qpsk_tpu_torch.ops.fft, qpsk_tpu_torch.modem\n"
            "new = set(sys.modules) - before\n"
            "bad = sorted(m for m in new if m.split('.')[0] in "
            "('jax', 'jaxlib', 'qpsk_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


_OFF_SLICE = [{"differential": True},
              {"timing_mode": "histogram"}, {"timing_mode": "fractional"},
              {"timing_mode": "tracking"}, {"nco_mode": "exact"},
              {"fir_precision": "exact"}, {"slicer": "reference"}]


@pytest.mark.parametrize("kwargs", _OFF_SLICE,
                         ids=[",".join(f"{k}={v}" for k, v in d.items())
                              for d in _OFF_SLICE])
def test_former_off_slice_config_matches_jax(kwargs):
    """Each mode the port once refused runs: ``tx_stream`` within 2 LSB of
    JAX on the same bits, then ``rx_stream`` on the same PCM (numpy AWGN
    at 10 dB) with equal timing decisions and bits, derotated symbols
    within 1e-4 and the loop frequency within 0.05 Hz."""
    cfg, jc = dataclasses.replace(CFG, **kwargs), JCfg(**kwargs)
    rng = np.random.default_rng(17)
    nframes = 3 if cfg.nco_mode == "exact" else 6
    bits = rng.integers(0, 2, (C, nframes, 256), dtype=np.int32)
    _, jpcm = j_tx_stream(jc, j_tx_init(jc, batch_shape=(C,)), bits,
                          tx_offset_hz=50.0)
    _, tpcm = tx_stream(cfg, tx_init(cfg, (C,), device="cpu"),
                        torch.from_numpy(bits), tx_offset_hz=50.0)
    x = np.asarray(jpcm).astype(np.int32)
    assert np.abs(tpcm.numpy().astype(np.int32) - x).max() <= 2
    pcm = np.clip(np.round(x + rng.normal(size=x.shape)
                           * np.sqrt((x.astype(np.float64) ** 2).mean()
                                     / 10.0)),
                  -32768, 32767).astype(np.int16)
    _, jout = j_rx_stream(jc, j_rx_init(jc, batch_shape=(C,)), pcm)
    _, out = rx_stream(cfg, rx_init(cfg, (C,), device="cpu"),
                       torch.from_numpy(pcm))
    np.testing.assert_array_equal(out.timing_index.numpy(),
                                  np.asarray(jout.timing_index))
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(jout.bits))
    np.testing.assert_allclose(out.symbols.re.numpy(),
                               np.asarray(jout.symbols.re), atol=1e-4)
    np.testing.assert_allclose(out.freq_hz.numpy(), np.asarray(jout.freq_hz),
                               atol=0.05)


def test_off_slice_inputs_raise():
    for shape in ((512,), (1, 2, 500)):
        with pytest.raises(NotImplementedError):
            rx_stream(CFG, rx_init(CFG, device="cpu"), torch.zeros(shape, dtype=torch.int16))
    assert PacketConfig(fec="ldpc").fec_kind == "ldpc"
    with pytest.raises(ValueError):
        PacketConfig(fec="ldpc2")


_OPTIONS = [{"agc": True}, {"eq_taps": 5}, {"loop_bw_track": 0.03}]


@pytest.mark.parametrize("kwargs", _OPTIONS,
                         ids=[",".join(f"{k}={v}" for k, v in d.items())
                              for d in _OPTIONS])
def test_option_config_runs_and_matches_jax(kwargs):
    """The AGC, the CMA equalizer and the gear-shift loop run on the same
    PCM as JAX ``rx_stream``: equal timing decisions, bits equal except
    within 1e-3 of a decision boundary, the option's state close."""
    cfg, jc = dataclasses.replace(CFG, **kwargs), JCfg(**kwargs)
    rng = np.random.default_rng(13)
    bits = rng.integers(0, 2, (C, 8, 256), dtype=np.int32)
    _, pcm = j_tx_stream(jc, j_tx_init(jc, batch_shape=(C,)), bits,
                         tx_offset_hz=50.0)
    x = np.asarray(pcm).astype(np.float64)
    pcm = np.clip(np.round(x + rng.normal(size=x.shape)
                           * np.sqrt((x ** 2).mean() / 10.0)),
                  -32768, 32767).astype(np.int16)
    jst, jout = j_rx_stream(jc, j_rx_init(jc, batch_shape=(C,)), pcm)
    st, out = rx_stream(cfg, rx_init(cfg, (C,), device="cpu"),
                        torch.from_numpy(pcm))
    np.testing.assert_array_equal(out.timing_index.numpy(),
                                  np.asarray(jout.timing_index))
    flips = out.bits.numpy() != np.asarray(jout.bits)
    tie = np.stack([np.abs(out.symbols.im.numpy()) < 1e-3,
                    np.abs(out.symbols.re.numpy()) < 1e-3],
                   -1).reshape(flips.shape)
    assert tie[flips].all(), int(flips.sum())
    np.testing.assert_allclose(out.symbols.re.numpy(),
                               np.asarray(jout.symbols.re), atol=1e-3)
    if cfg.agc:
        np.testing.assert_allclose(st.agc.numpy(), np.asarray(jst.agc),
                                   rtol=1e-5)
    if cfg.eq_taps:
        np.testing.assert_allclose(st.eq[0].im.numpy(),
                                   np.asarray(jst.eq[0].im), atol=1e-4)
    if cfg.loop_bw_track:
        np.testing.assert_allclose(st.costas.lev.numpy(),
                                   np.asarray(jst.costas.lev), atol=1e-4)


_GEOMETRIES = [{"rs": 4800.0}, {"ntaps": 63}, {"frame_size": 256},
               {"frame_size": 1024},
               # the general front-end instance's: 3 and 16 samples per
               # symbol, a 4096-sample frame, the AGC power output at 384
               # symbols a frame (not a power of two)
               {"rs": 3200.0, "frame_size": 384},
               {"rs": 600.0, "frame_size": 2048}, {"frame_size": 4096},
               {"frame_size": 1536, "agc": True}]


@pytest.mark.parametrize("kwargs", _GEOMETRIES,
                         ids=[",".join(f"{k}={v}" for k, v in d.items())
                              for d in _GEOMETRIES])
def test_geometry_off_the_kernels_matches_jax(kwargs):
    """What the kernels are not built for runs through the plain versions:
    ``tx_stream`` within 1 LSB of JAX on the same bits (2 samples per
    symbol overshoots full scale: both saturate), then ``rx_stream`` on the
    same PCM with equal timing decisions and bits, both planes of the
    symbols within 1e-4 and the frequency readback within 0.05 Hz, chained
    halves equal to one call.  A CPU tensor never asks for a kernel, so no
    launch is counted."""
    from qpsk_tpu_torch.ops.cuda import _lib
    before = dict(_lib.launches)
    cfg, jc = dataclasses.replace(CFG, **kwargs), JCfg(**kwargs)
    rng = np.random.default_rng(17)
    bits = rng.integers(0, 2, (C, 6, cfg.bits_per_frame), dtype=np.int32)
    _, jpcm = j_tx_stream(jc, j_tx_init(jc, batch_shape=(C,)), bits,
                          tx_offset_hz=50.0)
    _, tpcm = tx_stream(cfg, tx_init(cfg, (C,), device="cpu"),
                        torch.from_numpy(bits), tx_offset_hz=50.0)
    assert tpcm.shape == (C, 6, cfg.frame_size)
    assert np.abs(tpcm.numpy().astype(np.int32)
                  - np.asarray(jpcm).astype(np.int32)).max() <= 1
    x = np.asarray(jpcm).astype(np.float64)
    pcm = np.clip(np.round(x + rng.normal(size=x.shape)
                           * np.sqrt((x ** 2).mean() / 10.0)),
                  -32768, 32767).astype(np.int16)
    _, jout = j_rx_stream(jc, j_rx_init(jc, batch_shape=(C,)), pcm)
    st0 = rx_init(cfg, (C,), device="cpu")
    _, out = rx_stream(cfg, st0, torch.from_numpy(pcm))
    np.testing.assert_array_equal(out.timing_index.numpy(),
                                  np.asarray(jout.timing_index))
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(jout.bits))
    for part in ("re", "im"):
        np.testing.assert_allclose(getattr(out.symbols, part).numpy(),
                                   np.asarray(getattr(jout.symbols, part)),
                                   atol=1e-4)
    np.testing.assert_allclose(out.freq_hz.numpy(), np.asarray(jout.freq_hz),
                               atol=0.05)
    st1, a = rx_stream(cfg, st0, torch.from_numpy(pcm[:, :2]))
    _, b = rx_stream(cfg, st1, torch.from_numpy(pcm[:, 2:]))
    assert torch.equal(torch.cat([a.bits, b.bits], 1), out.bits)
    assert _lib.launches == before


def _gate_cases():
    """(id, config fields or None, the kernel gates asked, the field they
    must name or None)."""
    from qpsk_tpu_torch.ops.cuda import frontend_kernel, ldpc_kernel, tx_kernel
    from qpsk_tpu_torch.ops.cuda import viterbi_kernel
    from qpsk_tpu_torch.packet import ConvCode, LdpcCode

    def modem(**kwargs):
        cfg = dataclasses.replace(CFG, **kwargs)
        return [frontend_kernel.coverage(cfg), tx_kernel.coverage(cfg)]
    cases = [(",".join(f"{k}={v}" for k, v in d.items()), d,
              lambda d=d: modem(**d), None) for d in _GEOMETRIES]
    return cases + [
        ("ntaps=131", {"ntaps": 131}, lambda: modem(ntaps=131), "ntaps"),
        ("ldpc_m=4104", None,
         lambda: [ldpc_kernel.coverage(LdpcCode(k=4104))], "m"),
        ("conv_K=5", None,
         lambda: [viterbi_kernel.coverage(ConvCode(constraint=5,
                                                   polys=(0o23, 0o35)))],
         None),
        ("conv_K=16", None,
         lambda: [viterbi_kernel.coverage(ConvCode(constraint=16,
                                                   polys=(0o100003,
                                                          0o170001)))],
         "constraint"),
        ("ldpc_dv=9", None,
         lambda: [ldpc_kernel.coverage(LdpcCode(k=64, dv=9))], "dv")]


@pytest.mark.parametrize("case", _gate_cases(), ids=lambda c: c[0])
def test_kernel_gate_names_the_geometry(case):
    """The check a wrapper makes before it launches on a CUDA tensor
    (``_lib.check_geometry`` of the kernel's ``coverage``) passes the
    geometries the kernels were widened to (each a valid config) and a K=5
    convolutional code; past a
    kernel's coverage (131 taps, beyond the TPU front-end's gate; an LDPC
    code of more checks or a higher variable degree than the kernels
    take; a K=16 convolutional code) it raises ``NotImplementedError``
    naming the field."""
    from qpsk_tpu_torch.ops.cuda import _lib
    _, fields, gates, field = case
    dataclasses.replace(CFG, **(fields or {}))
    if field is None:
        for off in gates():
            _lib.check_geometry(off)
        return
    with pytest.raises(NotImplementedError, match=field):
        for off in gates():
            _lib.check_geometry(off)
