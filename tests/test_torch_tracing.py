"""The port's spans and counters (``qpsk_tpu_torch.tracing``) on CPU
tensors: nothing recorded and no ``record_function`` entered outside a
profiler session; under one, the receive chain's spans nested as the code
nests them, each also a ``qpsk.<name>`` event of the profiler's own trace
on the same clock; outputs bit-identical either way; the packet path's
host-device syncs counted at their sites; launches counted at
``_lib.check``; the runtime's and the FDM bank's spans; the lifecycle
``kernels.load`` span kept with no profiler; the ring and the time
filter."""

import collections
import glob
import json
import time

import numpy as np
import pytest
import torch

from qpsk_tpu_torch import (ModemConfig, StreamDemodulator, StreamModulator,
                            rx_init, rx_stream, tracing, tx_init)
from qpsk_tpu_torch import fdm
from qpsk_tpu_torch.ops.costas import costas_init, costas_params
from qpsk_tpu_torch.ops.cuda import (_lib, costas_kernel, frontend_kernel,
                                     ldpc_kernel, tx_kernel, viterbi_kernel)
from qpsk_tpu_torch.ops.modmap import demod_soft
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.packet import ConvCode, LdpcCode, PacketConfig
from qpsk_tpu_torch.packet.frame import (disassemble_packet,
                                         disassemble_packet_soft)
from qpsk_tpu_torch.utils.debug import trace
from torch_kernel_recorder import recorder

# the sites of blocking host-device copies that one soft disassembly of
# interleaved, scrambled packets passes (PERF.md's table of counters)
SOFT_PACKET_SYNCS = {"sync.frame.keystream": 1, "sync.interleave.perm": 1,
                     "sync.crc16.table": 1}


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _recorded(fn):
    """(fn's result, the records it made, the profiler's qpsk.* events)
    with fn run under a CPU profiler."""
    prof = _profiler()
    prof.start()
    t0 = time.time_ns()
    try:
        out = fn()
    finally:
        t1 = time.time_ns()
        prof.stop()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("qpsk.")]
    return out, tracing.records(t0, t1), events


def _counts(recs) -> collections.Counter:
    got = collections.Counter()
    for kind, name, _, _, n in recs:
        if kind == "count":
            got[name] += n
    return got


def _spans(recs, name) -> list:
    return [r for r in recs if r[0] == "span" and r[1] == name]


def _leaves(tree) -> list:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _rx_inputs(channels=3, frames=4, seed=0):
    cfg = ModemConfig()
    gen = torch.Generator().manual_seed(seed)
    pcm = torch.randint(-6000, 6000, (channels, frames, cfg.frame_size),
                        generator=gen, dtype=torch.int16)
    return cfg, rx_init(cfg, (channels,), device="cpu"), pcm


def test_no_profiler_records_nothing_and_enters_no_record_function(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(tracing, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    cfg, st, pcm = _rx_inputs()
    t0 = time.time_ns()
    rx_stream(cfg, st, pcm)
    pcfg = PacketConfig(fec="conv")
    disassemble_packet_soft(pcfg, torch.randn(2, pcfg.frame_bits))
    _lib.check(0, "qpsk_x")
    assert tracing.records(t0, time.time_ns()) == []


def test_rx_stream_spans_nest_and_match_the_profiler():
    cfg, st, pcm = _rx_inputs()
    _recorded(lambda: rx_stream(cfg, st, pcm))   # the profiler's first use
    leads = collections.defaultdict(list)
    for _ in range(3):
        _, recs, events = _recorded(lambda: rx_stream(cfg, st, pcm))
        (top,) = _spans(recs, "rx_stream")
        assert top[4] == 0
        for name in ("rx.frontend", "rx.costas", "rx.emit"):
            (inner,) = _spans(recs, name)
            assert inner[4] == 1 and top[2] <= inner[2] <= inner[3] <= top[3]
        fe, co, em = (_spans(recs, n)[0]
                      for n in ("rx.frontend", "rx.costas", "rx.emit"))
        assert fe[3] <= co[2] and co[3] <= em[2]
        starts = {e.name(): e.start_ns() for e in events}
        for r in recs:
            leads[r[1]].append(abs(r[2] - starts[f"qpsk.{r[1]}"]))
    assert set(leads) == {"rx_stream", "rx.frontend", "rx.costas", "rx.emit"}
    # the profiler's stamp and the program's lie a few microseconds apart
    # (the rest of record_function's entry); the best of three calls
    # leaves out a preempted one
    assert all(min(v) < 50_000 for v in leads.values()), dict(leads)


def test_rx_stream_bit_identical_with_recording_on_and_off():
    cfg, st, pcm = _rx_inputs(seed=3)
    st_off, out_off = rx_stream(cfg, st, pcm)
    (st_on, out_on), recs, _ = _recorded(lambda: rx_stream(cfg, st, pcm))
    assert _spans(recs, "rx_stream")
    off, on = _leaves((st_off, out_off)), _leaves((st_on, out_on))
    assert len(off) == len(on) > 0
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fec", ["conv", "ldpc", False])
def test_soft_disassembly_counts_its_sync_sites(fec):
    pcfg = PacketConfig(fec=fec)
    llrs = torch.randn(2, 3, pcfg.frame_bits,
                       generator=torch.Generator().manual_seed(1))
    rx, recs, events = _recorded(lambda: disassemble_packet_soft(pcfg, llrs))
    assert rx.crc_ok.shape == (2, 3)
    assert _counts(recs) == SOFT_PACKET_SYNCS
    (top,) = _spans(recs, "packet.disassemble")
    (crc,) = _spans(recs, "packet.crc")
    assert top[4] == 0 and crc[4] == 1
    assert len(_spans(recs, "packet.decode")) == (1 if fec else 0)
    assert {e.name() for e in events} >= {"qpsk.packet.disassemble",
                                          "qpsk.packet.crc"}


def test_hard_disassembly_and_soft_bits_count_their_sites():
    pcfg = PacketConfig()
    bits = torch.randint(0, 2, (4, pcfg.frame_bits),
                         generator=torch.Generator().manual_seed(2))
    _, recs, _ = _recorded(lambda: disassemble_packet(pcfg, bits))
    assert _counts(recs) == {"sync.interleave.perm": 1,
                             "sync.scramble.keystream": 1,
                             "sync.crc16.table": 1}
    sym = CF32(torch.randn(8), torch.randn(8))
    llr, recs, _ = _recorded(lambda: demod_soft(sym))
    assert llr.shape == (16,)
    assert [r[1] for r in recs] == ["packet.soft"] and not _counts(recs)


def test_check_counts_one_launch_under_recording():
    _, recs, _ = _recorded(lambda: _lib.check(0, "qpsk_x"))
    assert _counts(recs) == {"launch.qpsk_x": 1}
    with pytest.raises(RuntimeError, match="qpsk_x: CUDA error 2"):
        _recorded(lambda: _lib.check(2, "qpsk_x"))


def test_launches_counted_by_entry_with_and_without_a_profiler(monkeypatch):
    """``_lib.launches`` counts each wrapper launch once under its C entry
    with no profiler running, when nothing is recorded but the lifecycle
    count of a launch plan's first build (``plan.build``), and under one,
    when each launch is also one ``launch.<entry>`` event of that name, in
    the order of the launches."""
    recorder(monkeypatch)
    cfg, st, pcm = _rx_inputs()
    long = ModemConfig(frame_size=640)
    st_long = rx_init(long, (3,), device="cpu")
    z = torch.zeros((128, 3))
    code, ldpc_code = ConvCode(), LdpcCode(k=64)

    def launch_all():
        frontend_kernel._launch(cfg, pcm, st.nco_phase, st.fir_tail,
                                st.decim_delay)
        frontend_kernel._launch(long, torch.zeros((3, 2, 640),
                                                  dtype=torch.int16),
                                st_long.nco_phase, st_long.fir_tail)
        costas_kernel._launch(costas_init((3,), device="cpu"), z, z,
                              costas_params(0.06), 16, None, None, None)
        tx = tx_init(cfg, (3,), device="cpu")
        tx_kernel._launch(cfg, CF32(z.T.contiguous(), z.T.contiguous()),
                          tx.nco_phase, tx.fir_tail, 0.0)
        viterbi_kernel._launch(code, torch.zeros((2, 2 * (64 + 6))), 64)
        ldpc_kernel._launch(ldpc_code, torch.zeros((2, ldpc_code.n)), None)
    entries = ["qpsk_frontend_pipe", "qpsk_frontend_gen", "qpsk_costas_tm",
               "qpsk_tx", "qpsk_viterbi", "qpsk_ldpc"]
    for profiled in (False, True):
        before = dict(_lib.launches)
        t0 = time.time_ns()
        if profiled:
            _, recs, _ = _recorded(launch_all)
            assert [r[:2] for r in recs] == [("count", f"launch.{e}")
                                            for e in entries]
            assert all(r[4] == 1 for r in recs)
        else:
            launch_all()
            recs = tracing.records(t0, time.time_ns())
            assert len(recs) <= 3
            assert all(r[:2] == ("count", "plan.build") for r in recs)
        assert {k: n - before.get(k, 0) for k, n in _lib.launches.items()
                if n != before.get(k, 0)} == dict.fromkeys(entries, 1)


def test_launch_record_spans_the_c_call(monkeypatch):
    called = []

    class Library:
        def qpsk_x(self, *args):
            called.append((time.time_ns(), args))
            return 0

        def qpsk_bad(self, *args):
            return 700
    monkeypatch.setattr(_lib, "library", Library)
    _, recs, _ = _recorded(lambda: _lib.launch("qpsk_x", 3, None))
    (rec,) = recs
    ((t, args),) = called
    assert args == (3, None)
    assert rec[:2] == ("count", "launch.qpsk_x") and rec[4] == 1
    assert rec[2] <= t <= rec[3]
    with pytest.raises(RuntimeError, match="qpsk_bad: CUDA error 700"):
        _lib.launch("qpsk_bad")


def test_kernel_load_span_kept_with_no_profiler(monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_lib, "build", no_nvcc)
    t0 = time.time_ns()
    with pytest.raises(RuntimeError, match="nvcc"):
        _lib.library()
    (load,) = tracing.records(t0, time.time_ns())
    assert load[:2] == ("span", "kernels.load") and load[3] >= load[2]


def test_runtime_spans_and_syncs_per_bucket():
    cfg, pcfg = ModemConfig(acquisition="none"), PacketConfig()
    payload = np.random.default_rng(4).integers(0, 2, (16, 240),
                                                dtype=np.int32)
    mod = StreamModulator(cfg, pcfg, device="cpu")
    pcm = np.concatenate([mod.push(payload), mod.flush()])
    demod = StreamDemodulator(cfg, pcfg, bucket_frames=4, device="cpu")
    _, recs, events = _recorded(lambda: demod.push(pcm))
    (push,) = _spans(recs, "runtime.push")
    buckets = _spans(recs, "runtime.bucket")
    assert len(buckets) == pcm.size // (4 * cfg.frame_size)
    assert all(push[2] <= b[2] and b[3] <= push[3] and b[4] == 1
               for b in buckets)
    assert len(_spans(recs, "rx_stream")) == len(buckets)
    assert _spans(recs, "runtime.drain") and _spans(recs, "runtime.hunt")
    for b in buckets:
        inside = _counts(r for r in recs if b[2] <= r[2] <= b[3])
        assert inside["sync.runtime.h2d"] == 1
        assert inside["sync.runtime.d2h"] == 1
        assert inside["sync.rotation.table"] == 4
    syncs = _counts(recs)
    assert set(syncs) <= {"sync.runtime.h2d", "sync.runtime.d2h",
                          "sync.rotation.table", "sync.interleave.perm",
                          "sync.scramble.keystream", "sync.crc16.table"}
    assert "qpsk.runtime.push" in {e.name() for e in events}


def test_fdm_demux_span():
    fcfg = fdm.FdmConfig(nslots=8)
    wide = torch.zeros(8 * 64, dtype=torch.int16)
    (pcm, _), recs, _ = _recorded(lambda: fdm.fdm_demux_stream(
        fcfg, wide, fdm.fdm_init(fcfg, "cpu")))
    assert pcm.shape == (fcfg.nchan, 64)
    assert [r[1] for r in recs] == ["fdm.demux"]


def test_debug_trace_shows_the_program_spans(tmp_path):
    cfg, st, pcm = _rx_inputs(channels=1, frames=2)
    with trace(str(tmp_path / "tr")):
        rx_stream(cfg, st, pcm)
    (path,) = glob.glob(str(tmp_path / "tr" / "trace-*.json"))
    with open(path) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"qpsk.rx_stream", "qpsk.rx.frontend", "qpsk.rx.costas",
            "qpsk.rx.emit"} <= names


def test_ring_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(tracing, "_ring", collections.deque(maxlen=4))
    monkeypatch.setattr(tracing, "dropped", 0)
    t0 = time.time_ns()
    for i in range(7):
        tracing.count(f"c{i}", always=True)
    assert [r[1] for r in tracing.records(t0, time.time_ns())] == [
        "c3", "c4", "c5", "c6"]
    assert tracing.dropped == 3


def test_records_filter_by_time(monkeypatch):
    monkeypatch.setattr(tracing, "_ring", collections.deque(maxlen=16))
    for rec in [("span", "a", 10, 20, 0), ("count", "b", 25, 25, 2),
                ("span", "c", 30, 50, 1), ("count", "d", 60, 60, 1)]:
        tracing._append(rec)
    names = lambda t0, t1: [r[1] for r in tracing.records(t0, t1)]  # noqa
    assert names(0, 100) == ["a", "b", "c", "d"]
    assert names(21, 29) == ["b"]
    assert names(40, 45) == ["c"]           # a span that holds the window
    assert names(20, 30) == ["a", "b", "c"]  # the ends count
    assert names(51, 59) == []
    assert names(60, 60) == ["d"]
