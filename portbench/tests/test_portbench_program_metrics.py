"""The per-layer metrics read from the program's own records
(``portbench/program_records.py``): on a traced run of the tiny cell on
the CPU, and on hand-made traces with hand-made records, where each is
worked out by hand, ``idle_inside_program_share`` stays within
``device_idle_share``, and each reads None where its records are
absent."""

import sys
import time

import pytest
import torch

from portbench import harness
from portbench.metrics import reader
from portbench.trace import Op, Trace

NEW = ("kernel_launches_per_call", "host_syncs_per_call",
       "idle_inside_program_share", "kernel_load_s")


def _read(name, trace):
    return reader(name).read(trace, None)


@pytest.fixture(scope="module")
def traced(tiny_root):
    return harness.run(tiny_root, "qpsk2400.tiny", 5, 0.3, True,
                       torch.device("cpu"), time.perf_counter())


def test_traced_tiny_cell_reports_the_program_counts(traced):
    assert traced["correct"]
    m = traced["metrics"]
    # the CPU runs the kernels' plain versions, which launch nothing and
    # copy no table: both counts exact zeros
    assert m["kernel_launches_per_call"] == {"value": 0.0,
                                             "unit": "launches/call"}
    assert m["host_syncs_per_call"] == {"value": 0.0, "unit": "syncs/call"}
    # no device operation and no kernel library on the CPU
    assert "idle_inside_program_share" not in m
    assert "device_idle_share" not in m
    assert "kernel_load_s" not in m


def _trace(ops, calls=2, t0=0, t1=1000, spanned=None) -> Trace:
    return Trace(ops=[Op("k", s, e, None) for s, e in ops], ranges=[],
                 calls=calls, window_s=(t1 - t0) / 1e9, t0=t0, t1=t1,
                 attributed=1.0, spanned=spanned)


@pytest.fixture
def fake_records(monkeypatch):
    """Replace the program's records by a list the test fills."""
    from qpsk_tpu_torch import tracing
    held = []

    def records(t0, t1):
        return [r for r in held if r[2] <= t1 and r[3] >= t0]
    monkeypatch.setattr(tracing, "records", records)
    return held


def test_counts_per_call_read_the_spanned_window(fake_records):
    fake_records += [
        ("span", "rx_stream", 100, 150, 0), ("span", "rx_stream", 600, 650, 0),
        ("count", "launch.qpsk_frontend_tm", 110, 110, 1),
        ("count", "launch.qpsk_costas_tm", 120, 120, 1),
        ("count", "launch.qpsk_frontend_tm", 610, 610, 1),
        ("count", "launch.qpsk_costas_tm", 620, 620, 1),
        ("count", "sync.crc16.table", 630, 630, 1),
        ("count", "launch.qpsk_x", 5000, 5000, 7),     # after the window
    ]
    device_only = _trace([], t0=2000, t1=3000)
    device_only.spanned = _trace([], calls=2, t0=100, t1=1000)
    assert _read("kernel_launches_per_call", device_only) == 2.0
    assert _read("host_syncs_per_call", device_only) == 0.5


def test_idle_inside_program_worked_by_hand(fake_records):
    # window [0, 1000): device busy [100, 300) and [500, 900); idle [0,
    # 100), [300, 500), [900, 1000).  Top-level spans [50, 350) and [450,
    # 460) (a nested span [60, 990) at depth 1 is not the program's top):
    # idle inside them 50 + 50 + 10 = 110 ns of the window's 1000
    fake_records += [("span", "rx_stream", 50, 350, 0),
                     ("span", "rx_stream", 450, 460, 0),
                     ("span", "rx.costas", 60, 990, 1)]
    tr = _trace([(100, 300), (500, 900), (120, 250)])
    got = _read("idle_inside_program_share", tr)
    assert got == pytest.approx(110 / 1000)
    assert got <= _read("device_idle_share", tr) == pytest.approx(0.4)


def test_idle_inside_program_at_most_the_idle_share(fake_records):
    # a span over the whole window: every idle stretch is inside it
    fake_records.append(("span", "rx_stream", -10, 2000, 0))
    tr = _trace([(100, 300), (500, 900)])
    assert _read("idle_inside_program_share", tr) == pytest.approx(
        _read("device_idle_share", tr))


def test_kernel_load_reads_every_load_span(fake_records):
    fake_records += [("span", "kernels.load", 0, 2_500_000_000, 0),
                     ("count", "kernels.build", 10, 2_400_000_000, 1)]
    assert _read("kernel_load_s", _trace([])) == pytest.approx(2.5)


@pytest.mark.parametrize("name", NEW)
def test_none_without_records(fake_records, name):
    tr = _trace([(100, 300)], spanned=_trace([(100, 300)]))
    assert _read(name, tr) is None
    fake_records.append(("count", "launch.qpsk_x", 150, 150, 1))
    assert _read(name, tr) is None       # counts but no span of the program


@pytest.mark.parametrize("name", NEW)
def test_none_without_the_tracing_module(monkeypatch, name):
    import qpsk_tpu_torch
    monkeypatch.delattr(qpsk_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "qpsk_tpu_torch.tracing", None)
    tr = _trace([(100, 300)], spanned=_trace([(100, 300)]))
    assert _read(name, tr) is None
