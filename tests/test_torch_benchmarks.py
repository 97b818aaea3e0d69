"""The port's benchmark suites (``qpsk_tpu_torch.benchmarks``) on CPU
tensors at the JAX suite's tiny test sizes (``tests/test_benchmarks.py``):
each record is well formed (a positive rate, ``platform`` "cpu", ``card``
"cpu") and has the JAX record's keys at the same arguments, less
``vs_baseline`` and plus ``card``.  The latency suite's decode guard
holds (every decoded payload sent) and its cold-start decisions equal
JAX's on the same numpy payload.  ``bench --suite rx --device cpu``
prints the record through ``cli.main``, and an unknown suite is refused.

The scale-out records (``scaling_efficiency``, ``sp_bound_record``,
``sp_scaling_decomposition``) run in four gloo ranks (worker processes
that import only the port, on a ``FileStore`` under ``tmp_path``) at the
JAX tests' small sizes (``tests/test_benchmarks.py``) over 1, 2 and 4
devices: rank 0's records have the JAX records' keys (less the TPU
interconnect's ``real_mesh_eff``, plus ``card``), times and efficiencies
finite and positive, and the other ranks return none.  ``bench --suite
scaling --device cpu`` prints the three records' rows at world size 1,
and ``rx_throughput`` in the four ranks shards its channels over them."""

import functools
import json
import math

import pytest
import torch

import qpsk_tpu.benchmarks as JB
import qpsk_tpu_torch.benchmarks as TB
from qpsk_tpu import ModemConfig as JCfg
from qpsk_tpu_torch import ModemConfig
from qpsk_tpu_torch import cli
from torch_dist_common import spawn_ranks

torch.set_num_threads(2)

CASES = {
    "rx": ("rx_throughput", dict(channels=8, frames=2, iters=1, inner=1)),
    "tx": ("tx_throughput", dict(channels=8, frames=2, iters=1, inner=1)),
    "serial": ("single_stream_serial_throughput",
               dict(frames=4, iters=1, inner=1)),
    "blockparallel": ("single_stream_blockparallel_throughput",
                      dict(frames=8, nblocks=4, iters=1, inner=1)),
    "costas_scan": ("costas_throughput",
                    dict(impl="scan", channels=128, nsym=16, iters=1,
                         inner=1)),
    "costas_pallas": ("costas_throughput",
                      dict(impl="pallas", channels=128, nsym=16, iters=1,
                           inner=1)),
    "fec_conv": ("fec_throughput", dict(kind="conv", packets=8, iters=1,
                                        inner=1)),
    "fec_ldpc": ("fec_throughput", dict(kind="ldpc", packets=8, iters=1,
                                        inner=1)),
    "frontend_xla": ("frontend_throughput",
                     dict(impl="xla", channels=8, frames=2, iters=1,
                          inner=1)),
    "frontend_pallas": ("frontend_throughput",
                        dict(impl="pallas", channels=8, frames=2, iters=1,
                             inner=1)),
    "fdm": ("fdm_throughput", dict(nslots=8, frames=2, iters=1, inner=1)),
    "coded_conv": ("coded_rx_throughput",
                   dict(kind="conv", channels=8, frames=4, iters=1,
                        inner=1)),
    "coded_ldpc_8psk": ("coded_rx_throughput",
                        dict(kind="ldpc", modulation="8psk", channels=8,
                             frames=4, iters=1, inner=1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_record_keys_match_jax(case):
    name, kw = CASES[case]
    rec = getattr(TB, name)(device="cpu", **kw)
    want = getattr(JB, name)(**kw)
    assert set(rec) == set(want) - {"vs_baseline"} | {"card"}
    assert rec["metric"] == want["metric"] and rec["unit"] == want["unit"]
    assert rec["value"] > 0
    assert rec["platform"] == "cpu" and rec["card"] == "cpu"
    for k in ("channels", "frames", "nblocks", "nsym", "packets", "nbits",
              "nslots", "nchan", "packets_per_pass"):
        if k in want:
            assert rec[k] == want[k], k
    if "fdm" in rec:
        assert set(rec["fdm"]) == set(want["fdm"])
        assert 0.0 < rec["fdm"]["fb_fraction"] < 1.0
    if case.startswith("frontend"):
        assert rec["roofline"] is None      # no H100 roofline for a CPU time


def test_modfam_record_matches_jax():
    rec = TB.rx_throughput(channels=8, frames=2, iters=1, inner=1,
                           cfg=ModemConfig(modulation="16qam", agc=True),
                           device="cpu")
    want = JB.rx_throughput(channels=8, frames=2, iters=1, inner=1,
                            cfg=JCfg(modulation="16qam", agc=True))
    assert set(rec) == set(want) - {"vs_baseline"} | {"card"}
    assert rec["modulation"] == "16qam" and rec["value"] > 0


def test_latency_record_matches_jax():
    kw = dict(npkts=24, chunk=4096)
    rec = TB.latency_benchmark(device="cpu", **kw)
    want = JB.latency_benchmark(**kw)
    assert set(rec) == set(want) | {"card"}
    # the same payload and stream geometry: the cold start's decisions
    for k in ("cold_latency_s", "skipped_packets", "sent", "steady_buffer_s",
              "bucket_frames", "chunk"):
        assert rec[k] == want[k], k
    assert rec["decoded"] >= want["decoded"] - 1 and rec["decoded"] >= 18


def test_cli_bench_rx(capsys):
    assert cli.main(["bench", "--suite", "rx", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert rec["metric"] == "rx_demod_throughput" and rec["value"] > 0
    assert rec["platform"] == "cpu" and rec["channels"] == 16
    with pytest.raises(SystemExit):
        cli.main(["bench", "--suite", "nope", "--device", "cpu"])


def test_suites_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.rx_throughput(channels=8, frames=2, iters=1, inner=1)
    with pytest.raises(ValueError):
        TB.fec_throughput("turbo", device="cpu")


# the JAX tests' small sizes, over 1, 2 and 4 devices
SCALING = {
    "scaling_efficiency": dict(device_counts=(1, 2, 4), channels_per_device=4,
                               frames=2, iters=1, inner=1),
    "sp_bound_record": dict(device_counts=(1, 2, 4), frames=4, iters=3),
    "sp_scaling_decomposition": dict(device_counts=(1, 2, 4),
                                     frames_per_dev=(2, 4), iters=1),
}
# the same records of the JAX package at its smallest shapes: their keys
JAX_SCALING = {
    "scaling_efficiency": dict(device_counts=(1,), channels_per_device=1,
                               frames=1, iters=1, inner=1),
    "sp_bound_record": dict(device_counts=(1,), frames=1, iters=1),
    "sp_scaling_decomposition": dict(device_counts=(1,), frames_per_dev=(1,),
                                     iters=1),
}

_SCALING_WORKER = r"""
import json
from qpsk_tpu_torch import benchmarks
with open(os.path.join(io, "sizes.json")) as fh:
    sizes = json.load(fh)
recs = {name: getattr(benchmarks, name)(device="cpu", **kw)
        for name, kw in sizes.items()}
if rank:
    assert not any(recs.values()), recs
rx = benchmarks.rx_throughput(channels=8, frames=2, iters=1, inner=1,
                              device="cpu")
if not rank:
    recs["rx_throughput"] = rx
    with open(os.path.join(io, "records.json"), "w") as fh:
        json.dump(recs, fh)
"""


def test_scaling_records_over_four_ranks(tmp_path):
    (tmp_path / "sizes.json").write_text(json.dumps(SCALING))
    spawn_ranks(_SCALING_WORKER, tmp_path, 170)
    out = tmp_path / "records.json"
    got = json.loads(out.read_text())
    for name, kw in JAX_SCALING.items():
        want = {r["mode"]: set(r) for r in getattr(JB, name)(**kw)}
        recs = got[name]
        assert {r["mode"] for r in recs} == set(want), name
        for mode in want:
            devs = sorted(r["devices"] for r in recs if r["mode"] == mode)
            per = len(SCALING[name].get("frames_per_dev", (0,)))
            assert devs == sorted([1, 2, 4] * per), (name, mode, devs)
        for r in recs:
            assert set(r) == want[r["mode"]] - {"real_mesh_eff"} | {"card"}, \
                (name, r)
            assert r["platform"] == "cpu" and r["card"] == "cpu"
            for k, v in r.items():
                if k.startswith(("time_", "throughput", "eff", "t_launch")) \
                        or k in ("t_full_s", "t_frontend_s", "t_block_s"):
                    assert math.isfinite(v) and v > 0, (name, k, v)
    # rx_throughput in a group of four shards its 8 channels over it
    rx = got["rx_throughput"]
    want = JB.rx_throughput(channels=8, frames=2, iters=1, inner=1)
    assert set(rx) == set(want) - {"vs_baseline"} | {"card"}
    assert rx["devices"] == 4 and rx["channels"] == 8 and rx["value"] > 0


def test_cli_bench_scaling_cpu(capsys, monkeypatch):
    for name, kw in SCALING.items():
        small = dict(kw, device_counts=(1, 2))
        monkeypatch.setattr(TB, name,
                            functools.partial(getattr(TB, name), **small))
    assert cli.main(["bench", "--suite", "scaling", "--device", "cpu"]) == 0
    recs = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["mode"] for r in recs] == ["dp", "sp", "sp_bound", "sp_decomp",
                                        "sp_decomp"]
    assert all(r["devices"] == 1 and r["platform"] == "cpu" for r in recs)
    assert not torch.distributed.is_initialized()
