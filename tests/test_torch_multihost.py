"""The port's multi-process helpers (``qpsk_tpu_torch.parallel.multihost``)
in four gloo ranks, against the JAX package's (``tests/test_utils.py:92-110``,
``tests/test_multiprocess.py``).

One module-scoped fixture starts four worker processes that import only
the port, joined on a ``FileStore`` under ``tmp_path`` (no ports;
``torch_dist_common.spawn_ranks``), runs every case once and saves what
rank 0 gathered.  The cases:

* ``initialize`` twice is a no-op (the second call leaves the group as
  it is); alone, outside any cluster environment, it starts nothing;
* ``global_mesh(("dp",))`` spans the four ranks and ``(("dp", "sp"), (2,
  2))`` puts rank r at (r // 2, r % 2); sizes that do not multiply to the
  world size, or a second axis without sizes, raise ValueError;
* the gloo group refuses the card (ValueError): a mesh there, a tensor
  there, and ``benchmarks.rx_throughput`` measuring there;
* ``replicate`` gives every rank rank 0's tensors, a state tuple's too;
* ``aggregate_metrics`` equals the numpy mean over all ranks' rows;
* the two-process front-end of ``tests/test_multiprocess.py:87`` in its
  world-size-2 form: each row of the (2, 2) mesh runs the time-sharded
  front-end over its two ranks, within 2e-4 of the serial chain and of
  JAX ``rx_frontend_timeparallel`` on two devices; the channel-sharded
  receive over that mesh's ``dp`` axis equals the local decode.

A process with no group gets a one-rank group from ``global_mesh``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from qpsk_tpu import ModemConfig as JCfg
from qpsk_tpu.parallel.stream import rx_frontend_timeparallel as j_frontend_tp
from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream, tx_init, tx_stream
from qpsk_tpu_torch.modem import _tmat
from qpsk_tpu_torch.ops import nco
from qpsk_tpu_torch.ops import rrc as rrc_ops
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.packet import PacketConfig, assemble_packet
from qpsk_tpu_torch.parallel import multihost
from torch_dist_common import WORLD, spawn_ranks

torch.set_num_threads(2)

SPAWN_TIMEOUT_S = 150

_WORKER = r'''
from qpsk_tpu_torch import ModemConfig, benchmarks
from qpsk_tpu_torch.parallel.channels import init_channels, make_channel_demod
from qpsk_tpu_torch.parallel.stream import rx_frontend_timeparallel
from qpsk_tpu_torch.state import rx_init

group = dist.group.WORLD
multihost.initialize(f"file://{store}", world, rank, device="cpu")
inp = {k: torch.from_numpy(v) for k, v in
       np.load(os.path.join(io, "inputs.npz")).items()}
out = {"second_initialize_kept_the_group": np.asarray(
    dist.group.WORLD is group and dist.get_world_size() == world)}


def refused(name, fn):
    try:
        fn()
    except ValueError as e:
        out["refused_" + name] = np.asarray(str(e))


one = multihost.global_mesh(("dp",))
two = multihost.global_mesh(("dp", "sp"), (2, 2))
out["one_axis"] = gather(torch.tensor(
    [[multihost.axis_size(one, "dp"), multihost.axis_rank(one, "dp")]]))
out["two_axes"] = gather(torch.tensor(
    [[multihost.axis_size(two, "dp"), multihost.axis_size(two, "sp"),
      multihost.axis_rank(two, "dp"), multihost.axis_rank(two, "sp")]]))
for name, args in (("sizes", (("dp",), (3,))),
                   ("two_no_sizes", (("dp", "sp"),)),
                   ("too_many", (("dp", "sp"), (2, 4)))):
    refused(name, lambda: multihost.global_mesh(*args))

# a gloo group never takes work meant for the card: a mesh asked on the
# card, a tensor on the card, the rx suite measuring the card in the group
refused("card_mesh", lambda: multihost.global_mesh(("dp",), device="cuda"))


class OnCard:
    device = torch.device("cuda", 0)


refused("card_tensor", lambda: multihost.to_mesh(OnCard(), one))
benchmarks._device = torch.device   # as where a card is visible
refused("card_rx_throughput", lambda: benchmarks.rx_throughput(
    channels=8, frames=2, iters=1, inner=1, device="cuda"))

cfg = ModemConfig()
mine = {"x": torch.arange(5.0) + 10 * rank,
        "st": rx_init(cfg, (2,), acq_freq=0.01 * rank, device="cpu"),
        "tag": "kept"}
rep = multihost.replicate(one, mine)
assert rep["tag"] == "kept"
out["rep_x"] = gather(rep["x"][None])
out["rep_freq"] = gather(rep["st"].costas.freq[None])
out["rep_tail"] = gather(rep["st"].fir_tail.re[None])

rows = torch.tensor([[rank, 2.0 * rank], [rank + 1.0, 0.5]])
agg = multihost.aggregate_metrics(one, "dp")(
    {"ber": torch.tensor([float(rank)]), "rows": rows})
out["agg_ber"] = gather(agg["ber"][None])
out["agg_rows"] = gather(agg["rows"][None])
out["rows"] = gather(rows)

y = rx_frontend_timeparallel(cfg, inp["fe16"], two, axis="sp")
out["fe2_re"], out["fe2_im"] = gather(y.re), gather(y.im)
demod = make_channel_demod(cfg, two, axis="dp")
_, o = demod(init_channels(cfg, 8, two, axis="dp"), inp["dp"])
out["dp2_bits"] = gather(o.bits)

if rank == 0:
    np.savez(os.path.join(io, "out.npz"), **out)
'''


def _fe16() -> np.ndarray:
    """``tests/test_multiprocess.py``'s stream: 16 frames of seeded
    packets from TX at +50 Hz (the port's TX)."""
    cfg = ModemConfig()
    rng = np.random.default_rng(0)
    payload = torch.from_numpy(rng.integers(0, 2, (16, 240), dtype=np.int32))
    _, pcm = tx_stream(cfg, tx_init(cfg, device="cpu"),
                       assemble_packet(PacketConfig(payload_bytes=30),
                                       payload), tx_offset_hz=50.0)
    return pcm.numpy().reshape(-1)


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_multihost")
    inp = {"fe16": _fe16(),
           "dp": np.random.default_rng(1).integers(-8192, 8192, (8, 3, 512),
                                                   dtype=np.int16)}
    np.savez(d / "inputs.npz", **inp)
    spawn_ranks(_WORKER, d, SPAWN_TIMEOUT_S)
    with np.load(d / "out.npz") as f:
        return inp, dict(f.items())


def test_initialize_noop_alone(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    if dist.is_initialized():
        pytest.fail("a process group is up in the test process")
    multihost.initialize()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="together"):
        multihost.initialize("localhost:1", None, 0, device="cpu")
    assert not dist.is_initialized()


def test_initialize_twice_keeps_the_group(ran):
    _, out = ran
    assert bool(out["second_initialize_kept_the_group"])


def test_global_mesh_axes(ran):
    _, out = ran
    np.testing.assert_array_equal(out["one_axis"],
                                  [[WORLD, r] for r in range(WORLD)])
    np.testing.assert_array_equal(
        out["two_axes"], [[2, 2, r // 2, r % 2] for r in range(WORLD)])


@pytest.mark.parametrize("case", ["sizes", "two_no_sizes", "too_many"])
def test_global_mesh_refuses_sizes(ran, case):
    _, out = ran
    assert "refused_" + case in out, case


@pytest.mark.parametrize("case, words", [
    ("card_mesh", "gloo group cannot hold a mesh on cuda"),
    ("card_tensor", "given to a cpu mesh"),
    ("card_rx_throughput", "gloo group cannot measure on cuda")])
def test_a_gloo_group_refuses_the_card(ran, case, words):
    """Work meant for the card raises in a gloo group rather than moving
    to the CPU: a mesh asked on the card, a tensor on the card given to
    the CPU mesh (``make_channel_demod``, ``shard_channel_state`` and the
    time-parallel stream move their inputs through ``to_mesh``), and
    ``rx_throughput`` in the group."""
    _, out = ran
    assert "refused_" + case in out, case
    assert words in str(out["refused_" + case])


def test_replicate_gives_rank_0s_tensors(ran):
    _, out = ran
    cfg = ModemConfig()
    np.testing.assert_array_equal(out["rep_x"],
                                  np.tile(np.arange(5.0), (WORLD, 1)))
    st = rx_init(cfg, (2,), acq_freq=0.0, device="cpu")
    np.testing.assert_array_equal(out["rep_freq"],
                                  np.tile(st.costas.freq.numpy(), (WORLD, 1)))
    assert out["rep_tail"].shape == (WORLD, 2, cfg.ntaps - 1)


def test_aggregate_metrics_is_the_mean(ran):
    _, out = ran
    np.testing.assert_allclose(out["agg_ber"], np.arange(WORLD).mean(),
                               rtol=1e-6)
    want = out["rows"].mean(axis=0)
    np.testing.assert_allclose(out["agg_rows"], np.tile(want, (WORLD, 1)),
                               rtol=1e-6)


def _serial_frontend(pcm):
    cfg = ModemConfig()
    x = torch.from_numpy(pcm).to(torch.float32) / float(cfg.pcm_scale)
    y, _ = nco.mix(CF32(x, torch.zeros_like(x)), nco.nco_init((), "cpu"),
                   -cfg.omega_center, "fast")
    y, _ = rrc_ops.fir_block(y, rrc_ops.fir_init_tail(cfg.ntaps, (), "cpu"),
                             _tmat(cfg, 512, "cpu"), cfg.gain, 512)
    return y.re.numpy(), y.im.numpy()


def test_two_process_frontend_and_demod(ran):
    inp, out = ran
    n = inp["fe16"].size
    sr, si = _serial_frontend(inp["fe16"])
    jy = j_frontend_tp(JCfg(), jnp.asarray(inp["fe16"]),
                       Mesh(np.asarray(jax.devices()[:2]), ("sp",)))
    for row in range(2):   # each dp row ran the whole stream on 2 ranks
        re = out["fe2_re"][row * n:(row + 1) * n]
        im = out["fe2_im"][row * n:(row + 1) * n]
        np.testing.assert_allclose(re, sr, atol=2e-4)
        np.testing.assert_allclose(im, si, atol=2e-4)
        np.testing.assert_allclose(re, np.asarray(jy.re), atol=2e-4)
    cfg = ModemConfig()
    _, ref = rx_stream(cfg, rx_init(cfg, (8,), device="cpu"),
                       torch.from_numpy(inp["dp"]))
    bits = out["dp2_bits"].reshape(2, 2, 4, *ref.bits.shape[1:])
    for sp in range(2):    # both sp ranks of a dp row hold its block
        np.testing.assert_array_equal(bits[:, sp].reshape(ref.bits.shape),
                                      ref.bits.numpy())


def test_global_mesh_starts_a_one_rank_group():
    if dist.is_initialized():
        pytest.fail("a process group is up in the test process")
    try:
        mesh = multihost.global_mesh(("dp",), device="cpu")
        assert dist.get_world_size() == 1 and mesh.device_type == "cpu"
        assert multihost.axis_size(mesh, "dp") == 1
        rep = multihost.replicate(mesh, {"a": torch.arange(3)})
        assert torch.equal(rep["a"], torch.arange(3))
        agg = multihost.aggregate_metrics(mesh, "dp")({"m": torch.ones(4)})
        assert float(agg["m"]) == 1.0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
