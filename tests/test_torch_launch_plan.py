"""The launch plans of the port's receive path (``_lib.plan``): the work of a
launch that follows from its geometry alone, done on the geometry's first
launch and counted there as ``plan.build``.  On CPU tensors, through a
recorder in place of the kernel library (``torch_kernel_recorder``): a
planned launch passes the C entry the arguments of the launch that built
its plan, the per-call pointers apart; a geometry's plan is built once;
a planned call checks every tensor the kernels read by pointer as before.
``rx_stream`` on one channel axis, which folds nothing, is held against
the same call on a folded batch; the plans kept are the last used."""

import collections
import dataclasses
import time

import pytest
import torch

from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream, tracing
from qpsk_tpu_torch import modem
from qpsk_tpu_torch.ops.costas import costas_init, costas_params, gear_for
from qpsk_tpu_torch.ops.cplx import CF32
from qpsk_tpu_torch.ops.cuda import _lib, costas_kernel, frontend_kernel
from torch_kernel_recorder import ARGS, named, recorder

# the C entries' arguments that are the call's own: its tensors and stream
_PER_CALL = {name: set(args[:18] if name.startswith("qpsk_frontend")
                       else args[:15]) | {"stream"}
             for name, args in ARGS.items()
             if name in ("qpsk_frontend_pipe", "qpsk_frontend_gen",
                         "qpsk_costas_tm")}

CONFIGS = {"default": ModemConfig(),
           "agc_gear": ModemConfig(agc=True, loop_bw_track=0.03),
           "8psk": ModemConfig(modulation="8psk"),
           "frames640": ModemConfig(frame_size=640)}


@pytest.fixture
def rec(monkeypatch):
    """A recorder on a card of 132 SMs, the kernels taken on CPU tensors
    (as on CUDA ones), and no plan built yet."""
    r = recorder(monkeypatch)
    monkeypatch.setattr(_lib, "_plans", collections.OrderedDict())
    monkeypatch.setattr(_lib, "use_kernel",
                        lambda impl, t, field: impl in ("auto", "pallas"))
    return r


def _inputs(cfg, c, nframes, seed=0):
    gen = torch.Generator().manual_seed(seed)
    pcm = torch.randint(-3000, 3000, (c, nframes, cfg.frame_size),
                        generator=gen, dtype=torch.int16)
    return rx_init(cfg, (c,), device="cpu"), pcm


def _calls(rec, fn):
    rec.calls.clear()
    out = fn()
    return out, [(name, named(name, args)) for name, args in rec.calls]


def _builds(fn) -> int:
    t0 = time.time_ns()
    fn()
    return sum(r[4] for r in tracing.records(t0, time.time_ns())
               if r[:2] == ("count", "plan.build"))


def _by_value(name, args):
    return {k: v for k, v in args.items() if k not in _PER_CALL[name]}


@pytest.mark.parametrize("key", list(CONFIGS))
def test_planned_rx_stream_passes_the_wrappers_arguments(rec, key):
    """``rx_stream``'s planned call on one axis of channels, which folds
    nothing, launches what the same call on a (1, C) batch launches
    through the fold, argument for argument but the outputs' pointers:
    its own inputs' (the state's, the PCM's), fresh outputs, the loop fed
    the front-end's picks: QPSK, the AGC with the gear, a dd mode, and
    frames of 640 samples (the general front-end instance)."""
    cfg = CONFIGS[key]
    c, nframes = 5, 3
    st, pcm = _inputs(cfg, c, nframes)
    batched = modem._tree(st, lambda v: v.unsqueeze(0))
    _, wrapped = _calls(rec, lambda: rx_stream(cfg, batched, pcm[None]))
    assert [n for n, _ in wrapped][1:] == ["qpsk_costas_tm"]
    for _ in range(2):                    # the plans' first use, then again
        (new, out), planned = _calls(rec, lambda: rx_stream(cfg, st, pcm))
        assert [n for n, _ in planned] == [n for n, _ in wrapped]
        for (name, got), (_, want) in zip(planned, wrapped):
            assert _by_value(name, got) == _by_value(name, want), name
        (_, fe_fold), _ = wrapped
        assert fe_fold["pcm"] == pcm.data_ptr()
        (_, fe), (_, co) = planned
        assert fe["pcm"] == pcm.data_ptr()
        assert (fe["tail_re"], fe["p0_im"], fe["dd_re"]) == (
            st.fir_tail.re.data_ptr(), st.nco_phase.im.data_ptr(),
            st.decim_delay.re.data_ptr())
        assert (fe["ntail_im"], fe["nph_re"], fe["ndd_im"]) == (
            new.fir_tail.im.data_ptr(), new.nco_phase.re.data_ptr(),
            new.decim_delay.im.data_ptr())
        assert (fe["index"], fe["power"] is None) == (
            out.timing_index.data_ptr(), not cfg.agc)
        assert (co["zr"], co["zi"]) == (fe["zr"], fe["zi"])
        assert (co["phase0"], co["freq_out"], co["bits"]) == (
            st.costas.phase.data_ptr(), new.costas.freq.data_ptr(),
            out.bits.data_ptr())
        assert (co["lev0"] is None) == (cfg.loop_bw_track == 0)
        assert co["outr"] == out.symbols.re.data_ptr()
        assert tuple(out.bits.shape) == (c, nframes, cfg.bits_per_frame)
        assert tuple(new.decim_delay.re.shape) == (c, cfg.symbols_per_frame)


def test_planned_wrapper_launches_pass_the_first_launchs_arguments(rec):
    """Each kernel wrapper's second launch of a geometry (from its plan)
    passes the by-value arguments of its first (which built the plan), and
    its own tensors: the front-end time-major and channel-major, the
    pipeline and the general instance, and the Costas loop's modes."""
    def frontend(cfg, tm, seed):
        st, pcm = _inputs(cfg, 3, 2, seed)
        return lambda: frontend_kernel._launch(
            cfg, pcm, st.nco_phase, st.fir_tail,
            st.decim_delay if tm else None)

    def costas(gear, gains, dd, seed):
        gen = torch.Generator().manual_seed(seed)
        z = torch.randn((64, 3), generator=gen)
        g = torch.rand((4, 3), generator=gen) if gains else None
        st = costas_init((3,), gear=gear is not None, device="cpu")
        return lambda: costas_kernel._launch(st, z, -z, costas_params(0.06),
                                             16, gear, g, dd)
    cases = [lambda s: frontend(ModemConfig(), True, s),
             lambda s: frontend(ModemConfig(agc=True), True, s),
             lambda s: frontend(ModemConfig(rs=1200.0), False, s),
             lambda s: frontend(ModemConfig(frame_size=1024, agc=True),
                                True, s),
             lambda s: costas(None, False, None, s),
             lambda s: costas(gear_for(0.01), True, None, s),
             lambda s: costas(None, True, ("16qam", 1.0), s)]
    for case in cases:
        _, first = _calls(rec, case(1))
        out, second = _calls(rec, case(2))
        ((name, a),), ((name2, b),) = first, second
        assert name == name2 and _by_value(name, a) == _by_value(name, b)
        assert a["stream"] == b["stream"] == 0
        if name == "qpsk_costas_tm":
            assert (b["outr"], b["bits"]) == (out[1].re.data_ptr(),
                                              out[3].data_ptr())
        else:
            z = out[0] if isinstance(out[0], torch.Tensor) else out[0].re
            assert b["zr"] == z.data_ptr()


def test_plan_built_once_per_geometry(rec):
    """A call with a geometry already planned counts no ``plan.build``;
    another C, nframes, config or layout (time-major or not) counts one a
    kernel: an ``rx_stream`` call the front-end's and the loop's."""
    cfg = ModemConfig()
    st, pcm = _inputs(cfg, 4, 2)
    assert _builds(lambda: rx_stream(cfg, st, pcm)) == 2
    assert [key[0] for key in _lib._plans] == ["frontend", "costas"]
    assert _builds(lambda: rx_stream(cfg, st, pcm)) == 0
    st5, pcm5 = _inputs(cfg, 5, 2)
    assert _builds(lambda: rx_stream(cfg, st5, pcm5)) == 2
    _, pcm3 = _inputs(cfg, 4, 3)
    assert _builds(lambda: rx_stream(cfg, st, pcm3)) == 2
    agc = ModemConfig(agc=True)
    st_agc, _ = _inputs(agc, 4, 2)
    assert _builds(lambda: rx_stream(agc, st_agc, pcm)) == 2
    assert _builds(lambda: rx_stream(agc, st_agc, pcm)) == 0
    launch = {tm: (lambda tm=tm: frontend_kernel._launch(
        cfg, pcm, st.nco_phase, st.fir_tail, st.decim_delay if tm else None))
        for tm in (True, False)}
    # the time-major launch's plan is the first rx_stream call's
    assert [_builds(launch[True]), _builds(launch[False]),
            _builds(launch[True]), _builds(launch[False])] == [0, 1, 0, 0]


def test_plans_kept_are_the_last_used(rec):
    """``_lib.plan`` keeps the ``_PLANS_KEPT`` plans used last: a caller
    whose geometry changes from call to call holds no more, and a plan in
    use is not the one let go."""
    kept = _lib._PLANS_KEPT
    for c in range(1, kept + 1):
        _lib.plan(("geometry", c), lambda: object())
    first = _lib.plan(("geometry", 1), lambda: object())   # used again
    assert _builds(lambda: _lib.plan(("geometry", kept + 1),
                                     lambda: object())) == 1
    assert len(_lib._plans) == kept
    assert ("geometry", 2) not in _lib._plans
    assert _lib.plan(("geometry", 1), lambda: object()) is first
    assert _builds(lambda: _lib.plan(("geometry", 2), lambda: object())) == 1


def _wrong(t, how):
    """``t`` as a tensor the kernels do not take: of another shape, dtype,
    device, or not contiguous."""
    if how == "shape":
        return t.unsqueeze(-1)
    if how == "dtype":
        return t.double()
    if how == "device":
        return torch.empty_like(t, device="meta")
    return torch.stack([t, t], dim=-1)[..., 0]


@pytest.mark.parametrize("how", ["shape", "dtype", "device", "contiguity"])
@pytest.mark.parametrize("leaf", ["nco_phase", "fir_tail", "decim_delay",
                                  "costas"])
def test_planned_call_checks_what_the_kernels_read(rec, leaf, how):
    """A planned ``rx_stream`` call given a state tensor the kernels read
    by pointer that is of the wrong shape, dtype, device or contiguity
    raises the wrappers' ``ValueError``, naming the tensor, before its
    kernel's launch (the loop's state after the front-end's); so does the
    PCM.  A leaf whose channel axis is not the PCM's raises the fold's."""
    cfg = ModemConfig()
    st, pcm = _inputs(cfg, 3, 2)
    rx_stream(cfg, st, pcm)                          # the plan's build
    if leaf == "costas":
        bad = st._replace(costas=st.costas._replace(
            freq=_wrong(st.costas.freq, how)))
        name = "state.freq"
    else:
        part = getattr(st, leaf)
        bad = st._replace(**{leaf: CF32(part.re, _wrong(part.im, how))})
        name = f"{leaf}.im"
    rec.calls.clear()
    with pytest.raises(ValueError, match=rf"{name}: the kernel takes a "
                       rf"contiguous torch.float32 tensor"):
        rx_stream(cfg, bad, pcm)
    assert [n for n, _ in rec.calls] == (["qpsk_frontend_pipe"]
                                         if leaf == "costas" else [])
    rec.calls.clear()
    with pytest.raises(ValueError, match=r"pcm: the kernel takes a "
                       r"contiguous torch.int16 tensor"):
        rx_stream(cfg, st, pcm.to(torch.int32))
    _, pcm4 = _inputs(cfg, 4, 2)
    with pytest.raises(ValueError, match=r"a state leaf of shape \(3,"):
        rx_stream(cfg, st, pcm4)
    assert rec.calls == []


def test_plain_switches_take_no_plan(rec):
    """A lowering switch off the kernels (``costas_impl="scan"``) takes
    no plan for it: the front-end wrapper's plan and launch, the plain
    loop."""
    cfg = dataclasses.replace(ModemConfig(), costas_impl="scan")
    st, pcm = _inputs(cfg, 3, 2)
    _, calls = _calls(rec, lambda: rx_stream(cfg, st, pcm))
    assert [n for n, _ in calls] == ["qpsk_frontend_pipe"]
    assert list(_lib._plans)[0][0] == "frontend"
