#!/usr/bin/env python3
"""Times of the torch port's kernels through their wrappers, on one NVIDIA
GPU: the two FEC decoders at the batch sizes the coded paths give them,
and the Costas loop, RX front-end and TX at the receiver's rate point
(8192 channels x 8 frames of 512 samples, 1024 symbols a channel).

    python3 fec_times.py [ROOT] [--fec | --modem | --gen | --gen-modem]

ROOT is a checkout of this repository (default: the directory of this
script).  The script imports ``qpsk_tpu_torch`` from ROOT, builds its
kernels and calls only the wrappers' public signatures, so one copy of it
can time two checkouts in one call, each in a process of its own, to
compare two commits on the same card:

    python3 fec_times.py archive/parent; python3 fec_times.py

``--fec`` times only the decoders, ``--modem`` only the Costas loop, the
front-end, TX and the default receive call, ``--gen`` only the decoders'
general instances, ``--gen-modem`` only the front-end's and TX's; with
none of them it times the first two.

General modem instances (``--gen-modem``): ``rx_frontend_tm`` and
``rx_frontend`` at phase 8b's shapes of ``chip_smoke.py`` (256 channels x
8 frames of noise PCM: time-major at 4096-sample frames, with the AGC
power output at 1536, channel-major at 3 samples per symbol and 384; and
time-major at 16 samples per symbol and at 2, both at 2048) and
``tx_modulate`` at 256 channels x 4096 symbols (16 samples per symbol;
255 taps at 8; 131 at 4), each twice alone in a CUDA graph and once
launched from the host; beside them the fast instances at the rate
point (the time-major front-end and TX at 4 samples per symbol), which
the same A/B should show unmoved:

    python3 fec_times.py archive/parent --gen-modem; python3 fec_times.py --gen-modem

General instances (``--gen``): ``viterbi_decode`` at codes other than K=7
rate 1/2 (K 5, 7, 9, 11 and 15, rates 1/2, 1/4 and 1/8, with and without
taps at both ends) and ``ldpc_decode`` at variable degrees 2 and 4-8, on
random LLRs of 256-bit packets at 156 and 4096 packets (K=15 at 156),
each time taken as the decoders' are: twice alone in a CUDA graph, once
launched from the host.  Only the public signatures are called, so a
checkout from before the instances changed times the same calls:

    python3 fec_times.py archive/parent --gen; python3 fec_times.py --gen

Decoders: ``viterbi_decode`` and ``ldpc_decode`` on random LLRs at 156
packets (a channel's tracked extraction), 4096 (the rate point of
``chip_smoke.py``) and 16 768 (a channel's sync hunt), Viterbi also 67 072
(the 8PSK hunt).  Each time is taken twice as the kernel alone (20
launches captured into a CUDA graph, replayed 10 times between CUDA
events, so the host's launch rate does not bound a kernel of a few
microseconds) and once launched from the host (CUDA events around 50
wrapper calls).

Modem kernels: the front-end's four launches (time-major, time-major with
the AGC power output, channel-major at 4 and at 8 samples per symbol) on
noise PCM, the Costas loop's modes (QPSK, gear, gains,
decision-directed BPSK, 8PSK and 16QAM with gains) on Gaussian symbols,
and ``tx_modulate`` at 4 and 8 samples per symbol on random QPSK symbols.
Each row gives the wrapper launched from the host (CUDA events around 20
calls after 3 warm-ups), the wrapper alone in a CUDA graph ("null" for a
wrapper that copies to the card, which a graph cannot capture from
pageable host memory), and the kernel alone: the device time per call of
the kernel itself (``costas_tm_kernel``, ``frontend_kernel``,
``tx_kernel``) by
``torch.profiler`` over 10 calls.  Then the default ``rx_stream`` call
(state chained): ms per call by CUDA events, and by ``torch.profiler``
over 5 calls the device operations, the device's busy time (the union of
their intervals), the host-to-device copies and the host's
synchronisations per call.

The last line is one JSON object ``{"card": ..., "root": ..., "ms":
{"viterbi": {"156": [graph, graph, host], ...}, "ldpc": {...}}, "rows":
{name: [host, graph, kernel]}, "rx": {...}, "gen": {code: {"156": [graph,
graph, host], ...}}, "gen_modem": {row: [graph, graph, host]}}`` (the keys
of the groups timed).  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

BATCHES = {"viterbi": (156, 4096, 16768, 67072), "ldpc": (156, 4096, 16768)}
# the general instances' codes: Viterbi (K, generators), LDPC (k, dv), and
# their batches (K = 15 at the first)
GEN_VITERBI = ((5, (0o23, 0o35)), (7, (0o117, 0o127, 0o155, 0o171)),
               (7, (0o132, 0o171)), (9, (0o561, 0o753)),
               (11, (0o3345, 0o3613)), (15, (0o46321, 0o51271)),
               (5, (0o23, 0o35, 0o27, 0o31, 0o37, 0o25, 0o33, 0o21)))
GEN_LDPC = ((256, 2), (256, 4), (256, 5), (256, 6), (256, 7), (192, 8))
GEN_BATCHES = (156, 4096)
# the modem kernels' rate point: channels, frames
C, NFRAMES = 8192, 8


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Mean milliseconds of device time per call of ``fn``: ``launches``
    calls captured into one CUDA graph, replayed ``replays`` times between
    CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def host_ms(fn, iters: int = 50) -> float:
    """Mean milliseconds per call of ``fn`` launched from the host, by
    CUDA events around ``iters`` calls after 3 warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_waits(events) -> int:
    """The host's synchronisations among profiler ``events``; with None,
    those of a window that only synchronises once (the profiler's own and
    the closing one), the baseline to subtract."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if events is None:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
        events = prof.events()
    return sum(e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                          "cudaEventSynchronize")
               for e in events if e.device_type == DeviceType.CPU)


def profiled(fn, calls: int, kernel: str | None = None) -> dict:
    """``torch.profiler`` over ``calls`` calls of ``fn`` after 3 warm-ups:
    per call, the device time of the kernels whose name holds ``kernel``,
    the device operations, the busy time, HtoD copies and host waits."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    ops = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == DeviceType.CUDA)
    busy, reach = 0.0, ops[0][0] if ops else 0.0
    for start, end, _ in ops:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    waits = host_waits(events) - host_waits(None)
    return {"kernel_ms": sum(end - start for start, end, name in ops
                             if kernel and kernel in name) / calls / 1e3,
            "ops": len(ops) / calls, "busy_ms": busy / calls / 1e3,
            "htod": sum("HtoD" in name for _, _, name in ops) / calls,
            "waits": max(0, waits) / calls}




def decoder_times(dev) -> dict:
    """{decoder: {batch: [graph ms, graph ms, host ms]}} on random LLRs."""
    import torch
    from qpsk_tpu_torch.ops.cuda import ldpc_kernel as lk
    from qpsk_tpu_torch.ops.cuda import viterbi_kernel as vk
    from qpsk_tpu_torch.packet import ConvCode, LdpcCode

    conv, ldpc = ConvCode(), LdpcCode(k=256)
    decoders = {"viterbi": (524, lambda x: vk.viterbi_decode(conv, x, 256)),
                "ldpc": (512, lambda x: lk.ldpc_decode(ldpc, x))}
    gen = torch.Generator(device=dev).manual_seed(23)
    out = {}
    for name, (n, decode) in decoders.items():
        out[name] = {}
        for b in BATCHES[name]:
            llrs = torch.randn((b, n), generator=gen, device=dev)
            times = [graph_ms(lambda: decode(llrs)), graph_ms(lambda: decode(llrs)),
                     host_ms(lambda: decode(llrs))]
            out[name][str(b)] = times
            print(f"  {name:8s} at {b:5d} packets: kernel alone {times[0]:.4f} / "
                  f"{times[1]:.4f} ms, launched from the host {times[2]:.4f} ms")
    return out


def general_times(dev) -> dict:
    """{code: {batch: [graph ms, graph ms, host ms]}} of the decoders'
    general instances on random LLRs, through the public wrappers."""
    import torch
    from qpsk_tpu_torch.packet import ConvCode, LdpcCode
    from qpsk_tpu_torch.packet.fec import viterbi_decode
    from qpsk_tpu_torch.packet.ldpc import ldpc_decode

    nbits = 256
    decoders = {}
    for k, polys in GEN_VITERBI:
        code = ConvCode(k, polys)
        decoders[f"viterbi K={k} {'/'.join(f'{g:o}' for g in polys)}"] = (
            code.rate_den * (nbits + k - 1),
            lambda x, code=code: viterbi_decode(code, x, nbits),
            GEN_BATCHES[:1] if k >= 15 else GEN_BATCHES)
    for k, dv in GEN_LDPC:
        code = LdpcCode(k, dv=dv)
        decoders[f"ldpc k={k} dv={dv}"] = (
            code.n, lambda x, code=code: ldpc_decode(code, x), GEN_BATCHES)
    gen = torch.Generator(device=dev).manual_seed(31)
    out = {}
    for name, (n, decode, batches) in decoders.items():
        out[name] = {}
        for b in batches:
            llrs = torch.randn((b, n), generator=gen, device=dev)
            times = [graph_ms(lambda: decode(llrs)),
                     graph_ms(lambda: decode(llrs)),
                     host_ms(lambda: decode(llrs))]
            out[name][str(b)] = times
            print(f"  {name:30s} at {b:4d} packets: kernel alone "
                  f"{times[0]:.4f} / {times[1]:.4f} ms, launched from the host "
                  f"{times[2]:.4f} ms")
    return out


# the general modem rows of --gen-modem: name -> (launch, config fields,
# channels, frames or symbols); the first four are phase 8b's timed shapes
GEN_MODEM = (("frontend_gen", "tm", dict(frame_size=4096), 256, 8),
             ("frontend_gen_power", "tm", dict(frame_size=1536, agc=True),
              256, 8),
             ("frontend_cm_gen", "cm", dict(rs=3200.0, frame_size=384), 256, 8),
             ("tx_gen", "tx", dict(rs=600.0, frame_size=2048), 256, 4096),
             ("frontend_gen cyc16 2048", "tm", dict(rs=600.0, frame_size=2048),
              256, 8),
             ("frontend_gen cyc2 2048", "tm", dict(rs=4800.0, frame_size=2048),
              256, 8),
             ("tx_gen ntaps255 cyc8", "tx", dict(rs=1200.0, ntaps=255), 256,
              4096),
             ("tx_gen ntaps131 cyc4", "tx", dict(ntaps=131), 256, 4096),
             ("frontend_tm (fast)", "tm", {}, C, NFRAMES),
             ("tx (fast)", "tx", {}, C, NFRAMES * 128))


def modem_general_times(dev) -> dict:
    """{row: [graph ms, graph ms, host ms]} of ``GEN_MODEM`` through the
    public wrappers."""
    import torch
    from qpsk_tpu_torch import ModemConfig, rx_init, tx_init
    from qpsk_tpu_torch.ops.cplx import CF32
    from qpsk_tpu_torch.ops.cuda import frontend_kernel as fk
    from qpsk_tpu_torch.ops.cuda import tx_kernel as tk
    from qpsk_tpu_torch.ops.modmap import bits_to_symbols

    gen = torch.Generator(device=dev).manual_seed(37)
    out = {}
    for name, kind, fields, c, n in GEN_MODEM:
        cfg = ModemConfig(**fields)
        if kind == "tx":
            sym = bits_to_symbols(torch.randint(0, 2, (c, 2 * n), generator=gen,
                                                device=dev, dtype=torch.int32))
            sym = CF32(sym.re.contiguous(), sym.im.contiguous())
            ts = tx_init(cfg, (c,), device=dev)
            fn = (lambda cfg=cfg, sym=sym, ts=ts: tk.tx_modulate(
                cfg, sym, ts.nco_phase, ts.fir_tail, 50.0))
        else:
            pcm = (torch.randn((c, n, cfg.frame_size), generator=gen,
                               device=dev) * 8000.0).to(torch.int16)
            st = rx_init(cfg, (c,), device=dev)
            fn = ((lambda cfg=cfg, pcm=pcm, st=st: fk.rx_frontend(
                cfg, pcm, st.nco_phase, st.fir_tail)) if kind == "cm" else
                  (lambda cfg=cfg, pcm=pcm, st=st: fk.rx_frontend_tm(
                      cfg, pcm, st.nco_phase, st.fir_tail, st.decim_delay)))
        times = [graph_ms(fn), graph_ms(fn), host_ms(fn)]
        out[name] = times
        print(f"  {name:26s} {c:5d} x {n:5d}: alone in a CUDA graph "
              f"{times[0]:.4f} / {times[1]:.4f} ms, launched from the host "
              f"{times[2]:.4f} ms")
    return out


def modem_times(dev) -> tuple:
    """({row: [host ms, graph ms or None, kernel ms]}, {default rx_stream
    call's ms, ops, busy_ms, htod, waits}) at the rate point."""
    import torch
    from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream, tx_init
    from qpsk_tpu_torch.config import config_1200
    from qpsk_tpu_torch.ops.costas import costas_init, costas_params, gear_for
    from qpsk_tpu_torch.ops.cplx import CF32
    from qpsk_tpu_torch.ops.cuda import costas_kernel as ck
    from qpsk_tpu_torch.ops.cuda import frontend_kernel as fk
    from qpsk_tpu_torch.ops.cuda import tx_kernel as tk
    from qpsk_tpu_torch.ops.modmap import bits_to_symbols

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(29)
    base, agc, slow = ModemConfig(), ModemConfig(agc=True), config_1200()

    def noise(cfg):
        return (torch.randn((C, NFRAMES, cfg.frame_size), generator=gen,
                            device=dev) * 8000.0).to(torch.int16)
    pcm4, pcm8 = noise(base), noise(slow)
    st = rx_init(base, (C,), device=dev)
    t = NFRAMES * base.symbols_per_frame
    zr, zi = (torch.randn((t, C), generator=gen, device=dev) for _ in range(2))
    gains = torch.rand((NFRAMES, C), generator=gen, device=dev) * 1.5 + 0.5
    params = costas_params(base.loop_bw, base.damping, base.min_freq,
                           base.max_freq)
    gear = gear_for(2.0 * math.pi / 200.0, base.damping)
    cs, cs_gear = costas_init((C,), device=dev), costas_init((C,), gear=True,
                                                             device=dev)
    a = base.agc_target

    def costas(state, kw, scale=1.0):
        x, y = zr * scale, zi * scale
        return lambda: ck.costas_run_tm(state, x, y, params, 128, **kw)
    rows = {
        "frontend_tm": (lambda: fk.rx_frontend_tm(
            base, pcm4, st.nco_phase, st.fir_tail, st.decim_delay), "frontend_kernel"),
        "frontend_tm_power": (lambda: fk.rx_frontend_tm(
            agc, pcm4, st.nco_phase, st.fir_tail, st.decim_delay), "frontend_kernel"),
        "frontend_cm4": (lambda: fk.rx_frontend(
            base, pcm4, st.nco_phase, st.fir_tail), "frontend_kernel"),
        "frontend_cm8": (lambda: fk.rx_frontend(
            slow, pcm8, st.nco_phase, st.fir_tail), "frontend_kernel"),
        "costas": (costas(cs, {}), "costas_tm_kernel"),
        "costas_gear": (costas(cs_gear, dict(gear=gear)), "costas_tm_kernel"),
        "costas_gains": (costas(cs, dict(gains=gains)), "costas_tm_kernel"),
        "costas_dd_bpsk": (costas(cs, dict(dd=("bpsk", a)), a), "costas_tm_kernel"),
        "costas_dd_8psk": (costas(cs, dict(dd=("8psk", a)), a), "costas_tm_kernel"),
        "costas_dd_16qam": (costas(cs, dict(dd=("16qam", a), gains=gains), a),
                            "costas_tm_kernel"),
    }

    def tx(cfg):
        s = NFRAMES * cfg.symbols_per_frame
        sym = bits_to_symbols(torch.randint(0, 2, (C, 2 * s), generator=gen,
                                            device=dev, dtype=torch.int32))
        sym = CF32(sym.re.contiguous(), sym.im.contiguous())
        ts = tx_init(cfg, (C,), device=dev)
        args = (cfg, sym, ts.nco_phase, ts.fir_tail, 50.0)
        return lambda: tk.tx_modulate(*args)
    rows["tx"] = (tx(base), "tx_kernel")
    rows["tx_1200"] = (tx(slow), "tx_kernel")
    out = {}
    for name, (fn, kernel) in rows.items():
        host = host_ms(fn, 20)
        prof = profiled(fn, 10, kernel)
        alone = prof["kernel_ms"]
        # a copy from pageable host memory cannot be captured into a graph
        graph = None if prof["htod"] else graph_ms(fn)
        out[name] = [host, graph, alone]
        print(f"  {name:18s} wrapper {host:.4f} ms, in a CUDA graph "
              f"{'null' if graph is None else f'{graph:.4f}'} ms, kernel "
              f"alone {alone:.4f} ms")

    state = [rx_init(base, (C,), device=dev)]

    def step():
        state[0], _ = rx_stream(base, state[0], pcm4)
    rx = profiled(step, 5)
    rx.pop("kernel_ms")
    rx["ms"] = host_ms(step, 20)
    print(f"  rx_stream default: {rx['ms']:.4f} ms a call; {rx['ops']:g} device "
          f"operations, busy {rx['busy_ms']:.4f} ms, {rx['htod']:g} HtoD "
          f"copies, {rx['waits']:g} host waits a call")
    return out, rx


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fec_times: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    groups = ({"--fec", "--modem", "--gen", "--gen-modem"} & set(args)
              or {"--fec", "--modem"})
    paths = [a for a in args if not a.startswith("--")]
    root = os.path.abspath(paths[0] if paths
                           else os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from qpsk_tpu_torch.ops.cuda import _lib

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; kernels of {root}")
    _lib.library()
    dev = torch.device("cuda", 0)
    result = {"card": card, "root": root}
    if "--fec" in groups:
        result["ms"] = decoder_times(dev)
    if "--modem" in groups:
        result["rows"], result["rx"] = modem_times(dev)
    if "--gen" in groups:
        result["gen"] = general_times(dev)
    if "--gen-modem" in groups:
        result["gen_modem"] = modem_general_times(dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
