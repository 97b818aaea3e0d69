"""Throughput and latency benchmarks (port of the single-card suites of
``qpsk_tpu.benchmarks``, with the same function names, arguments and
record keys).

Each suite runs on the card unless it is given ``device="cpu"``; asked for
the card where there is none, it raises rather than run on the CPU.  Its
record names where it ran: ``platform`` ("gpu" or "cpu") and ``card``
(``nvidia-smi``'s name and power limit, or "cpu").  The JAX records'
``vs_baseline``, a share of a TPU target, is dropped.

Measurement:

* inputs are made on the device from a seed, so no host upload is timed;
* ``iters * inner`` chained calls, the state carried from call to call,
  are timed in one window after a few warm-up calls (which also build the
  kernels): between two CUDA events on the card, by the host clock on the
  CPU;
* each call folds a checksum of its output into a carried scalar, and
  where the JAX suites vary the input with that carry (the FEC decode,
  the block-parallel receive) so do these.

Sizes default to the JAX package's TPU operating points on the card (RX
8192 channels x 8 frames, FEC 4096 packets, block-parallel 512 frames x
128 blocks, ...) and to its CPU sizes on the CPU.  On the card the rate
records carry ``utils/roofline.py``'s reports where the JAX suites attach
theirs on the TPU.

The scale-out records (``scaling_efficiency``, ``sp_bound_record``,
``sp_scaling_decomposition``) run in a ``torch.distributed`` group, one
process a card (``parallel/multihost.py``; with no group up, a one-rank
group is started).  Every rank calls them; a count of ``n`` devices runs
on the group's first ``n`` ranks.  A barrier stands before and after each
timed window, a rank's time is its own (CUDA events on the card), and the
record's time is the largest over the ranks.  Rank 0 returns the records,
the other ranks ``[]``.  ``rx_throughput`` in a group of more than one
rank shards its channels over the group (``parallel.channels``) and sums
its checksum over it.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to measure the "
                           "CPU")
    if dev.type == "cuda" and dev.index is None:
        # the process's card: a rank's own in a group
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _platform(dev: torch.device) -> str:
    return "gpu" if dev.type == "cuda" else "cpu"


def _card(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        return out[dev.index or 0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(dev)


def _on_card(dev: torch.device) -> bool:
    return dev.type == "cuda"


def _sizes(dev: torch.device, card: tuple, cpu: tuple, given: tuple) -> tuple:
    """Each of ``given`` that was passed, else the card's or the CPU's
    default."""
    base = card if _on_card(dev) else cpu
    return tuple(g or b for g, b in zip(given, base))


def _timed(step, calls: int, dev: torch.device, group=None) -> float:
    """Seconds of ``calls`` chained ``step()`` calls after warm-up calls
    (3 on the card, which also build the kernels; 1 on the CPU).  With a
    process ``group``, a barrier stands before and after the window and
    the time is the largest over the group's ranks."""
    for _ in range(3 if _on_card(dev) else 1):
        step()
    if _on_card(dev):
        torch.cuda.synchronize(dev)
    if group is not None:
        dist.barrier(group=group)
    if _on_card(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            step()
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(calls):
            step()
        dt = time.perf_counter() - t0
    if group is None:
        return dt
    dist.barrier(group=group)
    t = torch.tensor([dt], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t.item())


def _noise_pcm(shape, dev: torch.device, seed: int = 0) -> torch.Tensor:
    """Gaussian int16 PCM at an RMS of 8000, made on the device."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=dev) * 8000.0).to(
        torch.int16)


def tx_throughput(channels: int | None = None, frames: int | None = None,
                  iters: int | None = None, inner: int | None = None,
                  cfg=None, device="cuda") -> dict:
    """Aggregate TX modulation rate (map + zero-stuff + RRC + mix + PCM)
    of ``tx_stream`` in samples/s, the state chained."""
    from qpsk_tpu_torch import ModemConfig, tx_init, tx_stream

    cfg = cfg or ModemConfig()
    dev = _device(device)
    channels, frames, iters, inner = _sizes(
        dev, (2048, 16, 60, 10), (16, 4, 3, 2),
        (channels, frames, iters, inner))
    nsamples = channels * frames * cfg.frame_size
    gen = torch.Generator(device=dev).manual_seed(0)
    bits = torch.randint(0, 2, (channels, frames, cfg.bits_per_frame),
                         generator=gen, device=dev, dtype=torch.int32)
    carry = {"st": tx_init(cfg, (channels,), device=dev),
             "acc": torch.zeros((), dtype=torch.int64, device=dev)}

    def step():
        carry["st"], pcm = tx_stream(cfg, carry["st"], bits, tx_offset_hz=50.0)
        carry["acc"] += pcm.to(torch.int32).sum()

    dt = _timed(step, iters * inner, dev)
    return {"metric": "tx_mod_throughput",
            "value": round(nsamples * inner * iters / dt, 1),
            "unit": "samples/s", "platform": _platform(dev),
            "channels": channels, "card": _card(dev)}


def _rx_chained(cfg, dev, pcm, channels):
    """A ``step()`` of chained ``rx_stream`` calls on ``pcm``, its bits
    summed into a carried scalar."""
    from qpsk_tpu_torch import rx_init, rx_stream

    carry = {"st": rx_init(cfg, (channels,) if channels else (), device=dev),
             "acc": torch.zeros((), dtype=torch.int64, device=dev)}

    def step():
        carry["st"], out = rx_stream(cfg, carry["st"], pcm)
        carry["acc"] += out.bits.sum()
    return step


def rx_throughput(channels: int | None = None, frames: int | None = None,
                  iters: int | None = None, inner: int | None = None,
                  cfg=None, device="cuda") -> dict:
    """Aggregate demodulation rate of ``rx_stream`` (matched filter,
    timing, decimation, Costas, slicing) in samples/s, channels on the
    batch axis, the state chained; on the card with
    ``roofline.composed_rx_report`` (of one card's channels).  In a
    process group of more than one rank, the ``channels`` are sharded over
    its ranks (``parallel.channels.make_channel_demod``), each call's
    checksum is summed over them, and the rate is the group's."""
    from qpsk_tpu_torch import ModemConfig

    cfg = cfg or ModemConfig()
    dev = _device(device)
    channels, frames, iters, inner = _sizes(
        dev, (8192, 8, 60, 10), (16, 4, 3, 2),
        (channels, frames, iters, inner))
    nsamples = channels * frames * cfg.frame_size
    ndev = dist.get_world_size() if dist.is_initialized() else 1
    if ndev > 1:
        # raises for a group whose backend is not the device's
        dev, _, _ = _scale_group(dev)
    pcm = _noise_pcm((channels, frames, cfg.frame_size), dev)
    if ndev > 1:
        from qpsk_tpu_torch.parallel.channels import (init_channels,
                                                      make_channel_demod)
        from qpsk_tpu_torch.parallel.multihost import global_mesh
        mesh = global_mesh(("dp",), device=dev)
        group = mesh.get_group("dp")
        demod = make_channel_demod(cfg, mesh)
        carry = {"st": init_channels(cfg, channels, mesh),
                 "acc": torch.zeros((), dtype=torch.int64, device=dev)}

        def step():
            carry["st"], out = demod(carry["st"], pcm)
            acc = out.bits.sum()
            dist.all_reduce(acc, group=group)
            carry["acc"] += acc
        dt = _timed(step, iters * inner, dev, group)
    else:
        dt = _timed(_rx_chained(cfg, dev, pcm, channels), iters * inner, dev)
    rec = {"metric": "rx_demod_throughput",
           "value": round(nsamples * inner * iters / dt, 1),
           "unit": "samples/s", "platform": _platform(dev), "devices": ndev,
           "channels": channels, "card": _card(dev)}
    if cfg.modulation != "qpsk":
        rec["modulation"] = cfg.modulation
    if _on_card(dev):
        from qpsk_tpu_torch.utils.roofline import composed_rx_report
        rec.update(composed_rx_report(cfg, channels // ndev, frames,
                                      measured_s=dt / (iters * inner)))
    return rec


def frontend_throughput(impl: str = "pallas", channels: int | None = None,
                        frames: int | None = None, iters: int | None = None,
                        inner: int | None = None, device="cuda") -> dict:
    """Front-end-only rate (int16 -> matched filter -> timing -> decimate)
    of one lowering: ``impl="pallas"`` the channel-major kernel
    (``frontend_kernel.rx_frontend``; its plain version on CPU tensors),
    ``"xla"`` the staged plain chain (``frontend_kernel.frontend_xla``).
    ``roofline`` is ``roofline.frontend_report`` on the card; on the CPU
    it is None (the H100's roofline says nothing of a CPU time)."""
    from qpsk_tpu_torch import ModemConfig, rx_init
    from qpsk_tpu_torch.ops.cuda import frontend_kernel as fk
    from qpsk_tpu_torch.utils.roofline import frontend_report

    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown impl {impl!r}")
    cfg = ModemConfig()
    dev = _device(device)
    channels, frames, iters, inner = _sizes(
        dev, (2048, 16, 60, 10), (16, 4, 3, 2),
        (channels, frames, iters, inner))
    nsamples = channels * frames * cfg.frame_size
    pcm = _noise_pcm((channels, frames, cfg.frame_size), dev)
    st = rx_init(cfg, (channels,), device=dev)
    fn = fk.rx_frontend if impl == "pallas" else fk.frontend_xla
    carry = {"phase": st.nco_phase, "tail": st.fir_tail,
             "acc": torch.zeros((), dtype=torch.float32, device=dev)}

    def step():
        picks, idx, carry["phase"], carry["tail"] = fn(
            cfg, pcm, carry["phase"], carry["tail"])
        carry["acc"] += picks.re.sum() + idx.to(torch.float32).sum()

    dt = _timed(step, iters * inner, dev)
    rec = {"metric": f"frontend_throughput_{impl}",
           "value": round(nsamples * inner * iters / dt, 1),
           "unit": "samples/s", "platform": _platform(dev),
           "channels": channels, "card": _card(dev)}
    rec["roofline"] = (frontend_report(cfg, channels, frames,
                                       dt / (inner * iters), impl)
                       if _on_card(dev) else None)
    return rec


def fdm_throughput(nslots: int | None = None, frames: int | None = None,
                   iters: int | None = None, inner: int | None = None,
                   device="cuda") -> dict:
    """Wideband receive rate: the polyphase-DFT analysis filterbank
    (``fdm_demux_stream``) + ``rx_stream`` over every subchannel, in
    wideband samples/s, with the filterbank-only and modem-only rates at
    the same shapes beside it."""
    from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream
    from qpsk_tpu_torch.fdm import FdmConfig, fdm_demux_stream, fdm_init

    cfg = ModemConfig()
    dev = _device(device)
    nslots, frames, iters, inner = _sizes(
        dev, (2048, 8, 40, 8), (8, 4, 2, 2), (nslots, frames, iters, inner))
    fcfg = FdmConfig(nslots=nslots)
    nchan = fcfg.nchan
    nwide = nslots * frames * cfg.frame_size
    wide = _noise_pcm((nwide,), dev)
    carry = {"fb": fdm_init(fcfg, dev),
             "rx": rx_init(cfg, (nchan,), device=dev),
             "acc": torch.zeros((), dtype=torch.float64, device=dev)}

    def composed():
        chans, carry["fb"] = fdm_demux_stream(fcfg, wide, carry["fb"])
        carry["rx"], out = rx_stream(
            cfg, carry["rx"], chans.reshape(nchan, frames, cfg.frame_size))
        carry["acc"] += out.bits.sum()

    def bank():
        chans, carry["fb"] = fdm_demux_stream(fcfg, wide, carry["fb"])
        carry["acc"] += chans[:, -1].sum()

    chans0, _ = fdm_demux_stream(fcfg, wide, fdm_init(fcfg, dev))
    chans0 = chans0.reshape(nchan, frames, cfg.frame_size)

    def modem():
        carry["rx"], out = rx_stream(cfg, carry["rx"], chans0)
        carry["acc"] += out.bits.sum()

    calls = iters * inner
    dt = _timed(composed, calls, dev)
    dt_fb = _timed(bank, calls, dev)
    dt_md = _timed(modem, calls, dev)
    sps = nwide * calls / dt
    fb_frac = dt_fb / (dt_fb + dt_md)
    rec = {"metric": "fdm_wideband_throughput", "value": round(sps, 1),
           "unit": "wide_samples/s", "platform": _platform(dev),
           "nslots": nslots, "nchan": nchan, "card": _card(dev)}
    # the Costas kernel runs 32 channels a block (one warp): the share of
    # its channel tiles the subchannels fill
    rec["fdm"] = {
        "fb_only_gsps": round(nwide * calls / dt_fb / 1e9, 4),
        "modem_only_gsps": round(nwide * calls / dt_md / 1e9, 4),
        "composed_gsps": round(sps / 1e9, 4),
        "fb_fraction": round(fb_frac, 3),
        "lane_occupancy": round(nchan / (32 * -(-nchan // 32)), 3),
        "bound": "filterbank" if fb_frac > 0.5 else "modem-batch",
    }
    return rec


def costas_throughput(impl: str = "pallas", channels: int | None = None,
                      nsym: int | None = None, iters: int | None = None,
                      inner: int | None = None, device="cuda") -> dict:
    """Costas-loop-only rate in symbols/s of one lowering: ``"pallas"``
    the kernel alone in its native time-major layout
    (``costas_kernel.costas_run_tm``, its plain version on CPU tensors),
    ``"scan"`` the plain loop (``ops.costas.costas_run``) on the same
    device.  Channels ride the kernel's threads; the recurrence is the
    serial axis.  On the card the kernel's record carries
    ``roofline.costas_report``.  The plain loop is one host launch chain a
    symbol, so on the card it defaults to one call."""
    from qpsk_tpu_torch.ops.costas import (costas_init, costas_params,
                                           costas_run)
    from qpsk_tpu_torch.ops.cplx import CF32
    from qpsk_tpu_torch.ops.cuda import costas_kernel as ck

    if impl not in ("pallas", "scan"):
        raise ValueError(f"unknown impl {impl!r}")
    dev = _device(device)
    card_iters = (60, 10) if impl == "pallas" else (1, 1)
    channels, nsym, iters, inner = _sizes(
        dev, (2048, 2048) + card_iters, (128, 128, 2, 2),
        (channels, nsym, iters, inner))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = costas_params(loop_bw=2.0 * np.pi / 100.0)
    carry = {"st": costas_init((channels,), device=dev),
             "acc": torch.zeros((), dtype=torch.float32, device=dev)}
    if impl == "pallas":
        zr = torch.randn((nsym, channels), generator=gen, device=dev)
        zi = torch.randn((nsym, channels), generator=gen, device=dev)

        def step():
            carry["st"], derot, _, _ = ck.costas_run_tm(carry["st"], zr, zi,
                                                        params, nsym)
            carry["acc"] += derot.re[-1].sum()
    else:
        z = CF32(torch.randn((channels, nsym), generator=gen, device=dev),
                 torch.randn((channels, nsym), generator=gen, device=dev))

        def step():
            carry["st"], derot = costas_run(carry["st"], z, params)
            carry["acc"] += derot.re[..., -1].sum()

    dt = _timed(step, iters * inner, dev)
    rec = {"metric": f"costas_throughput_{impl}",
           "value": round(channels * nsym * inner * iters / dt, 1),
           "unit": "symbols/s", "platform": _platform(dev),
           "channels": channels, "nsym": nsym, "card": _card(dev)}
    if impl == "pallas" and _on_card(dev):
        from qpsk_tpu_torch.utils.roofline import costas_report
        rec["costas"] = costas_report(channels, nsym,
                                      measured_pass_s=dt / (iters * inner))
    return rec


def fec_throughput(kind: str = "conv", packets: int | None = None,
                   iters: int | None = None, inner: int | None = None,
                   device="cuda") -> dict:
    """Soft-decision decoder rate in information bits/s at the coded
    link's packet (30 bytes + CRC: 256 bits), packets batched:
    ``kind="conv"`` the K=7 Viterbi, ``"ldpc"`` the IRA min-sum.  The
    LLRs move with the carried checksum, so no call repeats the last.  On
    the card with ``roofline.viterbi_report`` / ``ldpc_report``."""
    dev = _device(device)
    packets, iters, inner = _sizes(dev, (4096, 30, 4), (32, 2, 2),
                                   (packets, iters, inner))
    gen = torch.Generator(device=dev).manual_seed(0)
    if kind == "conv":
        from qpsk_tpu_torch.packet.fec import ConvCode, viterbi_decode
        code = ConvCode()
        nbits = 256
        llrs = torch.randn((packets, code.coded_bits(nbits)), generator=gen,
                           device=dev)

        def decode(x):
            return viterbi_decode(code, x, nbits)
    elif kind == "ldpc":
        from qpsk_tpu_torch.packet.ldpc import LdpcCode, ldpc_decode
        code = LdpcCode(k=256)
        nbits = code.k
        llrs = torch.randn((packets, code.n), generator=gen, device=dev)

        def decode(x):
            return ldpc_decode(code, x)
    else:
        raise ValueError(f"unknown FEC kind {kind!r}")
    acc = {"a": torch.zeros((), dtype=torch.int64, device=dev)}

    def step():
        bits = decode(llrs + acc["a"].to(torch.float32) * 1e-9)
        acc["a"] += bits.sum()

    dt = _timed(step, iters * inner, dev)
    rec = {"metric": f"fec_throughput_{kind}",
           "value": round(packets * nbits * inner * iters / dt, 1),
           "unit": "info_bits/s", "platform": _platform(dev),
           "packets": packets, "nbits": nbits, "card": _card(dev)}
    if _on_card(dev):
        from qpsk_tpu_torch.utils.roofline import ldpc_report, viterbi_report
        per_call = dt / (iters * inner)
        rec.update(ldpc_report(code, packets, per_call) if kind == "ldpc"
                   else viterbi_report(nbits + code.constraint - 1,
                                       code.nstates, packets, per_call))
    return rec


def coded_rx_throughput(kind: str = "conv", channels: int | None = None,
                        frames: int | None = None, iters: int | None = None,
                        inner: int | None = None, payload_bytes: int = 30,
                        modulation: str = "qpsk", device="cuda") -> dict:
    """Composed coded receive rate: ``rx_stream`` + soft LLRs + deframe +
    FEC decode + CRC in one timed call, in input samples/s, beside the
    demodulation alone at the same shapes.  Every demodulated bit is
    decoded: the call's LLR stream is cut into ceil(bits / frame_bits)
    packets, the last zero-padded.  Random PCM suffices: both decoders
    run a fixed schedule, so the work does not depend on the data."""
    from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream
    from qpsk_tpu_torch.ops import modfam
    from qpsk_tpu_torch.ops.cplx import CF32
    from qpsk_tpu_torch.ops.modmap import demod_soft
    from qpsk_tpu_torch.packet.frame import (PacketConfig,
                                             disassemble_packet_soft)

    cfg = ModemConfig(modulation=modulation, agc=(modulation == "16qam"))
    pcfg = PacketConfig(payload_bytes=payload_bytes, fec=kind)
    dev = _device(device)
    channels, frames, iters, inner = _sizes(
        dev, (1024, 8, 20, 4), (16, 4, 2, 2),
        (channels, frames, iters, inner))
    fsz = cfg.frame_size
    nsym = fsz // cfg.cycles
    nsamples = channels * frames * fsz
    fb = pcfg.frame_bits
    total_bits = channels * frames * nsym * cfg.bits_per_symbol
    npkt = -(-total_bits // fb)
    pad = npkt * fb - total_bits
    pcm = _noise_pcm((channels, frames, fsz), dev)
    carry = {"st": rx_init(cfg, (channels,), device=dev),
             "acc": torch.zeros((), dtype=torch.int64, device=dev)}

    def composed():
        carry["st"], out = rx_stream(cfg, carry["st"], pcm)
        sym = CF32(out.symbols.re.reshape(-1), out.symbols.im.reshape(-1))
        if modulation == "qpsk":
            llr = demod_soft(sym)
        else:
            m = modfam.get(modulation)
            llr = modfam.soft_from_scores(
                modfam.symbol_scores(sym, m, scale=cfg.agc_target), m)
        llr = torch.cat([llr, llr.new_zeros(pad)])
        rx = disassemble_packet_soft(pcfg, llr.reshape(npkt, fb))
        carry["acc"] += rx.payload_bits.sum() + rx.crc_ok.sum()

    calls = iters * inner
    dt = _timed(composed, calls, dev)
    dt_demod = _timed(_rx_chained(cfg, dev, pcm, channels), calls, dev)
    sps = nsamples * calls / dt
    suffix = kind if modulation == "qpsk" else f"{kind}_{modulation}"
    rec = {"metric": f"coded_rx_throughput_{suffix}",
           "value": round(sps, 1), "unit": "samples/s",
           "platform": _platform(dev), "channels": channels,
           "info_bits_per_s": round(npkt * 8 * payload_bytes * calls / dt, 1),
           "packets_per_pass": int(npkt),
           "demod_only_gsps": round(nsamples * calls / dt_demod / 1e9, 2),
           "composed_gsps": round(sps / 1e9, 2),
           "fec_slowdown_x": round(dt / dt_demod, 1),
           "fec_fraction": round((dt - dt_demod) / dt, 3),
           "bound": "fec-decoder" if dt > 2 * dt_demod else "demod",
           "card": _card(dev)}
    if _on_card(dev):
        from qpsk_tpu_torch.utils.roofline import ldpc_report, viterbi_report
        fec_s = max(dt - dt_demod, 1e-12) / calls
        if kind == "conv":
            from qpsk_tpu_torch.packet.fec import ConvCode
            code = ConvCode()
            rec["fec"] = viterbi_report(
                pcfg.payload_crc_bits + code.constraint - 1, code.nstates,
                npkt, measured_s=fec_s)
        else:
            from qpsk_tpu_torch.packet.ldpc import LdpcCode
            rec["fec"] = ldpc_report(LdpcCode(k=pcfg.payload_crc_bits), npkt,
                                     measured_s=fec_s)
    return rec


def single_stream_serial_throughput(frames: int | None = None,
                                    iters: int | None = None,
                                    inner: int | None = None,
                                    device="cuda") -> dict:
    """Single-stream demodulation rate: one channel, the Costas recurrence
    strictly sequential (one kernel thread on the card), the rate a lone
    stream gets without the block-parallel split."""
    from qpsk_tpu_torch import ModemConfig

    cfg = ModemConfig()
    dev = _device(device)
    frames, iters, inner = _sizes(dev, (64, 15, 4), (8, 2, 2),
                                  (frames, iters, inner))
    pcm = _noise_pcm((frames, cfg.frame_size), dev)
    dt = _timed(_rx_chained(cfg, dev, pcm, 0), iters * inner, dev)
    return {"metric": "single_stream_serial_throughput",
            "value": round(frames * cfg.frame_size * inner * iters / dt, 1),
            "unit": "samples/s", "platform": _platform(dev),
            "frames": frames, "card": _card(dev)}


def single_stream_blockparallel_throughput(frames: int | None = None,
                                           nblocks: int | None = None,
                                           iters: int | None = None,
                                           inner: int | None = None,
                                           device="cuda") -> dict:
    """Block-parallel single-stream rate
    (``parallel.rx_stream_blockparallel``): the Costas loop split into
    re-acquiring overlap blocks on the kernel's channel axis.  Each call's
    PCM moves with the carried bit checksum."""
    from qpsk_tpu_torch import ModemConfig
    from qpsk_tpu_torch.parallel.blocks import rx_stream_blockparallel

    cfg = ModemConfig()
    dev = _device(device)
    frames, nblocks, iters, inner = _sizes(
        dev, (512, 128, 60, 8), (16, 4, 2, 2), (frames, nblocks, iters, inner))
    pcm = _noise_pcm((frames, cfg.frame_size), dev)
    acc = {"a": torch.zeros((), dtype=torch.int64, device=dev)}

    def step():
        x = pcm + (acc["a"] & 1).to(torch.int16)
        _, bits, _ = rx_stream_blockparallel(cfg, x, nblocks)
        acc["a"] += bits.sum()

    dt = _timed(step, iters * inner, dev)
    return {"metric": "single_stream_blockparallel_throughput",
            "value": round(frames * cfg.frame_size * inner * iters / dt, 1),
            "unit": "samples/s", "platform": _platform(dev),
            "frames": frames, "nblocks": nblocks, "card": _card(dev)}


def latency_benchmark(bucket_frames: int | None = None,
                      sync_skip_frames: int | None = None,
                      probe_frames: int | None = None,
                      chunk: int | None = None, snr_db: float = 10.0,
                      npkts: int = 80, seed: int = 0,
                      cfg=None, pcfg=None, device="cuda") -> dict:
    """Streaming push-to-packet latency of ``StreamDemodulator``: a TX ->
    AWGN packet stream pushed in ``chunk``-sample pieces (default 480, 50
    ms of audio at 9600 S/s) into a fresh receiver, after one warm-up pass
    over the whole stream.  ``cold_latency_s``: stream seconds consumed
    before the first packet; ``skipped_packets``: the first decoded
    packet's index; ``proc_p50_ms`` / ``proc_p99_ms``: wall time a push
    once synced; ``realtime_factor``: stream seconds over compute seconds;
    ``steady_buffer_s``: a bucket's fill time.  Every decoded payload must
    be one that was sent, bit-exact, or it raises: a latency from a broken
    decode would mean nothing."""
    from qpsk_tpu_torch import ModemConfig, StreamDemodulator, tx_init, tx_stream
    from qpsk_tpu_torch.channel import awgn_pcm
    from qpsk_tpu_torch.packet import PacketConfig, assemble_packet

    cfg = cfg or ModemConfig()
    pcfg = pcfg or PacketConfig(payload_bytes=30)
    dev = _device(device)
    bucket_frames = bucket_frames or 8
    sync_skip_frames = 2 if sync_skip_frames is None else sync_skip_frames
    probe_frames = probe_frames or 4
    chunk = chunk or 480

    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (npkts, 8 * pcfg.payload_bytes),
                           dtype=np.int32)
    chan = assemble_packet(pcfg, torch.from_numpy(payload).to(dev)).reshape(-1)
    mfb = cfg.bits_per_frame
    npad = (-chan.numel()) % mfb
    if npad:
        chan = torch.cat([chan, torch.from_numpy(
            rng.integers(0, 2, (npad,), np.int32)).to(dev)])
    _, pcm = tx_stream(cfg, tx_init(cfg, device=dev), chan.reshape(-1, mfb),
                       tx_offset_hz=50.0)
    sp = float(((pcm.to(torch.float32) / cfg.pcm_scale) ** 2).mean())
    gen = torch.Generator(device=dev).manual_seed(seed)
    pcm = awgn_pcm(gen, pcm, snr_db, sp).reshape(-1).cpu().numpy()

    def receiver():
        return StreamDemodulator(cfg, pcfg, bucket_frames=bucket_frames,
                                 sync_skip_frames=sync_skip_frames,
                                 probe_frames=probe_frames, device=dev)

    # warm-up pass: every shape the stream reaches (buckets, acquisition,
    # the drain's widths) runs once, the kernels are built
    d = receiver()
    for p in range(0, pcm.size, chunk):
        d.push(pcm[p:p + chunk])
    d.flush()

    demod = receiver()
    first_at = first_wall = None
    push_times, got = [], []
    pos, wall = 0, 0.0
    while pos < pcm.size:
        t0 = time.perf_counter()
        pkts = demod.push(pcm[pos:pos + chunk])
        dt = time.perf_counter() - t0
        pos += chunk
        wall += dt
        push_times.append((dt, bool(demod.counters.synced)))
        got.extend(pkts)
        if first_at is None and pkts:
            first_at, first_wall = pos, wall
    got.extend(demod.flush())

    wanted = {p.tobytes(): i for i, p in enumerate(payload.astype(np.uint8))}
    ok = [p for p in got if p.crc_ok]
    if not ok:
        raise RuntimeError("no packets decoded: latency undefined")
    for p in ok:
        if p.payload.astype(np.uint8).tobytes() not in wanted:
            raise RuntimeError("a CRC-passing packet was never sent")
    skipped = wanted[ok[0].payload.astype(np.uint8).tobytes()]

    steady = sorted(dt for dt, synced in push_times if synced) \
        or sorted(dt for dt, _ in push_times)
    p50 = steady[len(steady) // 2]
    p99 = steady[min(len(steady) - 1, int(len(steady) * 0.99))]
    return {"metric": "streaming_latency", "unit": "s",
            "value": round(first_at / cfg.fs, 4),
            "cold_latency_s": round(first_at / cfg.fs, 4),
            "cold_compute_s": round(first_wall, 4),
            "skipped_packets": int(skipped),
            "decoded": len(ok), "sent": npkts,
            "proc_p50_ms": round(1e3 * p50, 3),
            "proc_p99_ms": round(1e3 * p99, 3),
            "realtime_factor": round(pcm.size / cfg.fs / wall, 2),
            "steady_buffer_s": round(
                bucket_frames * cfg.frame_size / cfg.fs, 4),
            "bucket_frames": bucket_frames,
            "sync_skip_frames": sync_skip_frames,
            "probe_frames": probe_frames, "chunk": chunk,
            "snr_db": snr_db, "platform": _platform(dev),
            "card": _card(dev)}


def _scale_group(device) -> tuple:
    """(this rank's device, its rank, the world size) of the running
    process group, started as a one-rank group on ``device`` when none is
    up; ValueError if the group's backend is not ``device``'s (NCCL on the
    card, gloo on the CPU)."""
    from qpsk_tpu_torch.parallel import multihost

    dev = _device(device)
    multihost.ensure_group(dev)
    if (multihost.mesh_type() == "cuda") != _on_card(dev):
        raise ValueError(f"a {dist.get_backend()} group cannot measure on "
                         f"{dev}")
    return dev, dist.get_rank(), dist.get_world_size()


def _finish(records: list, rank: int, dev: torch.device) -> list:
    """Rank 0's records, each naming where it ran; ``[]`` elsewhere."""
    if rank:
        return []
    for r in records:
        r["platform"], r["card"] = _platform(dev), _card(dev)
    return records


def _per_count(counts, axis: str, rank: int, measure) -> list:
    """``measure(mesh, n)`` on a mesh of the group's first ``n`` ranks for
    each count ``n``: the records of the counts this rank took part in."""
    from qpsk_tpu_torch.parallel.multihost import first_ranks_mesh

    records = []
    for n in counts:
        with first_ranks_mesh(n, axis) as mesh:
            if rank < n:
                records.append(measure(mesh, n))
    return records


def scaling_efficiency(device_counts=None,
                       channels_per_device: int | None = None,
                       frames: int = 8, iters: int = 3, inner: int = 2,
                       modes=("dp", "sp"), device="cuda") -> list[dict]:
    """Weak-scaling sweep over 1..N ranks (one a card), the work a rank
    held constant (perfect = flat time, efficiency = T1 / TN):

    * ``dp``: ``channels_per_device`` channels a rank (8192 on the card,
      the RX rate point a card; 8 on the CPU) x ``frames``, sharded by
      ``parallel.channels.make_channel_demod``, ``iters * inner`` chained
      calls;
    * ``sp``: one stream of ``frames`` frames a rank in time blocks with
      the FIR-halo exchange (``parallel.stream.rx_stream_timeparallel``),
      ``iters`` calls.

    One record per (mode, devices), the JAX package's keys plus ``card``;
    counts past the world size are skipped."""
    from qpsk_tpu_torch import ModemConfig
    from qpsk_tpu_torch.parallel.channels import (init_channels,
                                                  make_channel_demod)
    from qpsk_tpu_torch.parallel.stream import rx_stream_timeparallel

    cfg = ModemConfig()
    dev, rank, world = _scale_group(device)
    cpd = channels_per_device or (8192 if _on_card(dev) else 8)
    counts = [n for n in (device_counts or (1, 2, 4, 8)) if n <= world]

    def dp(mesh, n):
        channels = cpd * n
        pcm = _noise_pcm((channels, frames, cfg.frame_size), dev)
        demod = make_channel_demod(cfg, mesh)
        carry = {"st": init_channels(cfg, channels, mesh),
                 "acc": torch.zeros((), dtype=torch.int64, device=dev)}

        def step():
            carry["st"], out = demod(carry["st"], pcm)
            carry["acc"] += out.bits.sum()
        dt = _timed(step, iters * inner, dev, mesh.get_group("dp"))
        nsamples = channels * frames * cfg.frame_size * inner * iters
        return {"mode": "dp", "devices": n, "channels": channels,
                "time_s": round(dt, 6),
                "throughput_sps": round(nsamples / dt, 1)}

    def sp(mesh, n):
        nsamp = n * frames * cfg.frame_size
        pcm = _noise_pcm((nsamp,), dev, seed=1)
        acc = {"a": torch.zeros((), dtype=torch.int64, device=dev)}

        def step():
            _, bits, _ = rx_stream_timeparallel(cfg, pcm, mesh)
            acc["a"] += bits.sum()
        dt = _timed(step, iters, dev, mesh.get_group("sp"))
        return {"mode": "sp", "devices": n, "samples": nsamp,
                "time_s": round(dt, 6),
                "throughput_sps": round(nsamp * iters / dt, 1)}

    records = []
    for m, measure in (("dp", dp), ("sp", sp)):
        if m in modes:
            rows = _per_count(counts, m, rank, measure)
            # weak-scaling efficiency against the first count's time
            for r in rows:
                r["efficiency"] = round(rows[0]["time_s"] / r["time_s"], 3)
            records += rows
    return _finish(records, rank, dev)


def sp_bound_record(device_counts=(1, 2, 4), frames: int = 64,
                    iters: int = 30, device="cuda") -> list[dict]:
    """The fixed per-call cost of the sp halo exchange and the efficiency
    bound it implies.

    Two micro-benchmarks a count, alike but for the exchange: one call of
    ``parallel.stream``'s neighbour shift of a (2, ntaps-1) tail plus a
    sum, and the same with the shift replaced by a local product.  Their
    difference is ``t_fixed``, the per-call cost of the exchange (the
    halo is about 1 KB: latency and synchronisation, not bandwidth).
    ``t_block`` is a rank's time for ``rx_stream_timeparallel`` on
    ``frames`` frames a rank, and ``eff_bound = t_block / (t_block +
    t_fixed)``.  The JAX record's ``real_mesh_eff`` priced a TPU v5e
    interconnect link; it is dropped, and no guess for another
    interconnect takes its place."""
    from qpsk_tpu_torch import ModemConfig
    from qpsk_tpu_torch.parallel.stream import (_halo_from_left,
                                                rx_stream_timeparallel)

    cfg = ModemConfig()
    dev, rank, world = _scale_group(device)
    ntm1 = cfg.ntaps - 1

    def measure(mesh, n):
        group = mesh.get_group("sp")
        gen = torch.Generator(device=dev).manual_seed(rank)
        tails = torch.randn((2, ntm1), generator=gen, device=dev)
        carry = {"acc": torch.zeros((), device=dev)}

        def coll():
            tail = tails + carry["acc"]
            halo, reqs = _halo_from_left(tail, mesh, "sp")
            for req in reqs:
                req.wait()
            carry["acc"] = halo.sum() * 1e-9

        def local():
            carry["acc"] = (tails * 1.0000001 + carry["acc"]).sum() * 1e-9

        t_coll = _timed(coll, iters, dev, group) / iters
        t_local = _timed(local, iters, dev, group) / iters
        t_fixed = max(t_coll - t_local, 0.0)

        pcm = _noise_pcm((n * frames * cfg.frame_size,), dev, seed=1)
        acc = {"a": torch.zeros((), dtype=torch.int64, device=dev)}

        def block():
            _, bits, _ = rx_stream_timeparallel(cfg, pcm, mesh)
            acc["a"] += bits.sum()
        k = max(iters // 3, 3)
        t_block = _timed(block, k, dev, group) / k
        return {"mode": "sp_bound", "devices": n,
                "t_launch_collective_s": round(t_coll, 7),
                "t_launch_local_s": round(t_local, 7),
                "t_fixed_s": round(t_fixed, 7),
                "t_block_s": round(t_block, 7),
                "eff_bound": round(t_block / (t_block + t_fixed), 4),
                "frames_per_dev": frames}

    counts = [n for n in device_counts if n <= world]
    return _finish(_per_count(counts, "sp", rank, measure), rank, dev)


def sp_scaling_decomposition(device_counts=(1, 2, 4),
                             frames_per_dev=(16, 64), iters: int = 8,
                             device="cuda") -> list[dict]:
    """The sp weak-scaling time split in its parts, at each count and
    each ``frames_per_dev``: ``t_full`` (``rx_stream_timeparallel``: the
    halo exchange, the FIR, timing, acquisition, Costas, bits),
    ``t_frontend`` (``rx_frontend_timeparallel``: the exchange and the
    FIR alone) and ``t_block_rest`` (their difference: block-local work
    with no communication), each a call, with each part's efficiency
    against the first count of the same size.  A part whose efficiency
    rises with the size has a fixed per-call cost; one that stays flat
    scales with the work."""
    from qpsk_tpu_torch import ModemConfig
    from qpsk_tpu_torch.parallel.stream import (rx_frontend_timeparallel,
                                                rx_stream_timeparallel)

    cfg = ModemConfig()
    dev, rank, world = _scale_group(device)
    counts = [n for n in device_counts if n <= world]
    records = []
    for fpd in frames_per_dev:
        def measure(mesh, n):
            group = mesh.get_group("sp")
            nsamp = n * fpd * cfg.frame_size
            pcm = _noise_pcm((nsamp,), dev, seed=1)
            acc = {"a": torch.zeros((), dtype=torch.float64, device=dev)}

            def full():
                _, bits, _ = rx_stream_timeparallel(cfg, pcm, mesh)
                acc["a"] += bits.sum()

            def frontend():
                y = rx_frontend_timeparallel(cfg, pcm, mesh)
                acc["a"] += y.re[-8:].sum()
            t_full = _timed(full, iters, dev, group) / iters
            t_fe = _timed(frontend, iters, dev, group) / iters
            return {"mode": "sp_decomp", "devices": n, "frames_per_dev": fpd,
                    "samples": nsamp, "t_full_s": round(t_full, 7),
                    "t_frontend_s": round(t_fe, 7),
                    "t_block_rest_s": round(t_full - t_fe, 7)}
        rows = _per_count(counts, "sp", rank, measure)
        # each part's efficiency against the first count of this size
        for r in rows:
            for comp in ("t_full_s", "t_frontend_s", "t_block_rest_s"):
                r["eff_" + comp[2:-2]] = round(
                    rows[0][comp] / max(r[comp], 1e-12), 3)
        records += rows
    return _finish(records, rank, dev)


def suites(device="cuda") -> dict:
    """The ``bench`` subcommand's suites, name -> a call returning one
    record or a list of them (the JAX CLI's names).  ``scaling`` runs in
    a process group (rank 0 gets the records, the other ranks ``[]``):
    ``scaling_efficiency``, then ``sp_bound_record`` and
    ``sp_scaling_decomposition``."""
    from qpsk_tpu_torch.config import ModemConfig

    def d(fn, *args, **kw):
        return lambda: fn(*args, device=device, **kw)

    def rows(*calls):
        return lambda: [c() for c in calls]
    return {
        "rx": d(rx_throughput),
        "tx": d(tx_throughput),
        "frontend": rows(d(frontend_throughput, "pallas"),
                         d(frontend_throughput, "xla")),
        "costas": rows(d(costas_throughput, "pallas"),
                       d(costas_throughput, "scan")),
        "fec": rows(d(fec_throughput, "conv"), d(fec_throughput, "ldpc")),
        "coded": rows(d(coded_rx_throughput, "conv"),
                      d(coded_rx_throughput, "ldpc"),
                      d(coded_rx_throughput, "ldpc", modulation="8psk")),
        "serial": d(single_stream_serial_throughput),
        "blockparallel": d(single_stream_blockparallel_throughput),
        "fdm": d(fdm_throughput),
        "modfam": rows(d(rx_throughput, cfg=ModemConfig(modulation="8psk")),
                       d(rx_throughput, cfg=ModemConfig(modulation="16qam",
                                                        agc=True))),
        "latency": d(latency_benchmark),
        "scaling": lambda: (scaling_efficiency(device=device)
                            + sp_bound_record(device=device)
                            + sp_scaling_decomposition(device=device)),
    }
