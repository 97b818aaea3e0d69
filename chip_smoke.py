#!/usr/bin/env python3
"""Smoke test of the torch port (``qpsk_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. Build the CUDA kernels from ``qpsk_tpu_torch/csrc`` and print the card,
   its power limit, the torch and nvcc versions and the build time.
2. Each kernel against its plain PyTorch version on the card, at 1, 200 and
   8192 channels, in two chained calls of 8 frames (1024 symbols) each, on a
   loopback stimulus (packets -> TX at +50 Hz -> AWGN 10 dB) and on noise;
   first the Costas kernel's ``sincosf`` against ``torch.sin`` /
   ``torch.cos`` on every float32 of magnitude <= 8.  Phase 2b: the
   front-end pipeline at its ragged edges; 2c (``--costas`` runs it alone,
   with the ``sincosf`` check, about a minute): the Costas kernel against
   its plain version bit for bit (symbols, trace, state and every bit) at
   T 1/31/33/1024 x C 1/200/1023/8192 in QPSK, gear with gains and each dd
   mode, and with a gain row every 8, 5 or 3 symbols: the rows its bit
   writer stores in part, the dead lanes, tiles that read several gain
   rows.
3. The main path at full width, kernels only, with every kernel's launch
   counter reset before and read after: 8192 channels x 32 frames of random
   packets -> ``tx_stream`` at +50 Hz -> AWGN 10 dB -> ``rx_stream``.  Then
   each kernel against its plain version on the main path's own inputs, and
   ``find_sync`` / ``extract_packets`` on 64 channels of the kernel path and
   of the plain path (plain front-end -> plain Costas on the same PCM): the
   two must sync alike and pass the same packets.
4. Rates at the receiver's operating point (8192 channels x 8 frames, state
   chained, CUDA events): RX samples/s of the kernel path and the plain
   path, TX samples/s, and each kernel's time beside its plain version's,
   after each kernel is held against its plain version at that shape.
5. The coded link.  (a) The Viterbi and LDPC kernels against their plain
   versions at 1, 200 and 4096 packets and at the batch sizes of the coded
   paths (156: a channel's tracked extraction; 16 768: its sync hunt;
   Viterbi also 67 072: the 8PSK hunt), so that every kernel shape the
   wrappers pick by batch size is reached, on noisy codewords (sigma 0.7)
   and on hard +-1 LLRs with 3 % flips, and on codewords both must decode
   clean (sigma 0.55 Viterbi, 0.6 LDPC).  (b) The coded loopback at full
   width, kernels only, once for ``fec="conv"`` and once for
   ``fec="ldpc"``, with all five launch counters reset before each: 1024
   channels x 48 packets of 30 bytes, re-framed into modem frames with
   filler, TX at +50 Hz, AWGN 6 dB, ``rx_stream``; on 64 sampled
   channels soft LLRs, ``find_sync_streams(soft=True, probe_frames=8)``
   and ``extract_packets_soft_tracked``, then the same LLRs through the
   plain decoders.  Then, as in phase 3, each modem kernel against its
   plain version on this path's own inputs (12 672-step Costas chains,
   sample positions past 50 000), and the plain path's LLRs (plain
   front-end -> plain Costas on the same PCM) through the decoder
   kernel.  (c) Rates: the composed coded receive (1024 channels x 8
   frames, every demodulated bit decoded) of the kernel and the plain
   path, each FEC kernel alone at 4096 packets, and the kernels alone at
   the paths' batch sizes (156 packets both, 16 768 Viterbi), with their
   registers and spills from the build log.  Phase 5a also holds the
   codes beside the slice's: LDPC at ``PacketConfig(payload_bytes=127)``
   (1032 checks, two a thread) at 1, 156 and 4096 packets and Viterbi
   with the generators swapped, (171, 133), at 1, 156, 200 (every lane
   count), 4096 and 16 768 packets, against their plain versions.

6. The loop and channel options.  (a) Each new kernel or mode against its
   plain version at 1, 200 and 8192 channels, in two chained calls of 8
   frames, on a loopback stimulus and on noise: the channel-major
   front-end at 4 and 8 samples per symbol, the time-major front-end's
   AGC power output (bit-equal to ``agc._frame_power`` of its picks), the
   Costas kernel in gear, gains and gear + gains modes (bit-identical,
   lock level and gear included) and TX at 8 samples per symbol.  (b)
   Three loopbacks at full width, kernels only, every launch counter
   reset before each: 8192 channels of packets from TX at +50 Hz, for
   ``ModemConfig(agc=True, loop_bw_track=TAU/200)`` through AWGN 10 dB
   and then a -26 dB level (32 frames), ``ModemConfig(eq_taps=9)``
   through the two-ray channel 0:1.0,4:0.5 and AWGN 14 dB (32 frames) and
   ``config_1200()`` through AWGN 8 dB (64 frames).  On 64 sampled
   channels the kernel path and the plain path (plain front-end -> plain
   AGC / equalizer -> plain Costas on the same PCM) must sync alike and
   pass the same packets, every passing payload bit-exact, at least 90 %
   of them; then each kernel against its plain version on the path's own
   inputs, as in phase 3.  (c) Rates at 8192 channels x 8 frames: RX
   samples/s of each configuration's kernel and plain path, and each new
   kernel's time beside its plain version's.
7. The generic modulation family.  (a) The Costas kernel's dd mode against
   its plain version for BPSK, 8PSK and 16QAM at 1, 200 and 8192
   channels, in two chained calls of 8 frames, on a loopback stimulus and
   on noise, without and with gains: bit-identical, labels included.  (b)
   Three loopbacks at full width, kernels only, every launch counter reset
   before each: 8192 channels x 32 frames from TX at +50 Hz, BPSK through
   AWGN 8 dB, 8PSK 18 dB, ``ModemConfig(modulation="16qam", agc=True)``
   20 dB, each received from ``rx_acquire_hz`` on the card; the largest
   |PCM| is printed; on 64 sampled channels the kernel and plain paths
   must sync alike and pass the same packets, every passing payload
   bit-exact, at least 90 % of them; each kernel against its plain
   version on the path's own inputs.  (c) Coded 8PSK at 13 dB, 1024
   channels x 48 packets, once with ``fec="conv"`` and once with
   ``fec="ldpc"``: score matrix, every rotation's LLR stream, the soft
   hunt over every lag and ``extract_packets_soft_tracked_mod`` on 64
   sampled channels, against the plain modem path's scores through the
   same decoder kernel (>= 90 % passing).  (d) RX samples/s of the three
   configurations at 8192 x 8, and each dd kind's kernel and plain time.
   (e) 8PSK at 1200 baud on the composed chain (the channel-major
   front-end at 8 samples per symbol -> the dd Costas through
   ``costas_run_cm``), 8192 channels x 64 frames at 18 dB, as 7b, except
   for the M-power estimator's spurs: a channel whose acquisition took
   one (more than 20 Hz off) locks a constellation step away, which the
   JAX package's runtime repairs by a candidate sweep the port does not
   have.  So the card's spur channels are held against the same
   estimator on CPU tensors (the version the tests hold against JAX):
   at most 0.1 % of all channels may be flagged on the card and not on
   the CPU; sampled spur channels must still sync alike on both paths,
   and their packets count as lost in the CRC gate.  (f) The geometries
   on the card: ``rs=4800`` (2 samples per symbol), ``ntaps=63``,
   ``frame_size=256`` (the composed chain), ``frame_size=1024`` and 1200
   baud at ``frame_size=1024``, each a loopback of 256 channels x 32
   packets at 10 dB through the kernels (every launch counter must move),
   each kernel against its plain version on the path's own inputs with
   phase 2's bounds, the plain path on the same PCM syncing alike and
   passing the same packets (at 2 samples per symbol the link carries no
   packet at 10 dB, in the JAX package too, so there neither the payloads
   nor the loops' offset are held); TX against its plain version at 2 samples
   per symbol (1, 200, 8192 channels), and in one
   call of 2 channels x (128 * 65 536 + 37) symbols at 2, 4 and 8 against
   chained plain calls; then one call at 1031 taps, past the kernels'
   coverage (the TPU gates': 129 taps for the front-end, a 128-symbol halo
   for TX): ``tx_stream`` and ``rx_stream`` on the card must raise
   ``NotImplementedError`` naming it, before any launch.
8. The lowering switches, the general kernel instances and the streaming
   runtime.  (a) ``costas_impl`` / ``frontend_impl`` / ``tx_impl``
   "pallas" move each kernel's counter and equal "auto"; "scan" / "xla"
   move none and equal the plain wrappers; the decoders' ``impl`` alike;
   "pallas" on CPU tensors raises.  (b) Loopbacks of 256 channels x 32
   packets at 10 dB through the general instances (``rs=3200``,
   ``frame_size=384``: 3 samples per symbol; ``rs=1600``, 768: 6, and
   384: 6 on the composed chain; ``rs=600``, 2048: 16;
   ``frame_size=4096``; ``frame_size=1536`` with
   ``agc=True``: the power output at 384 symbols a frame; ``rs=4800``,
   2048: 2 samples per symbol past the fast instances' frames), held as
   in 7f (at 2, 3 and 16 samples per symbol the JAX package passes no
   packet either, so only sync and CRC agreement are held there); TX at
   16 samples per symbol, at 255 taps with 8 and at 131 taps with 4;
   Viterbi at K=5 (23, 35),
   K=9 (561, 753), rate 1/4 K=7, K=11, K=7 (132, 171) and rate 1/8 K=5
   at 1, 156 and 4096 packets and K=15 at 1 and 156, LDPC at (256, dv 2,
   4, 5, 6, 7), (192, dv 8) and (512, dv 2) at 1, 156 and 4096 (Viterbi
   bit-equal, LDPC >= 99.9 %); every general decoder code alone in a CUDA
   graph at its largest batch beside its bound, and each general
   instance's time beside its plain version's, its bound and its
   float32-FMA floor; then calls
   past the new coverage (1031 taps, K=16, dv=9), which raise before any
   launch.  (c) ``StreamModulator`` on the card, 1536 packets in seeded
   pushes of 1-97 and a flush, QPSK and 8PSK, against ``tx_impl="xla"``:
   PCM within 3 LSB, pending bits equal, tail exact, one TX launch a
   ``tx_stream`` call.  (d) ``StreamDemodulator`` on one stream against
   the same class with ``costas_impl="scan"``, ``frontend_impl="xla"``,
   on the same PCM in seeded chunks of 1-9600 samples: uncoded QPSK
   (+50 Hz, 10 dB, 1536 packets, a 3 s gap under ``squelch_db=6`` and the
   resync after it, saved halfway and resumed in a fresh receiver),
   ``fec="conv"`` and ``fec="ldpc"`` at 6 dB (512 packets), 8PSK at
   +250 Hz (the M-power spur; it must sync through the candidate
   rotation): the same packets and counters, every kernel counter of the
   path moved.  (e) The audio seconds a wall second of each side, the
   launches per bucket.  ``--runtime`` runs phase 8 alone; ``--profile``
   also traces one bucket of each phase-8d case.

9. The rest of the modem's modes (``--modes`` runs phase 9 alone).  (a, b)
   Loopbacks at full width, kernels only (``no_plain``: a kernel wrapper's
   plain version may not run), every launch counter reset before each:
   8192 channels of packets from TX at +50 Hz through AWGN 10 dB, DQPSK
   (32 frames; the time-major front-end and Costas kernels, the
   derotated symbols decoded differentially; every sampled channel must
   sync at rotation 0), tracking timing through ``clock_offset_pcm(60e-6,
   frac_offset=-0.5)`` (32 frames; the slip-tracked extractor, more than
   80 % passing), fractional and histogram timing and the reference
   slicer (8 frames; the histogram and the reference slicer carry no link
   at 10 dB in either package, so only sync and CRC agreement are held);
   the timing modes run the plain full-rate front-end, so there the
   front-end kernel must not launch.  Each through ``check_path``, the
   Costas kernel on the symbols each chain handed it.  DQPSK +
   ``fec="conv"`` at 8 dB, 1024 channels x 48 packets, decoded from hard
   bits (the runtime's DQPSK rule) through the Viterbi kernel, against
   the plain decoder and the plain modem path.  (c) ``config_parity()``
   on the card against ``tests/golden/reference_vectors.npz`` at
   ``tests/test_golden_parity.py``'s tolerances, the Costas kernel given
   the reference input through the ``CostasLoop`` facade, the scan's
   Costas launches (one a frame) held against the plain version.  (d)
   ``tx_stream(doppler_hz_per_s=25)`` on the card within 2 LSB of the CPU.
   (e) RX samples/s at 8192 x 8 for DQPSK and tracking (CUDA events) and
   of the parity scan at 8192 x 4 (host clock), with launches a call.
   (f) ``frontend_impl="pallas"`` with tracking raises ``ValueError``
   before any launch.  Phase 9's launches join the ``kernels`` line's
   front-end, Costas, TX and Viterbi rows.
10. The IO edge and the command line (``--cli`` runs phase 10 alone).
   (a) The FDM bank at 2048 slots x 32 frames (mux of 1023 channels, demux
   of the noisy wideband) and the resampler on 10 minutes of one stream
   (9600 -> 48 000, 44 100 -> 9600), on the card against the same calls
   on CPU tensors and chained calls (4 chunks; 1 s calls) against one
   call: int16 within 1 LSB, the largest difference and the share of
   samples that differ printed.  (b) The Quickstart's command lines
   through ``cli.main`` on the card, every launch counter reset before
   each: ``loopback`` at its defaults at 10 dB, with ``--fec conv`` at 6
   dB x 40 frames and ``--fec ldpc`` at 5 dB; ``tx --io-rate 48000`` to a
   WAV then ``rx`` of it; ``tx --stream-in`` of 48 hex lines then ``rx -
   --stream --state-file`` on the spool cut in two and resumed; ``sweep``
   at its defaults; ``fdm --nslots 2048 --frames 32 --snr-db 18``.  Each
   runs kernels only (``no_plain``) and must launch TX, the front-end and
   Costas (Viterbi, LDPC on the coded ones), then again with every plain
   version (the ``*_impl`` switches and the decoders' ``impl``) on the
   same seeds, launching nothing: equal return codes, JSON decisions and
   hex payload lines (a decision may differ only where the receive bits
   parted at a tie, ``parted_at_a_tie``), the TX files within 4 LSB, PER 0
   where the JAX CLI's tests hold it, all 1023 ``fdm`` channels synced
   with PER 0 and 64 of them bit-exact against the payloads sent.
   ``FdmReceiver`` at 16 slots, a 24-packet stream in seeded chunks,
   kernel side against plain side: the same packets.  (c) By CUDA events
   at 2048 slots x 8 frames: the FDM receive's wideband samples/s
   (demux + ``rx_stream`` over 1023 channels), the filterbank alone and
   the modem alone, the filterbank's share; the resampler's input
   samples/s in one call and in chained 1 s calls; each command's wall
   seconds on both sides.  Phase 10's launches join the ``kernels``
   line's front-end, Costas, TX, Viterbi and LDPC rows.
11. One stream block-parallel, ``bench``, the debug taps and the
   examples.  (a) (``--blocks`` runs it alone.)  One stream of 4096 frames
   (218 s of audio) of 30-byte packets from TX at +50 Hz through AWGN
   10 dB, received by ``parallel.rx_stream_blockparallel`` at 128 and
   1024 blocks (64 symbols of overlap) and at 1024 blocks with 37 (a
   window not a multiple of 16), kernels only (``no_plain``), every
   launch counter reset before each: one Costas launch, nothing else;
   the Costas kernel on the blocks' own (blocks, window) input
   bit-identical to its plain version; the plain path (``costas_impl=
   "scan"``) on the same PCM with equal bits, symbols and block offsets,
   the same sync and packets, every passing payload one that was sent;
   the blocks' offsets within 20 Hz of +50 Hz and their mean within 2;
   at 128 blocks at most one packet lost a seam beyond the serial
   ``rx_stream`` on one channel.  Rates by CUDA events: the serial
   receive and each block count, with a ``torch.profiler`` breakdown of
   the block-parallel call, and the Costas kernel alone on the 1024
   blocks beside its plain version (the ``kernels`` line's
   ``costas_blocks`` row, whose launches are phase 11a's).  (b)
   (``--bench`` runs b and c.)  ``bench --suite <s>`` through
   ``cli.main`` for every suite at its card sizes: each record names the
   card, has a positive finite rate, and keeps its decode guard.  (c)
   ``assert_finite`` passes a clean receive and raises at ``throw()`` on
   an injected NaN, after which the card launches again; ``ScatterTap``;
   ``trace`` writes a Chrome trace naming the front-end and Costas
   kernels; the three examples run on the card in subprocesses, exit 0.
12. Scale-out (``--scale`` runs it alone after the build): one process a
   card (``torch.multiprocessing`` workers on a ``FileStore`` in a
   temporary directory, NCCL bound to each rank's card), world size
   ``torch.cuda.device_count()``; each rank prints its card's name and
   power limit.  (b) ``dp`` at full width, kernels only (``no_plain``),
   the launch counters reset on every rank: 8192 channels a card x 32
   frames of packets from TX at +50 Hz through AWGN 10 dB (the global
   batch on every rank; phase 3's PCM at world size 1) through
   ``parallel.channels.make_channel_demod``; gate 1: the gathered bits
   and frequency trace equal one ``rx_stream`` call over the whole batch
   on rank 0's card; gate 2: on 64 channels of each rank, sync and CRC,
   every passing payload one that was sent; gate 3: ``fec="conv"`` at
   1024 channels a card x 48 packets at 6 dB, the LLRs of the sharded
   symbols within 1e-5 of the unsharded ones, the soft hunt and tracked
   extraction on 32 channels of each rank through the Viterbi kernel.
   (c) ``sp`` at full width: phase 11a's stream of 4096 frames split over
   the ranks; ``rx_frontend_timeparallel`` within 2e-4 of the serial mix
   and FIR on one card; ``rx_stream_timeparallel`` kernels only, one
   Costas launch a rank and nothing else, each rank's loop within 10 Hz
   of +50, at most 2 % of its packets lost and every CRC-passing payload
   one that was sent; on 64 frames a rank, the plain path
   (``costas_impl="scan"``) with equal bits and symbols and frequency
   within 1e-4, the Costas kernel on a rank's block bit-identical to its
   plain version and timed beside it (the ``kernels`` line's
   ``costas_timeparallel`` row).  (d) By CUDA events, the largest over the
   ranks: the ``dp`` receive a call, the ``sp`` receive a call and the
   serial ``rx_stream`` on one channel of the same stream; then ``bench
   --suite scaling`` through ``cli.main``, which starts its own ranks:
   every record names the card and has positive, finite times and rates.
   Phase 12's front-end, Costas, TX and Viterbi launches join their rows.

The Costas kernel is also held at a chain of 1000 symbols, not a multiple
of 16, in every mode (phases 2, 6a and 7a).  Beside each Costas, front-end
and TX wrapper time, the kernel alone in a CUDA graph (``fec_times.graph_ms``),
and for Costas the cycles a step that time gives at the card's top clock.

``python3 chip_smoke.py --profile`` builds the kernels and only traces
kernel-path receive calls with ``torch.profiler`` (the uncoded call at
the rate point, the composed coded call per code, one call of each
configuration of phases 6 and 7), then one ``tx_modulate`` and one
``tx_stream`` call at the rate point: device operations and busy time per
call beside the wall time, the host-to-device copies and synchronisations
per call (none allowed in the uncoded call; ``tx_modulate`` must be its
kernel's launch alone), and the largest operations.

``python3 chip_smoke.py --fec`` builds the kernels and runs only the two
decoders: phase 5a, then the Viterbi kernel at every lane count (1, 8 or
32 lanes of a warp hold a packet's trellis) against the plain
version and timed from 156 to 67 072 packets, the measurement behind the
wrapper's rule, and the LDPC kernel at the same batches.  Kernel times
are taken in a CUDA graph of 20 launches (``fec_times.graph_ms``, the
script beside this one), so that the host's launch rate does not bound a
kernel of a few microseconds.

Every kernel-vs-plain comparison gives both sides the same inputs and
state.  Decisions (timing index, bits) must be equal on the loopback
stimulus and agree on >= 99.9 % on noise, where near-ties may fall either
way (the Costas gear, gains and dd modes are bit-identical on both); picks within 3e-4, derotated symbols and loop frequency within 1e-4,
PCM within 2 LSB, carried phases within 1e-5, the TX tail exact.  Viterbi
bits must be equal on every input (the kernel's op order is the plain
version's); LDPC bits must agree on >= 99.9 % with the same number of
packets decoding clean (the JAX package's bound between its lowerings),
and the coded loopback's CRC verdicts may differ between the LDPC kernel
and plain decoders, and between the kernel and plain modem paths' LLRs,
on <= 0.1 % of packets each, every difference printed.  A loopback's kernel
path and plain path on the same PCM may differ in a bit only within 1e-3
of a decision boundary, or on a channel whose two loops parted at such a
tie of their own detector (the loop carries the other decision into
every later symbol): its derotated symbols must agree within 1e-4 up to
the tie, and at most 0.1 % of the channels may part; each is printed.

The last two lines are the card's ``nvidia-smi`` name and power limit and
``{"ok": true, "device": {...}}``; the line before them lists every kernel
and mode with its launches on its path, its largest difference from its
plain version, its time and its plain version's at the rate point, and
its bound: the least time the card could take for the same work, the
larger of the bytes it must move over 3.35 TB/s and its operations over
the peak of their type (the H100 SXM's published peaks): float32 at 67
TFLOP/s, and for the front-end's and TX's FIRs, which run on the tensor
cores in three float16 passes with float32 sums, 989 TFLOP/s (their
float32-FMA floors are printed beside), as ``qpsk_tpu_torch/utils/roofline.py``
prices them.
``library_ms`` is null: no single PyTorch call computes any of these
functions (PERF.md says why for each).
With no CUDA device, or without the package beside it, it exits non-zero
before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
# the bounds of every kernel's work on the H100 (its published peaks)
from qpsk_tpu_torch.utils.roofline import (  # noqa: E402
    costas_work, fec_work, frontend_work, general_work, tx_work)
# each C entry's launches, counted by the kernel library (``_lib.check``)
from qpsk_tpu_torch.ops.cuda import _lib  # noqa: E402


# channel counts of the kernel comparisons, (channels, frames) of the main
# path and of the rate measurement
COMPARE_CHANNELS = (1, 200, 8192)
# the front-end pipeline's ragged edges (phase 2b): channel counts (a
# partial group of 8, one past a whole grid's) and frames a call
PIPE_CHANNELS, PIPE_FRAMES = (1, 7, 9, 8193), (1, 2, 3, 5, 9)
# phase 2c: the Costas kernel's bit writer at every symbol count of
# COSTAS_SYMBOLS (one step, a partial tile, a tile and one more, the rate
# point's 1024) x channel count of COSTAS_CHANNELS (a dead lane in all but
# the last), in each mode of COSTAS_EDGE_MODES
COSTAS_SYMBOLS, COSTAS_CHANNELS = (1, 31, 33, 1024), (1, 200, 1023, 8192)
COSTAS_EDGE_MODES = ("qpsk", "gear+gains", "bpsk", "8psk", "16qam")
# and, in its modes with gains, tiles of 32 steps that span several gain
# rows: (T, symbols a gain row) at each channel count
COSTAS_GAIN_ROWS = ((1024, 8), (1000, 5), (33, 3))
# frame sizes of the power output's checks there (pipeline, general instance)
PIPE_POWER_FRAMES = (128, 256, 1024)
MAIN_PATH = (8192, 32)
RATE_POINT = (8192, 8)
TX_OFFSET_HZ = 50.0
# a decision may differ between the kernel and plain paths only on a
# symbol component this close to zero: the picks' bound (3e-4) plus the
# derotated symbols' (1e-4), with room for the loop's carried phase
NEAR_TIE = 1e-3
# phase 5: FEC batch sizes of the kernel comparisons, (channels, packets
# per channel) of the coded loopback (the coded receive point of
# benchmarks.coded_rx_throughput), its SNR, and (channels, frames) of the
# composed coded rate
FEC_COMPARE = {"conv": (1, 156, 200, 4096, 16768, 67072),
               "ldpc": (1, 156, 200, 4096, 16768)}
CODED_PATH = (1024, 48)
CODED_SNR_DB = 6.0
CODED_RATE_POINT = (1024, 8)
FEC_RATE_PACKETS = 4096
# the decoders' batch sizes on the coded paths: 4 rotations x about 39
# packets of a channel's tracked extraction; 4 rotations x 524 lags x 8
# probe frames of its sync hunt (which decodes only fec="conv")
FEC_PATH_PACKETS = {"viterbi": (156, 16768), "ldpc": (156,)}
# the Viterbi kernel's shapes (lanes of a warp that hold a packet's trellis;
# the wrapper picks one by batch size)
FEC_LANES = (1, 8, 32)
# phase 6: name -> (config fields, SNR dB, multipath paths, input level dB,
# frames) of the option loopbacks; the 1200-baud one runs 64 frames, as a
# packet fills two frames there and 8 packets are skipped before the sync
OPTION_PATHS = {
    "level": (dict(agc=True, loop_bw_track=2.0 * math.pi / 200.0), 10.0,
              None, -26.0, 32),
    "multipath": (dict(eq_taps=9), 14.0, ((0, 1.0), (4, 0.5)), 0.0, 32),
    "1200": (dict(rs=1200.0), 8.0, None, 0.0, 64),
}
# phase 7: name -> (config fields, SNR dB) of the generic-family loopbacks,
# the points where the JAX package measured PER 0
# (docs/per_vs_snr_{bpsk,8psk,16qam}.jsonl), and the SNR of the coded 8PSK
# loopbacks (CODED_PATH's shape)
FAMILY_PATHS = {"bpsk": (dict(modulation="bpsk"), 8.0),
                "8psk": (dict(modulation="8psk"), 18.0),
                "16qam": (dict(modulation="16qam", agc=True), 20.0)}
FAMILY_CODED_SNR_DB = 13.0
# phase 7e: the family on the composed chain, 8PSK at 1200 baud (the
# channel-major front-end at 8 samples per symbol -> the dd Costas through
# costas_run_cm): (config fields, SNR dB, frames), the point of the CPU
# test test_torch_modfam_link.py::test_composed_chain_matches_jax
FAMILY_1200 = (dict(modulation="8psk", rs=1200.0), 18.0, 64)
# phase 7f: the geometries the kernels were widened to, each a loopback
# through the kernels: name -> config fields; (channels, packets) of each;
# the TX kernel's long call (channels, symbols: past 65 535 blocks of 128);
# and a geometry past the kernels' coverage, 131 taps (the TPU front-end
# takes ntaps <= 129), whose wrappers must refuse it (channels, frames)
GEOMETRY_PATHS = {"rs=4800": dict(rs=4800.0), "ntaps=63": dict(ntaps=63),
                  "frame_size=256": dict(frame_size=256),
                  "frame_size=1024": dict(frame_size=1024),
                  "1200,frame_size=1024": dict(rs=1200.0, frame_size=1024)}
GEOMETRY_SHAPE = (256, 32)
TX_LONG = (2, 128 * 65536 + 37)
OFF_GEOMETRY = (dict(ntaps=1031), (256, 8))
# phase 5a: the coded link's other codes on the card: LDPC at
# PacketConfig(payload_bytes=127) (m = k = 1032 checks) and Viterbi with
# the generators swapped, at these batch sizes
FEC_OTHER = {"ldpc": (1, 156, 4096), "conv": (1, 156, 200, 4096, 16768)}
LDPC_K_127 = 8 * 127 + 16
CONV_SWAPPED = (0o171, 0o133)
# a Costas chain length that is not a multiple of 16 (nor of 8), and its
# trace period
ODD_T = (1000, 125)
# phase 8b: the geometries of the general kernel instances, each a
# loopback of GEOMETRY_SHAPE at 10 dB: name -> (config fields, whether the
# link carries packets there; at 2, 3 and 16 samples per symbol the JAX
# package passes none either, measured on CPU with the same stimulus), TX
# at 16 samples per symbol, at 255 taps with 8 and at 131 taps with 4
# (channels, symbols), and
# the decoders' other codes: Viterbi (K, generators), LDPC (k, dv), at
# these batches (K = 15, a block of 512 threads a packet, at the first
# two); LDPC also at its instances' largest thread counts, the general
# ones' 512 checks and PacketConfig(payload_bytes=407)'s 3272 (four
# checks a thread), which launch only within their launch bounds.  The
# Viterbi codes reach each shape of the general instances: a packet in
# part of a warp (K 5-7), in a warp (K 9, 11), in a block (K 15); one
# table value a butterfly (every generator tapping both ends), four
# (132, 171), and none at rate 1/8 and K = 5 (256 branch values > 16
# states, summed a butterfly)
GEOMETRY8_PATHS = {
    "rs=3200,frame_size=384": (dict(rs=3200.0, frame_size=384), False),
    "rs=1600,frame_size=768": (dict(rs=1600.0, frame_size=768), True),
    "rs=1600,frame_size=384": (dict(rs=1600.0, frame_size=384), True),
    "rs=600,frame_size=2048": (dict(rs=600.0, frame_size=2048), False),
    "frame_size=4096": (dict(frame_size=4096), True),
    "frame_size=1536,agc": (dict(frame_size=1536, agc=True), True),
    "rs=4800,frame_size=2048": (dict(rs=4800.0, frame_size=2048), False)}
TX8 = ((dict(rs=600.0, frame_size=2048), (256, 4096)),
       (dict(rs=1200.0, ntaps=255), (256, 4096)),
       (dict(ntaps=131), (256, 4096)))
VITERBI8 = ((5, (0o23, 0o35)), (9, (0o561, 0o753)),
            (7, (0o117, 0o127, 0o155, 0o171)), (11, (0o3345, 0o3613)),
            (15, (0o46321, 0o51271)), (7, (0o132, 0o171)),
            (5, (0o23, 0o35, 0o27, 0o31, 0o37, 0o25, 0o33, 0o21)))
LDPC8 = ((256, 2), (256, 5), (256, 6), (192, 8), (512, 2), (3272, 3),
         (256, 4), (256, 7))
FEC8_BATCHES = (1, 156, 4096)
# phase 8c: StreamModulator, packets of 30 bytes in seeded pushes of 1 to
# this many packets
RUNTIME_TX = (1536, 97)
# phase 8d: StreamDemodulator on one stream: name -> (config fields, packet
# fields, SNR dB, offset Hz, packets); PCM pushed in seeded chunks of 1 to
# RUNTIME_CHUNK samples; the uncoded case has RUNTIME_GAP_S of dead air in
# the middle, received with squelch_db=RUNTIME_SQUELCH_DB, and is saved
# halfway and resumed in a fresh receiver
RUNTIME_CASES = {
    "uncoded": (dict(), dict(), 10.0, 50.0, 1536),
    "conv": (dict(), dict(fec="conv"), 6.0, 50.0, 512),
    "ldpc": (dict(), dict(fec="ldpc"), 6.0, 50.0, 512),
    "8psk_spur": (dict(modulation="8psk"), dict(), 20.0, 250.0, 200)}
RUNTIME_CHUNK, RUNTIME_GAP_S, RUNTIME_SQUELCH_DB = 9600, 3.0, 6.0
# phase 9: the rest of the modem's modes, each a loopback through the
# kernels at full width: name -> (config fields, SNR dB, frames, packets
# skipped before the sync, whether the link carries packets there: the
# reference slicer leaves one bit a symbol to the noise (qpsk.c:74-79) and
# the reference's histogram timing, which its README calls unreliable,
# mistimes most frames at 10 dB, in both packages, whose bits are equal
# on the same PCM (tests/test_torch_timing_modes.py)); tracking runs
# through a sample-clock offset MODE_CLOCK (ppm, fractional start,
# clock_offset_pcm) and decodes with the slip-tracked extractor, more than
# MODE_TRACK_PASS of its packets passing (tests/test_channel_impairments.py);
# DQPSK must sync at rotation 0
MODE_PATHS = {
    "dqpsk": (dict(differential=True), 10.0, 32, 8, True),
    "tracking": (dict(timing_mode="tracking"), 10.0, 32, 14, True),
    "fractional": (dict(timing_mode="fractional"), 10.0, 8, 2, True),
    "histogram": (dict(timing_mode="histogram"), 10.0, 8, 2, False),
    "reference": (dict(slicer="reference"), 10.0, 8, 2, False),
}
MODE_CLOCK, MODE_TRACK_PASS = (60e-6, -0.5), 0.8
# DQPSK + conv, decoded from hard bits: (channels, packets), SNR dB (hard
# input runs about 2 dB behind the soft decoder, cli.py:220-222)
MODE_CODED, MODE_CODED_SNR_DB = (1024, 48), 8.0
# the chirped TX against the CPU: (channels, frames, Hz/s); parity's rate
# point (channels, frames: the frame scan runs the exact NCO a sample at a
# time)
MODE_CHIRP, PARITY_RATE = (256, 16, 25.0), (8192, 4)
# phase 10: the FDM bank at its operating point (benchmarks.fdm_throughput:
# 2048 slots, 1023 subchannels, 19.66 MS/s wideband), frames of its
# card-against-CPU check and loopback, and of its rate; the resampler's
# stream, 10 minutes at each (input, output) rate; FdmReceiver's run
# (slots, frames); the payload lines of the streamed CLI pair; the CLI's
# channels whose payloads are held bit-exact
FDM_SLOTS, FDM_FRAMES, FDM_RATE_FRAMES = 2048, 32, 8
RESAMPLE_SECONDS, RESAMPLE_RATES = 600, ((9600, 48000), (44100, 9600))
FDM_RX, CLI_STREAM_LINES, CLI_SAMPLED = (16, 24), 48, 64
# phase 11: one stream of BLOCKS_FRAMES frames (218 s of audio) of 30-byte
# packets from TX at +50 Hz through AWGN 10 dB, received block-parallel at
# each of BLOCKS_NBLOCKS blocks with BLOCKS_OVERLAP symbols of warmup, and
# at BLOCKS_ODD (blocks, overlap: a window of 37 + 512 symbols, not a
# multiple of 16); the example modules run in subprocesses
BLOCKS_FRAMES, BLOCKS_NBLOCKS, BLOCKS_OVERLAP = 4096, (128, 1024), 64
BLOCKS_ODD = (1024, 37)
EXAMPLES = ("end_to_end", "modulation_family", "streaming_receiver")
# phase 12: scale-out, one rank a card.  The dp receive at SCALE_DP
# (channels a card, frames) with SCALE_SAMPLED channels of each rank
# decoded, its soft path at SCALE_SOFT channels a card (fec="conv", phase
# 5b's CODED_PATH packets) with SCALE_SOFT_SAMPLED channels decoded; the
# sp receive of phase 11a's stream (BLOCKS_FRAMES frames), held against
# its plain version on SCALE_SP_PLAIN frames a rank; the largest share
# of a block's packets it may lose
SCALE_DP, SCALE_SAMPLED = (8192, 32), 64
SCALE_SOFT, SCALE_SOFT_SAMPLED = 1024, 32
SCALE_SP_PLAIN, SCALE_SP_LOSS = 64, 0.02


class SmokeFailure(RuntimeError):
    pass


def need(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line(fields: str = "name,power.limit", card: int = 0) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[card]


CLOCKS = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` over ``iters`` calls, by CUDA
    events around the whole run, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
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


def loopback_pcm(cfg, pcfg, c, nframes, seed, dev, snr_db=10.0, paths=None,
                 level_db=0.0):
    """(payload bits (C, packets, 240), channel bits (C, nframes,
    bits_per_frame), clean int16 PCM, received int16 PCM) of random packets
    sent at +50 Hz, through static multipath ``paths`` if given, AWGN at
    ``snr_db`` and an input level of ``level_db`` (``cli.py`` order)."""
    import torch
    from qpsk_tpu_torch import tx_init, tx_stream
    from qpsk_tpu_torch.channel import awgn_pcm, multipath_pcm
    from qpsk_tpu_torch.packet import assemble_packet

    gen = torch.Generator(device=dev).manual_seed(seed)
    npk = nframes * cfg.bits_per_frame // pcfg.frame_bits
    payload = torch.randint(0, 2, (c, npk, 8 * pcfg.payload_bytes),
                            generator=gen, device=dev, dtype=torch.int32)
    chan = assemble_packet(pcfg, payload).reshape(c, nframes, -1)
    _, clean = tx_stream(cfg, tx_init(cfg, (c,), device=dev), chan,
                         tx_offset_hz=TX_OFFSET_HZ)
    pcm = clean
    if paths:
        pcm = multipath_pcm(pcm.reshape(c, -1), paths).reshape(pcm.shape)
    power = float(((pcm.to(torch.float32) / cfg.pcm_scale) ** 2).mean())
    pcm = awgn_pcm(gen, pcm, snr_db, power, cfg.pcm_scale)
    if level_db:
        g = 10.0 ** (level_db / 20.0)
        pcm = torch.clamp(torch.round(pcm.to(torch.float32) * g), -32768,
                          32767).to(torch.int16)
    return payload, chan, clean, pcm


def noise_pcm(cfg, c, nframes, seed, dev):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((c, nframes, cfg.frame_size), generator=gen,
                        device=dev) * 8000.0).to(torch.int16)


def max_abs(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def cmax_abs(a, b) -> float:
    return max(max_abs(a.re, b.re), max_abs(a.im, b.im))


def agree(label: str, what: str, same, exact: bool) -> float:
    """The share of equal decisions: all of them if ``exact``, else at
    least 99.9 %."""
    rate = int(same.sum()) / same.numel()
    need(rate == 1.0 if exact else rate >= 0.999,
         f"{what} agreement {rate} ({label})")
    return rate


def check_tx(cfg, sym, st, label: str, errs: dict, key: str = "tx",
             lsb: int = 2):
    """The TX kernel against its plain version on the same symbols and
    state: PCM within ``lsb``, phase 1e-5, tail exact.  Returns (kernel
    PCM, the plain version's new state)."""
    import torch
    from qpsk_tpu_torch.ops.cuda import tx_kernel as tk

    args = (cfg, sym, st.nco_phase, st.fir_tail, TX_OFFSET_HZ)
    pk, phk, tlk = tk.tx_modulate(*args)
    pp, php, tlp = tk.tx_modulate_plain(cfg, sym, st.nco_phase, st.fir_tail,
                                        TX_OFFSET_HZ)
    worst = int((pk.to(torch.int32) - pp.to(torch.int32)).abs().max())
    need(worst <= lsb, f"TX PCM differs by {worst} LSB ({label})")
    need(cmax_abs(phk, php) <= 1e-5, f"TX phase differs ({label})")
    need(cmax_abs(tlk, tlp) == 0, f"TX tail differs ({label})")
    errs[key] = max(errs[key], float(worst))
    print(f"  {key:8s} {label}: PCM max diff {worst} LSB")
    return pk, st._replace(nco_phase=php, fir_tail=tlp)


def check_frontend(cfg, pcm, st, exact: bool, label: str, errs: dict,
                   key: str = "frontend", pow_key: str = "frontend_tm_power"):
    """The time-major front-end kernel against its plain version on the
    same PCM and state; with ``cfg.agc`` its power output too, which
    must equal ``agc._frame_power`` of its own picks bit for bit and the
    plain version's within 1e-4 relative.  Returns (kernel result, plain
    result)."""
    import torch
    from qpsk_tpu_torch.ops import agc
    from qpsk_tpu_torch.ops.cuda import frontend_kernel as fk

    args = (cfg, pcm, st.nco_phase, st.fir_tail, st.decim_delay)
    k = fk.rx_frontend_tm(*args)
    p = fk.rx_frontend_tm_plain(*args)
    same = k[2] == p[2]                                        # (C, F)
    rate = agree(label, "timing index", same, exact)
    # picks of frames whose index agrees: row block 0 is the carried delay,
    # block f+1 frame f, and the last frame's picks are the new delay
    emitted = torch.cat([torch.ones_like(same[:, :1]), same[:, :-1]], dim=1)
    rows = emitted.T.repeat_interleave(cfg.symbols_per_frame, dim=0)
    last = same[:, -1]
    err = max(max_abs(k[0][rows], p[0][rows]), max_abs(k[1][rows], p[1][rows]),
              max_abs(k[5].re[last], p[5].re[last]),
              max_abs(k[5].im[last], p[5].im[last]))
    need(err <= 3e-4, f"front-end picks differ by {err} ({label})")
    state_err = max(cmax_abs(k[3], p[3]), cmax_abs(k[4], p[4]))
    need(state_err <= 1e-5, f"front-end state differs by {state_err} ({label})")
    errs[key] = max(errs[key], err)
    msg = (f"  {key} {label}: index agreement {rate:.6f}, picks max err "
           f"{err:.3g}, state max err {state_err:.3g}")
    if cfg.agc:
        need(torch.equal(k[6], agc.frame_powers_tm(k[0], k[1], pcm.shape[1])),
             f"the power output differs from _frame_power of its picks ({label})")
        rel = float(((k[6] - p[6]).abs() / p[6].clamp(min=1e-30))[emitted].max())
        need(rel <= 1e-4, f"the power output differs from the plain "
             f"version's by {rel} relative ({label})")
        errs[pow_key] = max(errs[pow_key], rel)
        msg += f"; powers bit-equal to _frame_power, {rel:.3g} relative from plain"
    print(msg)
    return k, p


def check_frontend_cm(cfg, pcm, st, exact: bool, label: str, errs: dict,
                      key: str):
    """The channel-major front-end kernel against its plain version
    (``frontend_xla``) on the same PCM and state.  Returns (kernel result,
    plain result)."""
    from qpsk_tpu_torch.ops.cuda import frontend_kernel as fk

    args = (cfg, pcm, st.nco_phase, st.fir_tail)
    k, p = fk.rx_frontend(*args), fk.frontend_xla(*args)
    same = k[1] == p[1]                                        # (C, F)
    rate = agree(label, "timing index", same, exact)
    err = max(max_abs(k[0].re[same], p[0].re[same]),
              max_abs(k[0].im[same], p[0].im[same]))
    need(err <= 3e-4, f"front-end picks differ by {err} ({label})")
    state_err = max(cmax_abs(k[2], p[2]), cmax_abs(k[3], p[3]))
    need(state_err <= 1e-5, f"front-end state differs by {state_err} ({label})")
    errs[key] = max(errs[key], err)
    print(f"  {key} {label}: index agreement {rate:.6f}, picks max err "
          f"{err:.3g}, state max err {state_err:.3g}")
    return k, p


def check_costas(cs, zr, zi, params, nsym, exact: bool, label: str,
                 errs: dict, gear=None, gains=None, dd=None):
    """The Costas kernel against its plain version on the same symbols and
    state.  In gear, gains or dd mode the two must be bit-identical, lock
    level and gear, or labels, included.  Returns (kernel result, plain
    result)."""
    import torch
    from qpsk_tpu_torch.ops.cuda import costas_kernel as ck

    kw = dict(trace_every=nsym, gear=gear, gains=gains, dd=dd)
    k = ck.costas_run_tm(cs, zr, zi, params, **kw)
    p = ck.costas_run_tm_plain(cs, zr, zi, params, **kw)
    err = max(cmax_abs(k[1], p[1]), max_abs(k[2], p[2]),
              max_abs(k[0].freq, p[0].freq), max_abs(k[0].phase, p[0].phase))
    need(err <= 1e-4, f"Costas derot/freq differ by {err} ({label})")
    if dd is not None:
        keys = [f"costas_dd_{dd[0]}"]
    else:
        keys = [m for m, on in (("costas_gear", gear),
                                ("costas_gains", gains))
                if on is not None] or ["costas"]
    if keys != ["costas"]:
        need(err == 0 and torch.equal(k[3], p[3]),
             f"Costas {keys} is not bit-identical to its plain version ({label})")
        if gear is not None:
            need(torch.equal(k[0].lev, p[0].lev)
                 and torch.equal(k[0].locked, p[0].locked),
                 f"the Costas lock level or gear differs ({label})")
    rate = agree(label, "Costas bit", k[3] == p[3], exact)
    for key in keys:
        errs[key] = max(errs[key], err)
    locked = (f", {float(k[0].locked.mean()):.4f} of channels locked"
              if gear is not None else "")
    print(f"  {'+'.join(keys):8s} {label}: bit agreement {rate:.6f}, "
          f"derot/freq max err {err:.3g}{locked}")
    return k, p


def check_sincosf(dev, bound: float = 8.0) -> None:
    """The Costas kernel's one ``sincosf`` against ``torch.sin`` and
    ``torch.cos`` (what its plain version calls) on every float32 of
    magnitude <= ``bound``: the loop's phases lie within 2*tau of 0, and
    the kernel is bit-identical to its plain version only if these agree."""
    import torch
    from qpsk_tpu_torch.ops.cuda import _lib

    top = int(torch.tensor(bound).view(torch.int32))
    chunk, bad, n = 1 << 28, 0, 0
    for sign in (0, -(1 << 31)):
        for lo in range(0, top + 1, chunk):
            m = min(chunk, top + 1 - lo)
            x = (torch.arange(lo, lo + m, device=dev, dtype=torch.int64)
                 + sign).to(torch.int32).view(torch.float32)
            s, c = torch.empty_like(x), torch.empty_like(x)
            _lib.check(_lib.library().qpsk_sincosf(
                x.data_ptr(), s.data_ptr(), c.data_ptr(), m,
                _lib.stream_ptr(dev)), "qpsk_sincosf")
            bad += int((s.view(torch.int32) != torch.sin(x).view(torch.int32)).sum())
            bad += int((c.view(torch.int32) != torch.cos(x).view(torch.int32)).sum())
            n += m
    need(bad == 0, f"sincosf differs from torch.sin/cos on {bad} values")
    print(f"  sincosf: bit-equal to torch.sin and torch.cos on all {n} floats "
          f"of magnitude <= {bound:g}")


def pipeline_edges(dev, errs: dict) -> None:
    """Phase 2b: the front-end pipeline (``frontend_kernel_pipe``: one
    persistent block an SM walking tiles of 8 channels x a frame) against
    the plain versions where its schedule is ragged: every channel count of
    ``PIPE_CHANNELS`` x frame count of ``PIPE_FRAMES``, time-major at 4, 2
    and 8 samples per symbol and with the power output, channel-major at 4
    and 8, each on noise PCM after a chained call (a carried tail, phase
    and delay), within the limits of phase 2; every launch the pipeline's.
    Then the power output at the frame sizes of ``PIPE_POWER_FRAMES``, at
    1, 9 and 200 channels x 1 and 5 frames: the pipeline's up to 512
    samples, the general instance's past it."""
    import torch
    from qpsk_tpu_torch import ModemConfig, rx_init
    from qpsk_tpu_torch.ops.cuda import frontend_kernel as fk

    tm = ((ModemConfig(), "frontend"), (ModemConfig(rs=4800.0), "frontend"),
          (ModemConfig(rs=1200.0), "frontend"),
          (ModemConfig(agc=True), "frontend_tm_power"))
    cm = ((ModemConfig(), "frontend_cm"), (ModemConfig(rs=1200.0),
                                           "frontend_cm_1200"))
    reset_launches()
    checks = 0
    for c in PIPE_CHANNELS:
        for f in PIPE_FRAMES:
            for i, (cfg, key) in enumerate(tm + cm):
                pcm = noise_pcm(cfg, c, f + 1, 7 * c + f + i, dev)
                st = rx_init(cfg, (c,), device=dev)
                first = pcm[:, :1].contiguous()
                a = fk.rx_frontend_tm_plain(cfg, first, st.nco_phase,
                                            st.fir_tail, st.decim_delay)
                st = st._replace(nco_phase=a[3], fir_tail=a[4],
                                 decim_delay=a[5])
                x = pcm[:, 1:].contiguous()
                label = (f"C={c} F={f} {cfg.cycles} samples a symbol"
                         f"{' power' if cfg.agc else ''}")
                if (cfg, key) in tm:
                    check_frontend(cfg, x, st, False, f"{label} tm", errs,
                                   key=key if not cfg.agc else "frontend",
                                   pow_key=key)
                else:
                    check_frontend_cm(cfg, x, st, False, f"{label} cm", errs,
                                      key)
                checks += 1
    # the power output at frame sizes read from the launch, whose squares
    # go through shared memory: the pipeline at 128 and 256 samples, the
    # general instance at 1024, one frame a call and several
    past = 0
    for fsz in PIPE_POWER_FRAMES:
        cfg = ModemConfig(agc=True, frame_size=fsz)
        for c in (1, 9, 200):
            for f in (1, 5):
                pcm = noise_pcm(cfg, c, f + 1, 11 * c + f + fsz, dev)
                st = rx_init(cfg, (c,), device=dev)
                a = fk.rx_frontend_tm_plain(cfg, pcm[:, :1].contiguous(),
                                            st.nco_phase, st.fir_tail,
                                            st.decim_delay)
                st = st._replace(nco_phase=a[3], fir_tail=a[4],
                                 decim_delay=a[5])
                pipe = fk._fast(cfg, True)
                key, pow_key = (("frontend", "frontend_tm_power") if pipe
                                else ("frontend_gen_power",) * 2)
                check_frontend(cfg, pcm[:, 1:].contiguous(), st, False,
                               f"C={c} F={f} frame {fsz} power tm", errs,
                               key=key, pow_key=pow_key)
                if pipe:
                    checks += 1
                else:
                    past += 1
    n = _lib.launches
    pipe, gen = n["qpsk_frontend_pipe"], n["qpsk_frontend_gen"]
    need(pipe == checks and gen == past,
         f"the pipeline took {pipe} and the general instance {gen} "
         f"front-end launches ({checks} checks at frames up to 512, {past} "
         f"past it)")
    print(f"  {checks} checks at frames up to 512, every launch the "
          f"pipeline's, {past} past it the general instance's")


def costas_edges(dev, errs: dict) -> None:
    """Phase 2c: the Costas kernel against its plain version, bit for bit,
    at every symbol count of ``COSTAS_SYMBOLS`` x channel count of
    ``COSTAS_CHANNELS`` in each mode of ``COSTAS_EDGE_MODES`` (QPSK, gear
    with gains, dd BPSK, 8PSK, 16QAM with gains): Gaussian symbols (at the
    AGC target's scale in dd mode) from a warm state, a gain row a frame
    of 32 symbols (one row at T = 1), and in the modes with gains also a
    gain row every 8, 5 and 3 symbols (``COSTAS_GAIN_ROWS``: a tile reads
    several rows); the derotated symbols, the frequency trace, the state
    and every bit equal.  Each lane stores its own
    channel's bits in 16-byte chunks (``BitWriter`` in
    ``csrc/costas.cu``), so these are the rows that start or end inside a
    chunk (BPS x T not a multiple of 4) and the warps with dead lanes."""
    import torch
    from qpsk_tpu_torch import ModemConfig
    from qpsk_tpu_torch.ops.costas import (CostasState, costas_params,
                                           gear_for)
    from qpsk_tpu_torch.ops.cuda import costas_kernel as ck

    base = ModemConfig()
    params = costas_params(base.loop_bw, base.damping, base.min_freq,
                           base.max_freq)
    gear = gear_for(2.0 * math.pi / 200.0, base.damping)
    a = base.agc_target
    gained = ("gear+gains", "16qam")
    # (mode, T, C, symbols a gain row: None for one a trace row)
    cases = [(mode, t, c, None) for mode in COSTAS_EDGE_MODES
             for t in COSTAS_SYMBOLS for c in COSTAS_CHANNELS]
    cases += [(mode, t, c, nsf) for mode in gained
              for t, nsf in COSTAS_GAIN_ROWS for c in COSTAS_CHANNELS]
    reset_launches()
    for mode, t, c, nsf in cases:
        gen = torch.Generator(device=dev).manual_seed(
            1000 * t + c + len(mode) + 7 * (nsf or 0))
        scale = 1.0 if mode in ("qpsk", "gear+gains") else a
        zr, zi = (torch.randn((t, c), generator=gen, device=dev) * scale
                  for _ in range(2))
        every = 32 if t % 32 == 0 else t
        kw = dict(trace_every=every)
        if mode in gained:
            kw["gains"] = torch.rand((t // (nsf or every), c), generator=gen,
                                     device=dev) * 1.5 + 0.5
        if mode == "gear+gains":
            kw["gear"] = gear
        elif mode != "qpsk":
            kw["dd"] = (mode, a)
        warm = [torch.rand((c,), generator=gen, device=dev) * 6 - 3,
                torch.rand((c,), generator=gen, device=dev) * 0.1 - 0.05]
        if mode == "gear+gains":
            warm += [torch.rand((c,), generator=gen, device=dev),
                     (torch.rand((c,), generator=gen, device=dev)
                      > 0.5).to(torch.float32)]
        cs = CostasState(*warm)
        k = ck.costas_run_tm(cs, zr, zi, params, **kw)
        p = ck.costas_run_tm_plain(cs, zr, zi, params, **kw)
        label = f"{mode} T={t} C={c} gain rows of {nsf or every}"
        need(torch.equal(k[3], p[3]),
             f"Costas bits differ from the plain version's ({label}): "
             f"{int((k[3] != p[3]).sum())} of {k[3].numel()}")
        need(all(torch.equal(x, y) for x, y in zip(k[1], p[1]))
             and torch.equal(k[2], p[2])
             and all(torch.equal(x, y) for x, y in zip(k[0], p[0])
                     if x is not None),
             f"Costas symbols, trace or state differ ({label})")
    counted = kernel_launches(("costas",))["costas"]
    need(counted == len(cases), f"phase 2c launched {counted} Costas "
         f"kernels for {len(cases)} checks")
    print(f"  Costas edges: {len(cases)} checks bit-identical (symbols, "
          f"trace, state, bits) at T {COSTAS_SYMBOLS} x C {COSTAS_CHANNELS}, "
          f"modes {COSTAS_EDGE_MODES}; gain rows (T, symbols a row) "
          f"{COSTAS_GAIN_ROWS} in {gained}")


def compare_kernels(cfg, pcfg, dev, errs: dict) -> None:
    """Phase 2: every kernel against its plain version, in two chained
    calls of the rate point's length at each channel count."""
    import torch
    from qpsk_tpu_torch import rx_init
    from qpsk_tpu_torch.ops.costas import costas_init, costas_params
    from qpsk_tpu_torch.ops.cplx import CF32
    from qpsk_tpu_torch.ops.modmap import bits_to_symbols
    from qpsk_tpu_torch.state import tx_init

    nframes, nsym = RATE_POINT[1], cfg.symbols_per_frame
    t = nframes * nsym                                  # symbols per call
    params = costas_params(cfg.loop_bw, cfg.damping, cfg.min_freq, cfg.max_freq)
    for c in COMPARE_CHANNELS:
        gen = torch.Generator(device=dev).manual_seed(c)
        bits = torch.randint(0, 2, (c, 4 * t), generator=gen, device=dev,
                             dtype=torch.int32)
        sym = bits_to_symbols(bits)
        st = tx_init(cfg, (c,), device=dev)
        for i in range(2):
            s = CF32(sym.re[:, i * t:(i + 1) * t].contiguous(),
                     sym.im[:, i * t:(i + 1) * t].contiguous())
            _, st = check_tx(cfg, s, st, f"C={c:5d} call {i}", errs)

        lb = loopback_pcm(cfg, pcfg, c, 2 * nframes, seed=c, dev=dev)[3]
        for kind, pcm in (("loopback", lb),
                          ("noise", noise_pcm(cfg, c, 2 * nframes, c + 1, dev))):
            exact = kind == "loopback"
            st = rx_init(cfg, (c,), device=dev)
            zs = []
            for i in range(2):
                x = pcm[:, i * nframes:(i + 1) * nframes].contiguous()
                _, p = check_frontend(cfg, x, st, exact,
                                      f"C={c:5d} {kind} call {i}", errs)
                zs.append(p[:2])
                st = st._replace(nco_phase=p[3], fir_tail=p[4],
                                 decim_delay=p[5])

            # Costas on the plain front-end's picks (loopback) or Gaussian
            # symbols (noise): a cold call, then a chained warm one
            if exact:
                zr = torch.cat([z[0] for z in zs])
                zi = torch.cat([z[1] for z in zs])
            else:
                g2 = torch.Generator(device=dev).manual_seed(c + 2)
                zr = torch.randn((2 * t, c), generator=g2, device=dev)
                zi = torch.randn((2 * t, c), generator=g2, device=dev)
            cs = costas_init((c,), device=dev)
            for i in range(2):
                _, p = check_costas(cs, zr[i * t:(i + 1) * t].contiguous(),
                                    zi[i * t:(i + 1) * t].contiguous(), params,
                                    nsym, exact, f"C={c:5d} {kind} call {i}",
                                    errs)
                cs = p[0]

        # a chain length that is not a multiple of 16: a partial last word
        (t_odd, every), g3 = ODD_T, torch.Generator(device=dev).manual_seed(c + 4)
        zo = [torch.randn((t_odd, c), generator=g3, device=dev) for _ in range(2)]
        check_costas(costas_init((c,), device=dev), zo[0], zo[1], params, every,
                     True, f"C={c:5d} noise T={t_odd}", errs)


def path_cfg(cfg, kind: str):
    """``cfg`` with the lowering switches of a receive path: the kernels
    (``kind="kernel"``, "auto" on CUDA tensors) or their plain versions
    (``costas_impl="scan"``, ``frontend_impl="xla"``)."""
    if kind == "plain":
        return dataclasses.replace(cfg, costas_impl="scan", frontend_impl="xla")
    return cfg


def tx_symbols(cfg, bits):
    """The (C, S) symbols ``tx_stream`` sends for (C, bps*S) channel bits
    (DQPSK: from a cold phase index)."""
    from qpsk_tpu_torch.ops import differential, modfam
    from qpsk_tpu_torch.ops.cplx import CF32
    from qpsk_tpu_torch.ops.modmap import bits_to_symbols
    if cfg.differential:
        sym, _ = differential.diff_encode_bits(
            bits, differential.diff_tx_init(bits.shape[:-1], bits.device))
    elif cfg.modulation == "qpsk":
        sym = bits_to_symbols(bits)
    else:
        sym = modfam.bits_to_symbols_mod(bits, modfam.get(cfg.modulation))
    return CF32(sym.re.contiguous(), sym.im.contiguous())


def boundary_distance(cfg, sym):
    """How far each derotated symbol lies from its nearest decision
    boundary: a sign, and for 8PSK |re| = |im|, for 16QAM the axis
    threshold."""
    import torch
    from qpsk_tpu_torch.ops import modfam
    if cfg.modulation == "bpsk":
        return sym.re.abs()
    d = torch.minimum(sym.re.abs(), sym.im.abs())
    if cfg.modulation == "8psk":
        d = torch.minimum(d, (sym.im.abs() - sym.re.abs()).abs())
    elif cfg.modulation == "16qam":
        thr = float(modfam.dd_constants(modfam.get("16qam"), cfg.agc_target)[-1])
        d = torch.minimum(d, torch.minimum((sym.re.abs() - thr).abs(),
                                           (sym.im.abs() - thr).abs()))
    return d


def bit_ties(cfg, sym, shape):
    """Which bits of ``shape`` lie within NEAR_TIE of their slicer's
    decision boundary, from the derotated symbols (C, F, nsym): QPSK's
    diagonal slicer per bit on the bit's own axis; the reference slicer
    on the diagonals; DQPSK on an axis of the symbol or of the one before
    it (a dibit is the difference of two slices); the family at
    ``boundary_distance``."""
    import torch
    if cfg.modulation != "qpsk":
        return (boundary_distance(cfg, sym) < NEAR_TIE).repeat_interleave(
            cfg.bits_per_symbol, dim=-1)
    if cfg.differential:
        c = sym.re.shape[0]
        t = (torch.minimum(sym.re.abs(), sym.im.abs()) < NEAR_TIE).reshape(c, -1)
        t = t | torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], dim=1)
        return t.repeat_interleave(2, dim=-1).reshape(shape)
    if cfg.slicer == "reference":
        return ((sym.re.abs() - sym.im.abs()).abs() < NEAR_TIE
                ).repeat_interleave(2, dim=-1).reshape(shape)
    return torch.stack([sym.im.abs() < NEAR_TIE, sym.re.abs() < NEAR_TIE],
                       dim=-1).reshape(shape)


def check_path(cfg, bits, clean, pcm, out, dev, label: str, errs: dict,
               tx_key: str = "tx", fe_key: str = "frontend", st0=None,
               tm_key: str = "frontend", pow_key: str = "frontend_tm_power"):
    """Each modem kernel against its plain version on a path's own inputs
    (the channel bits sent, the clean and the received PCM; the Costas
    kernel on the symbols the path handed it) and its re-run from the
    path's initial state ``st0`` (default ``rx_init``) against the path's
    outputs ``out``; then the plain path (plain front-end -> plain AGC /
    equalizer -> plain Costas) on the same PCM, whose bits may differ from
    the kernel path's only within NEAR_TIE of a decision boundary
    (``bit_ties``).  The plain full-rate front-end of the fractional,
    tracking and histogram timing has no kernel to check.  Returns the plain path's derotated
    symbols (C, F, nsym), its bits (C, F, bps nsym) and the mask of bits
    that differ."""
    import torch
    from qpsk_tpu_torch import rx_init, tx_init
    from qpsk_tpu_torch import modem

    c, nsym = pcm.shape[0], cfg.symbols_per_frame
    pk, _ = check_tx(cfg, tx_symbols(cfg, bits.reshape(c, -1)),
                     tx_init(cfg, (c,), device=dev), label, errs, key=tx_key,
                     lsb=1 if cfg.cycles == 8 else 2)
    need(torch.equal(pk, clean.reshape(c, -1)),
         f"the TX kernel's re-run differs ({label})")
    st = rx_init(cfg, (c,), device=dev) if st0 is None else st0
    chain, frontend, costas = modem._rx_path(cfg)
    if chain is modem._rx_stream_tm:
        kf, _ = check_frontend(cfg, pcm, st, True, label, errs, tm_key,
                               pow_key)
        index = kf[2]
    elif chain is modem._rx_stream_composed:
        kf, _ = check_frontend_cm(cfg, pcm, st, True, label, errs, fe_key)
        index = kf[1]
    else:                    # the plain full-rate front-end: no kernel
        index = frontend(cfg, pcm, st)[1]
    need(torch.equal(index, out.timing_index),
         f"the front-end's re-run differs ({label})")

    # the kernel path again, recording what its Costas call was handed
    seen = []

    def costas_seen(*args, **kw):
        seen.append((args, kw))
        return costas(*args, **kw)
    _, rerun = chain(cfg, st, pcm, frontend, costas_seen)
    need(torch.equal(rerun.bits, out.bits), f"the kernel path's re-run "
         f"differs ({label})")
    (cs, *planes, params, _), kw = seen[0]
    if len(planes) == 1:                     # the channel-major entry
        planes = [p.T.contiguous() for p in planes[0]]
    check_costas(cs, planes[0], planes[1], params, nsym, True, label, errs,
                 gear=kw.get("gear"), gains=kw.get("gains"), dd=kw.get("dd"))

    _, plain = chain(path_cfg(cfg, "plain"), st, pcm, frontend, costas)
    d = out.symbols
    tie = bit_ties(cfg, d, out.bits.shape)
    flips = plain.bits != out.bits
    parted = parted_at_a_tie(cfg, out.symbols, plain.symbols,
                             flips & ~tie, label)
    # every channel whose derotated symbols part by more than NEAR_TIE,
    # with its first such symbol, flipped bits or not
    far = torch.maximum((d.re - plain.symbols.re).abs(),
                        (d.im - plain.symbols.im).abs()).reshape(c, -1) > NEAR_TIE
    apart = [(ch, int(torch.nonzero(far[ch])[0]))
             for ch in torch.nonzero(far.any(-1)).flatten().tolist()]
    print(f"  plain path on the same PCM ({label}): {int(flips.sum())} of "
          f"{flips.numel()} bits differ, all within {NEAR_TIE} of a decision "
          f"boundary"
          + (f" but on {len(parted)} channels whose loops parted at a tie "
             f"{parted}" if parted else "")
          + f"; derot max diff {cmax_abs(plain.symbols, d):.3g}"
          + (f"; derotated symbols part by more than {NEAR_TIE} on "
             f"{len(apart)} channels (channel, first symbol) {apart[:8]}"
             if apart else ""))
    return plain.symbols, plain.bits, flips


def parted_at_a_tie(cfg, sym_k, sym_p, away, label: str,
                    most: float | None = None) -> list:
    """The channels whose kernel-path and plain-path loops part at a tie
    of the loop's own decision, as [(channel, symbol of the tie)]: the
    Costas detector slices every symbol, so a symbol within NEAR_TIE of a
    decision boundary (the tie the bit check allows) may slice differently
    on the two paths, and the loop then carries the other decision into
    every later symbol.  A channel with bits ``away`` from a boundary must
    have parted so: its derotated symbols agree within 1e-4 (the derotated
    bound of the kernel comparisons) on every symbol up to and including a
    symbol t that lies within NEAR_TIE of a boundary on one of the two
    paths, and part (by more than NEAR_TIE) after t, before the first such
    bit; and at most 0.1 % of the channels may part (``most`` of them, if
    given)."""
    import torch

    if not bool(away.any()):
        return []
    c = away.shape[0]
    diff = torch.maximum((sym_k.re - sym_p.re).abs(),
                         (sym_k.im - sym_p.im).abs()).reshape(c, -1)
    dist = torch.minimum(boundary_distance(cfg, sym_k),
                         boundary_distance(cfg, sym_p)).reshape(c, -1)
    away_sym = away.reshape(c, diff.shape[1], -1).any(-1)
    parted = []
    for ch in torch.nonzero(away_sym.any(-1)).flatten().tolist():
        first_bit = int(torch.nonzero(away_sym[ch])[0])
        off = torch.nonzero(diff[ch] > 1e-4).flatten()
        agree = int(off[0]) if off.numel() else diff.shape[1]
        off = torch.nonzero(diff[ch] > NEAR_TIE).flatten()
        first_off = int(off[0]) if off.numel() else first_bit + 1
        # the last tie of the stretch on which the paths agree within 1e-4
        ties = torch.nonzero(dist[ch, :agree] < NEAR_TIE).flatten()
        t = int(ties[-1]) if ties.numel() else -1
        ok = 0 <= t < first_off <= first_bit
        need(ok, f"channel {ch}: the kernel and plain paths' bits differ away "
             f"from a decision boundary (|x| >= {NEAR_TIE}) at symbol "
             f"{first_bit} without a tie of the loop before it on which the "
             f"paths agree within 1e-4 ({label})")
        if ok:
            parted.append((ch, t))
    most = 0.001 * c if most is None else most
    need(len(parted) <= most, f"{len(parted)} of {c} channels' loops "
         f"parted ({label})")
    return parted


def compare_decodes(pcfg, out, plain_bits, flips, payload, label: str,
                    modulation: str = "qpsk", spur=None, link: bool = True,
                    skip_packets: int = 8, tracked: bool = False,
                    rotation=None):
    """``find_sync`` / ``extract_packets`` on 64 sampled channels of the
    kernel path's and the plain path's bits, 8 packets skipped: both must
    sync alike and pass the same packets (a packet holding a flipped bit
    may decode differently), every passing payload the one sent.  A
    sampled channel marked in ``spur`` (whose acquisition took a spur of
    the M-power spectrum, so that the loop locks a constellation step
    away) must sync alike too, but its payloads and offset are not
    checked and its packets count as lost.  With ``link`` (a geometry
    that carries the link) every passing payload must be the one sent and
    the loops' mean readback lie within 2 Hz of the offset sent (each
    channel's within 5 Hz); without, only the two paths' agreement is
    held, as a packet passing CRC on garbage bits is a CRC-16 false
    positive.  ``skip_packets`` packets are skipped (8, the CLI's
    transient); ``tracked`` extracts with the slip-tracked extractor;
    ``rotation`` is the sync rotation every channel must find (DQPSK's 0).
    Prints the loss; returns (packets, packets passing CRC, mean offset
    Hz)."""
    import torch

    c, nframes = out.bits.shape[:2]
    fb, skip = pcfg.frame_bits, skip_packets * pcfg.frame_bits
    skip -= skip % (out.bits.shape[2] // out.symbols.re.shape[2])  # cli.py
    channels = sorted({round(i * (c - 1) / 63) for i in range(64)})
    spurs = [] if spur is None else [ch for ch in channels if bool(spur[ch])]
    npk = nok = full = 0
    offsets = []
    for ch in channels:
        ks, krx = decode(pcfg, out.bits[ch].reshape(-1)[skip:], modulation,
                         tracked)
        ps, prx = decode(pcfg, plain_bits[ch].reshape(-1)[skip:], modulation,
                         tracked)
        need((int(ks.rotation), int(ks.bit_lag)) == (int(ps.rotation), int(ps.bit_lag)),
             f"channel {ch}: the kernel and plain paths sync differently ({label})")
        need(rotation is None or int(ks.rotation) == rotation,
             f"channel {ch}: synced at rotation {int(ks.rotation)} ({label})")
        navail = krx.crc_ok.shape[0]
        touched = torch.zeros(navail, dtype=torch.bool, device=out.bits.device)
        at = (torch.nonzero(flips[ch].reshape(-1)[skip:]).flatten()
              - int(ks.bit_lag)) // fb
        touched[at[(at >= 0) & (at < navail)]] = True
        need(abs(int(ks.score) - int(ps.score)) <= int(touched[:4].sum()),
             f"channel {ch}: sync score {int(ks.score)} vs plain {int(ps.score)}")
        need(torch.equal(krx.crc_ok[~touched], prx.crc_ok[~touched]),
             f"channel {ch}: the kernel and plain paths pass different packets "
             f"({label})")
        npk += navail
        if ch in spurs:
            continue
        nok += (check_payloads(krx, payload[ch], ch) if link
                else int(krx.crc_ok.sum()))
        full += int(ks.score) == 4
        offsets.append(float(out.freq_hz[ch, nframes // 2:].mean()))
    mean_offset = sum(offsets) / len(offsets)
    print(f"  {label}: on {len(channels)} channels the kernel and plain paths "
          f"sync alike and pass the same packets; "
          + (f"{len(spurs)} of them acquired a spur, their packets counted as "
             f"lost; " if spur is not None else "")
          + f"{full} synced at 4/4, "
          f"{nok}/{npk} packets pass CRC (PER {1 - nok / max(npk, 1):.5f}), "
          + ("all bit-exact" if link else "payloads not checked (no link)")
          + f"; detected offset {mean_offset:.4f} Hz (per channel "
          f"{min(offsets):.3f}..{max(offsets):.3f})")
    if link:
        need(abs(mean_offset - TX_OFFSET_HZ) <= 2.0,
             f"detected offset {mean_offset} Hz")
        need(max(abs(o - TX_OFFSET_HZ) for o in offsets) <= 5.0,
             "a channel's detected offset is off by more than 5 Hz")
    return npk, nok, mean_offset


def decode(pcfg, bits, modulation: str = "qpsk", tracked: bool = False):
    """(sync, packets) of a 1-D symbol-aligned bit stream: 4 probe
    packets, lags < 600; ``tracked``: the slip-tracked extractor."""
    from qpsk_tpu_torch.sync import (extract_packets, extract_packets_tracked,
                                     find_sync)

    sync = find_sync(pcfg, bits, max_lag=600, probe_frames=4,
                     modulation=modulation)
    navail = (bits.numel() - int(sync.bit_lag)) // pcfg.frame_bits
    if tracked:
        return sync, extract_packets_tracked(pcfg, bits, sync, max(navail, 1))
    return sync, extract_packets(pcfg, bits, sync, navail, modulation)


# the C entries of each kernel wrapper, by the kernel's name in the
# launch counts
KERNEL_ENTRIES = {"frontend": ("qpsk_frontend_pipe", "qpsk_frontend_gen"),
                  "costas": ("qpsk_costas_tm",),
                  "tx": ("qpsk_tx", "qpsk_tx_gen"),
                  "viterbi": ("qpsk_viterbi", "qpsk_viterbi_gen"),
                  "ldpc": ("qpsk_ldpc",)}


def kernel_launches(names=tuple(KERNEL_ENTRIES)) -> dict:
    """{kernel: its C entries' launches since ``reset_launches``} of each
    kernel of ``names``."""
    return {k: sum(_lib.launches[e] for e in KERNEL_ENTRIES[k])
            for k in names}


def reset_launches() -> None:
    """Every launch count to 0."""
    _lib.launches.clear()


def main_path(cfg, pcfg, dev, errs: dict) -> dict:
    """Phase 3: the full-width loopback through the kernels, then each
    kernel and the plain path on the same inputs."""
    import torch
    from qpsk_tpu_torch import rx_init, rx_stream

    c, nframes = MAIN_PATH
    nsym = cfg.symbols_per_frame
    reset_launches()
    t0 = time.perf_counter()
    payload, chan, clean, pcm = loopback_pcm(cfg, pcfg, c, nframes, seed=2024,
                                             dev=dev)
    _, out = rx_stream(cfg, rx_init(cfg, (c,), device=dev), pcm)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernel_launches(("frontend", "costas", "tx"))
    print(f"  {c} channels x {nframes} frames: TX -> AWGN -> RX in {seconds:.3f} s "
          f"(host clock, first call); launches {counts}")
    for name, n in counts.items():
        need(n > 0, f"the main path never launched the {name} kernel")
    need(bool(torch.isfinite(out.symbols.re).all() and torch.isfinite(out.symbols.im).all()),
         "non-finite symbols")
    need(tuple(out.bits.shape) == (c, nframes, 2 * nsym),
         f"bits of shape {tuple(out.bits.shape)}")

    _, plain_bits, flips = check_path(cfg, chan, clean, pcm, out, dev,
                                      f"C={c} main path", errs)
    compare_decodes(pcfg, out, plain_bits, flips, payload, "main path")
    return counts


def rates(cfg, dev, errs: dict) -> dict:
    """Phase 4: each kernel against its plain version at 8192 channels x 8
    frames, then samples/s and {kernel: (kernel ms, plain ms)} there."""
    import torch
    from qpsk_tpu_torch import rx_init, tx_init, tx_stream
    from qpsk_tpu_torch.ops.costas import costas_init, costas_params
    from qpsk_tpu_torch.ops.cplx import CF32
    from qpsk_tpu_torch.ops.cuda import costas_kernel as ck
    from qpsk_tpu_torch.ops.cuda import frontend_kernel as fk
    from qpsk_tpu_torch.ops.cuda import tx_kernel as tk
    from qpsk_tpu_torch.ops.modmap import bits_to_symbols

    (c, nframes), iters = RATE_POINT, 20
    nsym = cfg.symbols_per_frame
    nsamples = c * nframes * cfg.frame_size
    pcm = noise_pcm(cfg, c, nframes, 7, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    bits = torch.randint(0, 2, (c, nframes, 2 * nsym), generator=gen,
                         device=dev, dtype=torch.int32)

    # the wrappers' inputs at this shape: the first call of a chained
    # rx_stream / tx_stream, on noise PCM and random symbols
    label = f"C={c} F={nframes} noise"
    st = rx_init(cfg, (c,), device=dev)
    fe_args = (cfg, pcm, st.nco_phase, st.fir_tail, st.decim_delay)
    kf, _ = check_frontend(cfg, pcm, st, False, label, errs)
    params = costas_params(cfg.loop_bw, cfg.damping, cfg.min_freq, cfg.max_freq)
    costas_args = (costas_init((c,), device=dev), kf[0], kf[1], params, nsym)
    check_costas(*costas_args, False, label, errs)
    sym = bits_to_symbols(bits.reshape(c, -1))
    sym = CF32(sym.re.contiguous(), sym.im.contiguous())
    ts = tx_init(cfg, (c,), device=dev)
    check_tx(cfg, sym, ts, f"C={c} S={nframes * nsym}", errs)

    for name in ("kernel", "plain"):
        ms = cuda_time_ms(rx_step(cfg, dev, pcm, name)[0], iters)
        print(f"  rx_stream {name:6s} path: {ms:.4f} ms/call, "
              f"{nsamples / ms * 1e3:.6g} samples/s")

    tstate = [tx_init(cfg, (c,), device=dev)]

    def tx_step():
        tstate[0], _ = tx_stream(cfg, tstate[0], bits, TX_OFFSET_HZ)
    ms = cuda_time_ms(tx_step, iters)
    print(f"  tx_stream kernel path: {ms:.4f} ms/call, {nsamples / ms * 1e3:.6g} samples/s")

    # each kernel's wrapper beside its plain version, same inputs
    return {name: time_pair(name, kern, plain, args, {}, n, iters) + work
            for name, kern, plain, args, n, work in (
                ("frontend", fk.rx_frontend_tm, fk.rx_frontend_tm_plain,
                 fe_args, iters, frontend_work(c, nframes, 4, True, False)),
                ("costas", ck.costas_run_tm, ck.costas_run_tm_plain,
                 costas_args, 5, costas_work(c, nframes * nsym, nsym)),
                ("tx", tk.tx_modulate, tk.tx_modulate_plain,
                 (cfg, sym, ts.nco_phase, ts.fir_tail, TX_OFFSET_HZ), iters,
                 tx_work(c, nframes * nsym, 4)))}


def time_pair(name: str, kern, plain, args, kw: dict, n_plain: int,
              iters: int) -> tuple:
    """(kernel ms, plain ms) of one wrapper and its plain version on the
    same inputs, timed plain, kernel, kernel, plain: each side's best of
    its two runs."""
    p1 = cuda_time_ms(lambda: plain(*args, **kw), n_plain, warmup=1)
    k1 = cuda_time_ms(lambda: kern(*args, **kw), iters)
    k2 = cuda_time_ms(lambda: kern(*args, **kw), iters)
    p2 = cuda_time_ms(lambda: plain(*args, **kw), n_plain, warmup=1)
    print(f"  {name:8s} kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms")
    if name.startswith(("costas", "frontend", "tx")):
        ALONE[name] = kernel_alone(
            name, lambda: kern(*args, **kw),
            args[1].shape[0] if name.startswith("costas") else None)
    return min(k1, k2), min(p1, p2)


# each wrapper's time alone in a CUDA graph, as time_pair last took it
ALONE: dict = {}


def print_bound(name: str, t: tuple) -> None:
    """A front-end or TX row ``t`` = (wrapper ms, plain ms, bound ms, what
    bounds it, float32-FMA floor ms): its times beside its bound and its
    floor, the FIR priced on the tensor cores in three float16 passes."""
    alone = ALONE.get(name)
    print(f"  {name}: {t[0]:.4f} ms (alone in a CUDA graph "
          f"{'not measured' if alone is None else f'{alone:.4f}'}), bound "
          f"{t[2]:.4f} ms ({t[3]}), float32-FMA floor {t[4]:.4f} ms")


def kernel_alone(name: str, fn, steps: int | None = None) -> float:
    """The wrapper ``fn``'s device time with no host in the way: 20 calls
    captured into a CUDA graph and replayed (``fec_times.graph_ms``), twice.
    For the Costas loop (``steps`` symbols a chain) also the cycles a step
    at the card's top SM clock: the serial chain's latency."""
    from fec_times import graph_ms
    g1, g2 = graph_ms(fn), graph_ms(fn)
    msg = f"  {name:8s} alone in a CUDA graph {g1:.4f} / {g2:.4f} ms"
    if steps:
        mhz = float(nvidia_smi_line("clocks.max.sm").split()[0])
        msg += (f"; {min(g1, g2) * 1e3 * mhz / steps:.1f} cycles a step of "
                f"{steps} at {mhz:.0f} MHz")
    print(msg)
    return min(g1, g2)


@contextlib.contextmanager
def plain_decoders():
    """Inside, ``fec.viterbi_decode`` and ``ldpc.ldpc_decode`` run the
    plain versions on CUDA tensors: the reference run of phase 5."""
    from qpsk_tpu_torch.ops.cuda import ldpc_kernel as lk
    from qpsk_tpu_torch.ops.cuda import viterbi_kernel as vk
    saved = vk.viterbi_decode, lk.ldpc_decode
    vk.viterbi_decode = (lambda code, llrs, nbits, impl="auto":
                         saved[0](code, llrs, nbits, "scan"))
    lk.ldpc_decode = (lambda code, llrs, iters=None, impl="auto":
                      saved[1](code, llrs, iters, "xla"))
    try:
        yield
    finally:
        vk.viterbi_decode, lk.ldpc_decode = saved


def fec_code(kind: str, other: bool = False):
    """The slice's code (256 message bits), or with ``other`` the phase-5a
    one: the swapped generators, LDPC at 127-byte payloads."""
    from qpsk_tpu_torch.packet import ConvCode, LdpcCode
    if kind == "conv":
        return ConvCode(polys=CONV_SWAPPED) if other else ConvCode()
    return LdpcCode(k=LDPC_K_127 if other else 256)


def fec_decoders(kind: str, other: bool = False):
    """(name, kernel wrapper, plain version) of ``fec_code(kind, other)``,
    each taking (..., n) LLRs to (..., k) bits."""
    from qpsk_tpu_torch.ops.cuda import ldpc_kernel as lk
    from qpsk_tpu_torch.ops.cuda import viterbi_kernel as vk
    code = fec_code(kind, other)
    if kind == "conv":
        return ("viterbi", lambda x: vk.viterbi_decode(code, x, 256),
                lambda x: vk.viterbi_decode_plain(code, x, 256))
    return ("ldpc", lambda x: lk.ldpc_decode(code, x),
            lambda x: lk.ldpc_decode_plain(code, x))


def fec_encode(kind: str, u, other: bool = False):
    from qpsk_tpu_torch.packet import conv_encode, ldpc_encode
    code = fec_code(kind, other)
    return conv_encode(code, u) if kind == "conv" else ldpc_encode(code, u)


def check_fec(kind: str, llrs, u, label: str, errs: dict, other: bool = False):
    """A FEC kernel against its plain version on the same LLRs: Viterbi
    bits equal, LDPC bits >= 99.9 % equal; with the payload ``u`` sent,
    both must decode the same number of packets clean."""
    name, kern, plain = fec_decoders(kind, other)
    k, p = kern(llrs), plain(llrs)
    rate = agree(label, f"{name} bit", k == p, exact=kind == "conv")
    errs[name] = max(errs[name], 1.0 - rate)
    msg = f"  {name:8s} {label}: bit agreement {rate:.6f}"
    if u is not None:
        ck, cp = int((k == u).all(-1).sum()), int((p == u).all(-1).sum())
        need(ck == cp, f"{name} decodes {ck} packets clean, plain {cp} ({label})")
        msg += f", {ck}/{u.shape[0]} packets clean (plain {cp})"
    print(msg)


def check_viterbi_lanes(llrs, errs: dict, other: bool = False) -> None:
    """Every shape of the Viterbi kernel against the plain version,
    whatever shape the wrapper picks for this batch."""
    from qpsk_tpu_torch.ops.cuda import viterbi_kernel as vk

    code = fec_code("conv", other)
    want = vk.viterbi_decode_plain(code, llrs, 256)
    for lanes in FEC_LANES:
        got = vk._launch(code, llrs, 256, lanes=lanes)
        rate = agree(f"B={llrs.shape[0]} hard 3 %, {lanes} lanes a packet",
                     "viterbi bit", got == want, exact=True)
        errs["viterbi"] = max(errs["viterbi"], 1.0 - rate)
    print(f"  viterbi  B={llrs.shape[0]:5d} hard 3 %: equal with "
          f"{', '.join(map(str, FEC_LANES))} lanes a packet"
          + (f", polys {tuple(oct(g) for g in code.polys)}" if other else ""))


def compare_fec(dev, errs: dict) -> None:
    """Phase 5a: each FEC kernel against its plain version, then the
    codewords both must decode clean."""
    import numpy as np
    import torch
    from qpsk_tpu_torch.packet import hard_llrs

    for kind in ("conv", "ldpc"):
        for b in FEC_COMPARE[kind]:
            gen = torch.Generator(device=dev).manual_seed(b)
            u = torch.randint(0, 2, (b, 256), generator=gen, device=dev,
                              dtype=torch.int32)
            c = fec_encode(kind, u)
            noisy = (1.0 - 2.0 * c) + 0.7 * torch.randn(c.shape, generator=gen,
                                                        device=dev)
            flips = (torch.rand(c.shape, generator=gen, device=dev) < 0.03)
            hard = hard_llrs(c ^ flips.to(torch.int32))
            for stim, llrs in (("sigma 0.7", noisy), ("hard 3 %", hard)):
                check_fec(kind, llrs, u, f"B={b:5d} {stim}", errs)
            if kind == "conv" and b == 200:
                check_viterbi_lanes(hard, errs)

        # the CPU tests' inputs (tests/test_torch_fec.py, numpy seed 2):
        # 64 codewords at sigma 0.55 (Viterbi) or 0.6 (LDPC)
        sigma = {"conv": 0.55, "ldpc": 0.6}[kind]
        rng = np.random.default_rng(2)
        u = rng.integers(0, 2, (64, 256), dtype=np.int32)
        c = fec_encode(kind, torch.from_numpy(u)).numpy()
        llrs = ((1.0 - 2.0 * c) + rng.normal(0, sigma, c.shape)).astype(np.float32)
        ut, lt = torch.from_numpy(u).to(dev), torch.from_numpy(llrs).to(dev)
        name, kern, plain = fec_decoders(kind)
        for which, fn in (("kernel", kern), ("plain", plain)):
            need(torch.equal(fn(lt), ut),
                 f"the {which} {name} decoder misses sigma {sigma} codewords")

    # the other codes: LDPC with 1032 checks (two a thread), Viterbi with
    # the generators swapped (the sign masks from the argument)
    for kind, batches in FEC_OTHER.items():
        k = fec_code(kind, True).k if kind == "ldpc" else 256
        for b in batches:
            gen = torch.Generator(device=dev).manual_seed(b + 5)
            u = torch.randint(0, 2, (b, k), generator=gen, device=dev,
                              dtype=torch.int32)
            c = fec_encode(kind, u, True)
            noisy = (1.0 - 2.0 * c) + 0.7 * torch.randn(c.shape, generator=gen,
                                                        device=dev)
            flips = (torch.rand(c.shape, generator=gen, device=dev) < 0.03)
            hard = hard_llrs(c ^ flips.to(torch.int32))
            what = ("m=1032" if kind == "ldpc"
                    else f"polys {tuple(oct(g) for g in CONV_SWAPPED)}")
            for stim, llrs in (("sigma 0.7", noisy), ("hard 3 %", hard)):
                check_fec(kind, llrs, u, f"{what} B={b:5d} {stim}", errs,
                          other=True)
            if kind == "conv" and b == 200:
                check_viterbi_lanes(hard, errs, other=True)
        print(f"  {name:8s} 64 codewords at sigma {sigma}: kernel and plain "
              "decode all clean")


def check_payloads(rx, sent, ch: int) -> int:
    """Every CRC-passing packet of a channel is the payload sent at its
    place; returns their count."""
    import torch
    ok, got, want = rx.crc_ok.cpu(), rx.payload_bits.cpu(), sent.cpu()
    if not bool(ok.any()):
        return 0
    i0 = int(torch.argmax(ok.to(torch.int32)))
    k0 = next((k for k in range(want.shape[0]) if torch.equal(got[i0], want[k])), None)
    need(k0 is not None, f"channel {ch}: no payload matched")
    k0 -= i0
    for i in torch.nonzero(ok).flatten().tolist():
        need(0 <= i + k0 < want.shape[0] and torch.equal(got[i], want[i + k0]),
             f"channel {ch}: packet {i} passed CRC with a wrong payload")
    return int(ok.sum())


def coded_loopback(cfg, kind: str, dev, errs: dict) -> int:
    """Phase 5b: the coded loopback at full width through the kernels.
    Then the same LLRs through the plain decoders (same sync; conv: the
    same verdicts and payloads, LDPC: verdicts differ on <= 0.1 % of
    packets); each modem kernel against its plain version on this path's
    own inputs; and the plain path's LLRs (plain front-end -> plain
    Costas on the same PCM) through the decoder kernel: the same rotation
    and lag, CRC verdicts differing on <= 0.1 % of packets, where a
    derotated symbol's last bits may tip a near-tie path metric.  Returns
    the decoder kernel's launch count in the kernel run."""
    import torch
    from qpsk_tpu_torch import rx_init, rx_stream, tx_init, tx_stream
    from qpsk_tpu_torch.channel import awgn_pcm
    from qpsk_tpu_torch.metrics import evm, per, snr_estimate_db
    from qpsk_tpu_torch.ops.cplx import CF32
    from qpsk_tpu_torch.ops.modmap import demod_soft
    from qpsk_tpu_torch.packet import PacketConfig, assemble_packet
    from qpsk_tpu_torch.sync import (default_max_lag,
                                     extract_packets_soft_tracked,
                                     find_sync_streams, rotate_soft)

    pcfg = PacketConfig(payload_bytes=30, fec=kind)
    (c, npkt), fb, mfb = CODED_PATH, pcfg.frame_bits, cfg.bits_per_frame
    skip = 8 * fb      # the CLI's skip of the Costas transient (cli.py:167-174)
    channels = sorted({round(i * (c - 1) / 63) for i in range(64)})
    decoder = "viterbi" if kind == "conv" else "ldpc"

    def decode(llrs):
        rows = torch.stack([rotate_soft(llrs, r) for r in range(4)])
        sync = find_sync_streams(pcfg, rows, max_lag=default_max_lag(pcfg),
                                 probe_frames=8, soft=True)
        navail = (llrs.numel() - int(sync.bit_lag)) // fb
        return sync, extract_packets_soft_tracked(pcfg, llrs, sync, navail)

    reset_launches()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(2025)
    payload = torch.randint(0, 2, (c, npkt, 8 * pcfg.payload_bytes),
                            generator=gen, device=dev, dtype=torch.int32)
    chan = assemble_packet(pcfg, payload).reshape(c, -1)
    # re-framed into whole modem frames, the tail padded with filler bits
    nframes = -(-chan.shape[1] // mfb)
    filler = torch.randint(0, 2, (c, nframes * mfb - chan.shape[1]),
                           generator=gen, device=dev, dtype=torch.int32)
    frames = torch.cat([chan, filler], dim=1).reshape(c, nframes, mfb)
    _, clean = tx_stream(cfg, tx_init(cfg, (c,), device=dev), frames,
                         tx_offset_hz=TX_OFFSET_HZ)
    power = float(((clean.to(torch.float32) / cfg.pcm_scale) ** 2).mean())
    pcm = awgn_pcm(gen, clean, CODED_SNR_DB, power, cfg.pcm_scale)
    _, out = rx_stream(cfg, rx_init(cfg, (c,), device=dev), pcm)
    llrs = demod_soft(out.symbols).reshape(c, -1)
    results = [decode(llrs[ch, skip:]) for ch in channels]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernel_launches()
    print(f"  fec={kind}: {c} channels x {npkt} packets = {nframes} frames, "
          f"TX -> AWGN {CODED_SNR_DB} dB -> RX -> soft sync and tracked "
          f"extraction on {len(channels)} channels in {seconds:.3f} s (host "
          f"clock, first call); launches {counts}")
    for name in ("frontend", "costas", "tx", decoder):
        need(counts[name] > 0, f"the coded {kind} path never launched the {name} kernel")
    need(bool(torch.isfinite(llrs).all()), "non-finite LLRs")
    need(tuple(out.bits.shape) == (c, nframes, mfb), f"bits of shape {tuple(out.bits.shape)}")

    with plain_decoders():
        plain = [decode(llrs[ch, skip:]) for ch in channels]
    # the plain modem path on the same PCM, its LLRs through the kernels
    plain_sym, _, _ = check_path(cfg, frames, clean, pcm, out, dev,
                                 f"C={c} fec={kind}", errs)
    plain_llrs = demod_soft(plain_sym).reshape(c, -1)
    print(f"  fec={kind}: plain path LLRs max diff "
          f"{max_abs(plain_llrs, llrs):.3g} from the kernel path's")
    plain_path = [decode(plain_llrs[ch, skip:]) for ch in channels]

    def differ(ch, a, b, what):
        found = torch.nonzero(a.crc_ok != b.crc_ok).flatten().tolist()
        for i in found:
            print(f"    channel {ch} packet {i}: CRC {bool(a.crc_ok[i])}, "
                  f"{what} {bool(b.crc_ok[i])}")
        return [(ch, i) for i in found]

    synced = full = nok = 0
    diffs, path_diffs, offsets, verdicts = [], [], [], []
    for ch, (ks, krx), (ps, prx), (qs, qrx) in zip(channels, results, plain,
                                                   plain_path):
        key = (int(ks.rotation), int(ks.bit_lag), int(ks.score))
        need(key == (int(ps.rotation), int(ps.bit_lag), int(ps.score)),
             f"channel {ch}: the kernel and plain decoders sync differently")
        need(key[:2] == (int(qs.rotation), int(qs.bit_lag)),
             f"channel {ch}: the kernel and plain modem paths sync differently")
        if kind == "conv":
            need(all(torch.equal(a, b) for a, b in zip(krx, prx)),
                 f"channel {ch}: the kernel and plain Viterbi pass different "
                 "packets or payloads")
        else:
            diffs += differ(ch, krx, prx, "plain decoder")
        path_diffs += differ(ch, krx, qrx, "plain modem path")
        nok += check_payloads(krx, payload[ch], ch)
        check_payloads(prx, payload[ch], ch)
        check_payloads(qrx, payload[ch], ch)
        synced += key[2] > 0
        full += key[2] == 8
        verdicts.append(krx.crc_ok)
        offsets.append(float(out.freq_hz[ch, nframes // 2:].mean()))
    npk = sum(v.numel() for v in verdicts)
    need(len(diffs) <= 0.001 * npk,
         f"the kernel and plain LDPC decoders differ on {len(diffs)} of {npk} packets")
    need(len(path_diffs) <= 0.001 * npk, f"the kernel and plain modem paths "
         f"differ on {len(path_diffs)} of {npk} packets")
    mean_offset = sum(offsets) / len(offsets)
    # link quality of the sampled channels past the Costas transient
    post = CF32(*(p[channels, 8:].reshape(len(channels), -1)
                  for p in out.symbols))
    print(f"  fec={kind}: {synced}/{len(channels)} channels synced ({full} at "
          f"8/8), {nok}/{npk} packets pass CRC, PER "
          f"{float(per(torch.cat(verdicts))):.5f}, all {nok} bit-exact; kernel "
          f"and plain decoders sync alike, {len(diffs)} CRC verdicts differ; "
          f"kernel and plain modem paths sync alike, {len(path_diffs)} CRC "
          f"verdicts differ; "
          f"detected offset {mean_offset:.4f} Hz (per channel "
          f"{min(offsets):.3f}..{max(offsets):.3f}); EVM "
          f"{float(evm(post).evm_rms.mean()):.4f}, estimated SNR "
          f"{float(snr_estimate_db(post).mean()):.3f} dB")
    need(abs(mean_offset - TX_OFFSET_HZ) <= 2.0, f"detected offset {mean_offset} Hz")
    # a loose floor against gross failure: the JAX package measured a PER
    # of about 0.1 at 6 dB for both codes (docs/per_vs_snr_coded.jsonl,
    # docs/per_vs_snr_ldpc.jsonl)
    need(nok >= npk // 2, f"only {nok} of {npk} coded packets pass CRC")
    return counts[decoder]


def rx_step(cfg, dev, pcm, path: str, kind: str | None = None):
    """One receive call on ``pcm`` (C, F, 512), state chained from call to
    call, through the kernels (``path="kernel"``) or the plain versions:
    ``rx_stream``'s chain for ``cfg``, and with a code ``kind`` also soft
    LLRs with every demodulated bit deframed and decoded (the shape of
    ``benchmarks.coded_rx_throughput``).  Returns (step, packets per
    call); inside ``plain_decoders()`` the plain path decodes plain."""
    import torch
    from qpsk_tpu_torch import rx_init
    from qpsk_tpu_torch.ops.cplx import CF32
    from qpsk_tpu_torch.ops.modmap import demod_soft
    from qpsk_tpu_torch.packet import PacketConfig, disassemble_packet_soft

    from qpsk_tpu_torch import modem

    c, nframes = pcm.shape[:2]
    cfg = path_cfg(cfg, path)
    chain, frontend, costas = modem._rx_path(cfg)
    state = [rx_init(cfg, (c,), device=dev)]
    nbits = c * nframes * cfg.bits_per_frame
    pcfg = PacketConfig(payload_bytes=30, fec=kind or False)
    fb = pcfg.frame_bits
    npkt = -(-nbits // fb) if kind else 0     # every demodulated bit decoded
    pad = npkt * fb - nbits

    def step():
        state[0], out = chain(cfg, state[0], pcm, frontend, costas)
        if kind:
            llr = demod_soft(CF32(out.symbols.re.reshape(-1),
                                  out.symbols.im.reshape(-1)))
            llr = torch.cat([llr, llr.new_zeros(pad)])
            disassemble_packet_soft(pcfg, llr.reshape(npkt, fb))
    return step, npkt


def coded_rates(cfg, dev, errs: dict) -> dict:
    """Phase 5c: the composed coded receive rate of the kernel and plain
    paths per code, then each FEC kernel alone at 4096 packets beside its
    plain version.  Returns {kernel: (kernel ms, plain ms)}."""
    import torch

    (c, nframes), iters = CODED_RATE_POINT, 10
    nsamples = c * nframes * cfg.frame_size
    pcm = noise_pcm(cfg, c, nframes, 13, dev)
    for kind in ("conv", "ldpc"):
        def run(path, n):
            step, _ = rx_step(cfg, dev, pcm, path, kind)
            if path == "kernel":
                return cuda_time_ms(step, n)
            with plain_decoders():
                return cuda_time_ms(step, n, warmup=1)
        npkt = rx_step(cfg, dev, pcm, "kernel", kind)[1]
        p1, k1, k2, p2 = run("plain", 2), run("kernel", iters), \
            run("kernel", iters), run("plain", 2)
        print(f"  coded RX fec={kind} ({npkt} packets per call): kernel path "
              f"{k1:.4f} / {k2:.4f} ms/call, {nsamples / min(k1, k2) * 1e3:.6g} "
              f"samples/s; plain path {p1:.4f} / {p2:.4f} ms/call, "
              f"{nsamples / min(p1, p2) * 1e3:.6g} samples/s")

    times = {}
    gen = torch.Generator(device=dev).manual_seed(17)
    b = FEC_RATE_PACKETS
    for kind, n in (("conv", 524), ("ldpc", 512)):
        llrs = torch.randn((b, n), generator=gen, device=dev)
        check_fec(kind, llrs, None, f"B={b} random LLRs", errs)
        name, kern, plain = fec_decoders(kind)
        times[name] = time_pair(name, kern, plain, (llrs,), {}, 3, 20) \
            + fec_work(name, b)
        info = b * 256
        print(f"  {name:8s} at {b} packets: {info / times[name][0] * 1e3:.6g} "
              f"vs {info / times[name][1] * 1e3:.6g} info bits/s")

    # the kernels alone at the batch sizes the coded paths give them
    from fec_times import graph_ms
    for kind, n in (("conv", 524), ("ldpc", 512)):
        name, kern, _ = fec_decoders(kind)
        for b in FEC_PATH_PACKETS[name]:
            llrs = torch.randn((b, n), generator=gen, device=dev)
            k1, k2 = (graph_ms(lambda: kern(llrs)) for _ in range(2))
            w1 = cuda_time_ms(lambda: kern(llrs), 50)
            print(f"  {name:8s} at {b} packets (path shape): kernel alone "
                  f"{k1:.4f} / {k2:.4f} ms in a CUDA graph, {w1:.4f} ms "
                  f"launched from the host; bound {fec_work(name, b)[0]:.5f} ms")
    return times


def fec_build_lines(log: str) -> None:
    """Print what ptxas said of the two decoders' kernels: registers,
    stack frame and spills of every instantiation."""
    show = False
    for line in log.splitlines():
        if "Compiling entry" in line:
            show = "viterbi" in line or "ldpc" in line
        if show and ("Compiling entry" in line or "registers" in line
                     or "spill" in line):
            print("  " + line.strip())


def fec_shapes(dev) -> None:
    """``--fec``: the Viterbi kernel at every lane count against the plain
    version (equal), timed at the paths' batch sizes, at the rate point
    and between them: the table behind ``viterbi_kernel._lanes``.  The
    LDPC kernel, which has one shape, at the same batches."""
    import torch
    from fec_times import graph_ms
    from qpsk_tpu_torch.ops.cuda import viterbi_kernel as vk
    from qpsk_tpu_torch.packet import ConvCode

    conv = ConvCode()
    gen = torch.Generator(device=dev).manual_seed(19)
    _, ldpc, ldpc_plain = fec_decoders("ldpc")
    for b in (156, 1024, 2048, FEC_RATE_PACKETS, 8192, 16768, 67072):
        llrs = torch.randn((b, 524), generator=gen, device=dev)
        want = vk.viterbi_decode_plain(conv, llrs, 256)
        for lanes in FEC_LANES:
            def run():
                return vk._launch(conv, llrs, 256, lanes=lanes)
            need(torch.equal(run(), want),
                 f"viterbi with {lanes} lanes a packet differs at B={b}")
            t1, t2 = (graph_ms(run) for _ in range(2))
            print(f"  viterbi  B={b:5d} lanes {lanes:2d}"
                  f"{' (the wrapper picks it)' if lanes == vk._lanes(b) else ''}"
                  f": equal, {t1:.4f} / {t2:.4f} ms in a CUDA graph, "
                  f"{cuda_time_ms(run, 50):.4f} ms launched from the host "
                  f"(bound {fec_work('viterbi', b)[0]:.5f} ms)")
        llrs = torch.randn((b, 512), generator=gen, device=dev)
        same = float((ldpc(llrs) == ldpc_plain(llrs)).float().mean())
        need(same >= 0.999, f"ldpc agrees on {same:.6f} at B={b}")
        t1, t2 = (graph_ms(lambda: ldpc(llrs)) for _ in range(2))
        print(f"  ldpc     B={b:5d}: agreement {same:.6f}, {t1:.4f} / {t2:.4f} "
              f"ms in a CUDA graph, {cuda_time_ms(lambda: ldpc(llrs), 50):.4f} "
              f"ms launched from the host (bound "
              f"{fec_work('ldpc', b)[0]:.5f} ms)")


# every kernel and mode: (source, the TPU kernel's pallas_call it replaces)
_FE, _CO, _TX = ("qpsk_tpu_torch/csrc/frontend.cu", "qpsk_tpu_torch/csrc/costas.cu",
                 "qpsk_tpu_torch/csrc/tx.cu")
KERNELS = {
    "frontend": (_FE, "qpsk_tpu/ops/pallas/frontend_kernel.py:545"),
    "frontend_tm_power": (_FE, "qpsk_tpu/ops/pallas/frontend_kernel.py:545"),
    "frontend_cm": (_FE, "qpsk_tpu/ops/pallas/frontend_kernel.py:451"),
    "frontend_cm_1200": (_FE, "qpsk_tpu/ops/pallas/frontend_kernel.py:451"),
    "costas": (_CO, "qpsk_tpu/ops/pallas/costas_kernel.py:373"),
    "costas_gear": (_CO, "qpsk_tpu/ops/pallas/costas_kernel.py:373"),
    "costas_gains": (_CO, "qpsk_tpu/ops/pallas/costas_kernel.py:373"),
    "costas_dd_bpsk": (_CO, "qpsk_tpu/ops/pallas/costas_kernel.py:373"),
    "costas_dd_8psk": (_CO, "qpsk_tpu/ops/pallas/costas_kernel.py:373"),
    "costas_dd_16qam": (_CO, "qpsk_tpu/ops/pallas/costas_kernel.py:373"),
    "tx": (_TX, "qpsk_tpu/ops/pallas/tx_kernel.py:145"),
    "tx_1200": (_TX, "qpsk_tpu/ops/pallas/tx_kernel.py:145"),
    "viterbi": ("qpsk_tpu_torch/csrc/viterbi.cu",
                "qpsk_tpu/ops/pallas/viterbi_kernel.py:151+166"),
    "ldpc": ("qpsk_tpu_torch/csrc/ldpc.cu",
             "qpsk_tpu/ops/pallas/ldpc_kernel.py:116"),
    # the general instances (phase 8b)
    "frontend_gen": (_FE, "qpsk_tpu/ops/pallas/frontend_kernel.py:545"),
    "frontend_gen_power": (_FE, "qpsk_tpu/ops/pallas/frontend_kernel.py:545"),
    "frontend_cm_gen": (_FE, "qpsk_tpu/ops/pallas/frontend_kernel.py:451"),
    "tx_gen": (_TX, "qpsk_tpu/ops/pallas/tx_kernel.py:145"),
    "viterbi_gen": ("qpsk_tpu_torch/csrc/viterbi.cu",
                    "qpsk_tpu/ops/pallas/viterbi_kernel.py:151+166"),
    "ldpc_gen": ("qpsk_tpu_torch/csrc/ldpc.cu",
                 "qpsk_tpu/ops/pallas/ldpc_kernel.py:116"),
    # the Costas kernel with a stream's blocks on its channel axis (phase 11)
    "costas_blocks": (_CO, "qpsk_tpu/ops/pallas/costas_kernel.py:373"),
    # the Costas kernel on one rank's time block of a stream (phase 12)
    "costas_timeparallel": (_CO, "qpsk_tpu/ops/pallas/costas_kernel.py:373"),
}


def option_cfg(name: str):
    """The ModemConfig of a phase-6 path."""
    from qpsk_tpu_torch import ModemConfig
    return ModemConfig(**OPTION_PATHS[name][0])


def compare_options(pcfg, dev, errs: dict) -> None:
    """Phase 6a: each new kernel or mode against its plain version, in two
    chained calls of the rate point's length at each channel count."""
    import torch
    from qpsk_tpu_torch import ModemConfig, rx_init, tx_init
    from qpsk_tpu_torch.ops.agc import agc_gains
    from qpsk_tpu_torch.ops.costas import costas_init, costas_params, gear_for
    from qpsk_tpu_torch.ops.cplx import CF32
    from qpsk_tpu_torch.ops.modmap import bits_to_symbols

    nframes = RATE_POINT[1]
    level, c1200 = option_cfg("level"), option_cfg("1200")
    nsym = level.symbols_per_frame
    t = nframes * nsym
    gear = gear_for(level.loop_bw_track, level.damping)
    params = costas_params(level.loop_bw, level.damping, level.min_freq,
                           level.max_freq)
    for c in COMPARE_CHANNELS:
        t8 = nframes * c1200.symbols_per_frame
        gen = torch.Generator(device=dev).manual_seed(c + 10)
        sym = bits_to_symbols(torch.randint(0, 2, (c, 4 * t8), generator=gen,
                                            device=dev, dtype=torch.int32))
        st = tx_init(c1200, (c,), device=dev)
        for i in range(2):
            s = CF32(sym.re[:, i * t8:(i + 1) * t8].contiguous(),
                     sym.im[:, i * t8:(i + 1) * t8].contiguous())
            _, st = check_tx(c1200, s, st, f"C={c:5d} call {i}", errs,
                             key="tx_1200", lsb=1)

        for cfg, key in ((ModemConfig(), "frontend_cm"),
                         (c1200, "frontend_cm_1200")):
            lb = loopback_pcm(cfg, pcfg, c, 2 * nframes, seed=c, dev=dev)[3]
            for kind, pcm in (("loopback", lb),
                              ("noise", noise_pcm(cfg, c, 2 * nframes, c + 1, dev))):
                st = rx_init(cfg, (c,), device=dev)
                for i in range(2):
                    x = pcm[:, i * nframes:(i + 1) * nframes].contiguous()
                    _, p = check_frontend_cm(cfg, x, st, kind == "loopback",
                                             f"C={c:5d} {kind} call {i}", errs,
                                             key)
                    st = st._replace(nco_phase=p[2], fir_tail=p[3])

        # the power output and the Costas modes on the level path's
        # stimulus (AWGN 10 dB, then -26 dB) and on noise
        lb = loopback_pcm(level, pcfg, c, 2 * nframes, seed=c, dev=dev,
                          level_db=-26.0)[3]
        for kind, pcm in (("loopback", lb),
                          ("noise", noise_pcm(level, c, 2 * nframes, c + 1, dev))):
            exact = kind == "loopback"
            st = rx_init(level, (c,), device=dev)
            fe = []
            for i in range(2):
                x = pcm[:, i * nframes:(i + 1) * nframes].contiguous()
                _, p = check_frontend(level, x, st, exact,
                                      f"C={c:5d} {kind} call {i}", errs)
                fe.append(p)
                st = st._replace(nco_phase=p[3], fir_tail=p[4], decim_delay=p[5])
            if exact:     # the plain front-end's picks and their AGC gains
                zr, zi = (torch.cat([p[k] for p in fe]) for k in (0, 1))
                _, g = agc_gains(rx_init(level, (c,), device=dev).agc,
                                 torch.cat([p[6] for p in fe], dim=1),
                                 level.agc_target, level.agc_mu)
                gains = g.T.contiguous()
            else:         # Gaussian symbols and gains in [0.5, 2)
                g2 = torch.Generator(device=dev).manual_seed(c + 2)
                zr, zi = (torch.randn((2 * t, c), generator=g2, device=dev)
                          for _ in range(2))
                gains = torch.rand((2 * nframes, c), generator=g2,
                                   device=dev) * 1.5 + 0.5
            for mode_gear, mode_gains in ((gear, None), (None, gains),
                                          (gear, gains)):
                cs = costas_init((c,), gear=mode_gear is not None, device=dev)
                for i in range(2):
                    gi = None if mode_gains is None else \
                        mode_gains[i * nframes:(i + 1) * nframes].contiguous()
                    _, p = check_costas(cs, zr[i * t:(i + 1) * t].contiguous(),
                                        zi[i * t:(i + 1) * t].contiguous(),
                                        params, nsym, exact,
                                        f"C={c:5d} {kind} call {i}", errs,
                                        gear=mode_gear, gains=gi)
                    cs = p[0]

        # the gear and gains modes at a chain length that is not a
        # multiple of 16, with 8 gain rows
        (t_odd, every), g3 = ODD_T, torch.Generator(device=dev).manual_seed(c + 6)
        zo = [torch.randn((t_odd, c), generator=g3, device=dev) for _ in range(2)]
        go = torch.rand((t_odd // every, c), generator=g3, device=dev) * 1.5 + 0.5
        for mode_gear, mode_gains in ((gear, None), (None, go), (gear, go)):
            check_costas(costas_init((c,), gear=mode_gear is not None, device=dev),
                         zo[0], zo[1], params, every, True,
                         f"C={c:5d} noise T={t_odd}", errs, gear=mode_gear,
                         gains=mode_gains)


def option_loopback(name: str, pcfg, dev, errs: dict) -> dict:
    """Phase 6b: one option path at full width through the kernels, with
    every launch counter reset before; then each kernel and the plain path
    on the same inputs, and the decodes of 64 sampled channels.  Returns
    {kernel or mode: launches} of the kernels new on this path."""
    import torch
    from qpsk_tpu_torch import rx_init, rx_stream

    _, snr_db, paths, level_db, nframes = OPTION_PATHS[name]
    cfg, c = option_cfg(name), MAIN_PATH[0]
    reset_launches()
    t0 = time.perf_counter()
    payload, chan, clean, pcm = loopback_pcm(
        cfg, pcfg, c, nframes, seed=2026, dev=dev, snr_db=snr_db, paths=paths,
        level_db=level_db)
    _, out = rx_stream(cfg, rx_init(cfg, (c,), device=dev), pcm)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # each mode the config runs, by the C entry that runs it: the TX and
    # the front-end pipeline, the Costas loop with this config's gear or
    # gains
    n = _lib.launches
    tx, fe, costas = n["qpsk_tx"], n["qpsk_frontend_pipe"], n["qpsk_costas_tm"]
    on_path = {
        "level": {"tx": tx, "frontend_tm_power": fe, "costas_gear": costas,
                  "costas_gains": costas},
        "multipath": {"tx": tx, "frontend_cm": fe, "costas": costas},
        "1200": {"tx_1200": tx, "frontend_cm_1200": fe,
                 "costas": costas}}[name]
    print(f"  {name}: {c} channels x {nframes} frames, TX -> "
          f"{'multipath -> ' if paths else ''}AWGN {snr_db} dB"
          f"{f' -> {level_db} dB level' if level_db else ''} -> RX in "
          f"{seconds:.3f} s (host clock, first call); launches {on_path}")
    for kernel, n in on_path.items():
        need(n > 0, f"the {name} path never launched {kernel}")
    need(bool(torch.isfinite(out.symbols.re).all()
              and torch.isfinite(out.symbols.im).all()), "non-finite symbols")
    need(tuple(out.bits.shape) == (c, nframes, 2 * cfg.symbols_per_frame),
         f"bits of shape {tuple(out.bits.shape)}")

    _, plain_bits, flips = check_path(
        cfg, chan, clean, pcm, out, dev, f"C={c} {name}", errs,
        tx_key="tx_1200" if cfg.cycles == 8 else "tx",
        fe_key="frontend_cm_1200" if cfg.cycles == 8 else "frontend_cm")
    npk, nok, _ = compare_decodes(pcfg, out, plain_bits, flips, payload, name)
    # a loose floor: the JAX package records PER 0 at these points for
    # the equalizer (14 dB) and 1200 baud (8 dB)
    need(nok >= 0.9 * npk, f"only {nok} of {npk} packets pass CRC ({name})")
    return {k: v for k, v in on_path.items() if k not in ("tx", "costas")}


def option_rates(dev, errs: dict) -> dict:
    """Phase 6c: RX samples/s of each option path at 8192 channels x 8
    frames, kernel and plain; then each new kernel or mode against its
    plain version there and {name: (kernel ms, plain ms, bound ms,
    bound by)}."""
    import torch
    from qpsk_tpu_torch import ModemConfig, rx_init, tx_init
    from qpsk_tpu_torch.ops.costas import costas_init, costas_params, gear_for
    from qpsk_tpu_torch.ops.cplx import CF32
    from qpsk_tpu_torch.ops.modmap import bits_to_symbols

    from qpsk_tpu_torch.ops.cuda import costas_kernel as ck
    from qpsk_tpu_torch.ops.cuda import frontend_kernel as fk
    from qpsk_tpu_torch.ops.cuda import tx_kernel as tk

    (c, nframes), iters = RATE_POINT, 20
    nsamples = c * nframes * 512
    for name in OPTION_PATHS:
        cfg = option_cfg(name)
        pcm = noise_pcm(cfg, c, nframes, 7, dev)
        k = cuda_time_ms(rx_step(cfg, dev, pcm, "kernel")[0], iters)
        p = cuda_time_ms(rx_step(cfg, dev, pcm, "plain")[0], 2, warmup=1)
        print(f"  rx_stream {name:9s}: kernel path {k:.4f} ms/call, "
              f"{nsamples / k * 1e3:.6g} samples/s; plain path {p:.4f} "
              f"ms/call, {nsamples / p * 1e3:.6g} samples/s")

    level, c1200, base = option_cfg("level"), option_cfg("1200"), ModemConfig()
    nsym = level.symbols_per_frame
    label = f"C={c} F={nframes} noise"
    pcm4, pcm8 = noise_pcm(level, c, nframes, 7, dev), noise_pcm(c1200, c, nframes, 7, dev)
    st = rx_init(level, (c,), device=dev)
    kf, _ = check_frontend(level, pcm4, st, False, label, errs)
    check_frontend_cm(base, pcm4, st, False, label, errs, "frontend_cm")
    check_frontend_cm(c1200, pcm8, st, False, label, errs, "frontend_cm_1200")
    params = costas_params(level.loop_bw, level.damping, level.min_freq,
                           level.max_freq)
    gear = gear_for(level.loop_bw_track, level.damping)
    gen = torch.Generator(device=dev).manual_seed(19)
    gains = torch.rand((nframes, c), generator=gen, device=dev) * 1.5 + 0.5
    cs_gear, cs = costas_init((c,), gear=True, device=dev), costas_init((c,), device=dev)
    check_costas(cs_gear, kf[0], kf[1], params, nsym, False, label, errs, gear=gear)
    check_costas(cs, kf[0], kf[1], params, nsym, False, label, errs, gains=gains)
    s8 = nframes * c1200.symbols_per_frame
    sym8 = bits_to_symbols(torch.randint(0, 2, (c, 2 * s8), generator=gen,
                                         device=dev, dtype=torch.int32))
    sym8 = CF32(sym8.re.contiguous(), sym8.im.contiguous())
    ts8 = tx_init(c1200, (c,), device=dev)
    check_tx(c1200, sym8, ts8, f"C={c} S={s8}", errs, key="tx_1200", lsb=1)

    t = nframes * nsym
    return {name: time_pair(name, kern, plain, args, kw, n, iters) + work
            for name, kern, plain, args, kw, n, work in (
                ("frontend_tm_power", fk.rx_frontend_tm, fk.rx_frontend_tm_plain,
                 (level, pcm4, st.nco_phase, st.fir_tail, st.decim_delay),
                 {}, iters,
                 frontend_work(c, nframes, 4, True, True)),
                ("frontend_cm", fk.rx_frontend, fk.frontend_xla,
                 (base, pcm4, st.nco_phase, st.fir_tail), {}, iters,
                 frontend_work(c, nframes, 4, False, False)),
                ("frontend_cm_1200", fk.rx_frontend, fk.frontend_xla,
                 (c1200, pcm8, st.nco_phase, st.fir_tail), {}, iters,
                 frontend_work(c, nframes, 8, False, False)),
                ("costas_gear", ck.costas_run_tm, ck.costas_run_tm_plain,
                 (cs_gear, kf[0], kf[1], params, nsym), dict(gear=gear), 3,
                 costas_work(c, t, nsym, gear=True)),
                ("costas_gains", ck.costas_run_tm, ck.costas_run_tm_plain,
                 (cs, kf[0], kf[1], params, nsym), dict(gains=gains), 3,
                 costas_work(c, t, nsym, gains=True)),
                ("tx_1200", tk.tx_modulate, tk.tx_modulate_plain,
                 (c1200, sym8, ts8.nco_phase, ts8.fir_tail, TX_OFFSET_HZ), {},
                 iters, tx_work(c, s8, 8)))}


def family_cfg(name: str):
    """The ModemConfig of a phase-7 path."""
    from qpsk_tpu_torch import ModemConfig
    return ModemConfig(**FAMILY_PATHS[name][0])


def acquired_state(cfg, pcm, dev):
    """``rx_init`` warm-started at ``rx_acquire_hz`` of ``pcm``, and the
    estimates (Hz): the generic family's receive recipe."""
    from qpsk_tpu_torch import rx_init
    from qpsk_tpu_torch.modem import rx_acquire_hz
    from qpsk_tpu_torch.ops.acquire import hz_to_costas_freq

    hz = rx_acquire_hz(cfg, pcm)
    return rx_init(cfg, (pcm.shape[0],), acq_freq=hz_to_costas_freq(hz, cfg.rs),
                   device=dev), hz


def compare_family(pcfg, dev, errs: dict) -> None:
    """Phase 7a: the Costas kernel's dd mode against its plain version for
    each kind, at each channel count, in two chained calls of the rate
    point's length, on a loopback stimulus (the plain front-end's picks of
    the kind's link at its SNR, the loop warm-started by acquisition; with
    gains, the AGC gains of the front-end's powers) and on noise (Gaussian
    symbols at the chain's level; gains in [0.5, 2)), without and with
    gains: bit-identical, labels included."""
    import torch
    from qpsk_tpu_torch.ops.agc import agc_gains, agc_init
    from qpsk_tpu_torch.ops.costas import costas_init, costas_params
    from qpsk_tpu_torch.ops.cuda import frontend_kernel as fk

    nframes = RATE_POINT[1]
    for name in FAMILY_PATHS:
        cfg = family_cfg(name)
        cfg_pow = family_cfg("16qam")          # the front-end's power output
        nsym = cfg.symbols_per_frame
        t = nframes * nsym
        params = costas_params(cfg.loop_bw, cfg.damping, cfg.min_freq,
                               cfg.max_freq)
        dd = (name, cfg.agc_target)
        for c in COMPARE_CHANNELS:
            pcm = loopback_pcm(cfg, pcfg, c, 2 * nframes, seed=c + 30, dev=dev,
                               snr_db=FAMILY_PATHS[name][1])[3]
            st, _ = acquired_state(cfg, pcm, dev)
            cs_lb, zs = st.costas, []
            for i in range(2):
                x = pcm[:, i * nframes:(i + 1) * nframes].contiguous()
                p = fk.rx_frontend_tm_plain(cfg_pow, x, st.nco_phase,
                                            st.fir_tail, st.decim_delay)
                zs.append(p)
                st = st._replace(nco_phase=p[3], fir_tail=p[4], decim_delay=p[5])
            lb = ((torch.cat([p[0] for p in zs]), torch.cat([p[1] for p in zs])),
                  agc_gains(agc_init((c,), dev),
                            torch.cat([p[6] for p in zs], dim=1),
                            cfg.agc_target, cfg.agc_mu)[1].T.contiguous(),
                  cs_lb)
            g2 = torch.Generator(device=dev).manual_seed(c + 3)
            noise = (tuple(torch.randn((2 * t, c), generator=g2, device=dev)
                           * cfg.agc_target for _ in range(2)),
                     torch.rand((2 * nframes, c), generator=g2, device=dev)
                     * 1.5 + 0.5, costas_init((c,), device=dev))
            for kind, ((zr, zi), gains, cs0) in (("loopback", lb),
                                                 ("noise", noise)):
                for use_gains in (False, True):
                    cs = cs0
                    for i in range(2):
                        gi = gains[i * nframes:(i + 1) * nframes].contiguous() \
                            if use_gains else None
                        _, p = check_costas(
                            cs, zr[i * t:(i + 1) * t].contiguous(),
                            zi[i * t:(i + 1) * t].contiguous(), params, nsym,
                            True, f"C={c:5d} {kind}{' gains' if use_gains else ''}"
                            f" call {i}", errs, gains=gi, dd=dd)
                        cs = p[0]
            # a chain length that is not a multiple of 8, with 8 gain rows
            (t_odd, every), g3 = ODD_T, torch.Generator(device=dev).manual_seed(c + 5)
            zo = [torch.randn((t_odd, c), generator=g3, device=dev)
                  * cfg.agc_target for _ in range(2)]
            go = torch.rand((t_odd // every, c), generator=g3, device=dev) * 1.5 + 0.5
            for gi in (None, go):
                check_costas(costas_init((c,), device=dev), zo[0], zo[1], params,
                             every, True, f"C={c:5d} noise T={t_odd}"
                             f"{' gains' if gi is not None else ''}", errs,
                             gains=gi, dd=dd)


def family_loopback(name: str, pcfg, dev, errs: dict) -> dict:
    """Phase 7b (and 7e for ``name="8psk_1200"``, the composed chain): one
    generic-family loopback at full width through the kernels, acquisition
    on the card, with every launch counter reset before; then each kernel
    and the plain path on the same inputs, and the decodes of 64 sampled
    channels.  Returns {kernel or mode: launches} of the dd mode."""
    import torch
    from qpsk_tpu_torch import ModemConfig, rx_stream
    from qpsk_tpu_torch.ops import modfam

    if name == "8psk_1200":
        fields, snr_db, nframes = FAMILY_1200
        cfg = ModemConfig(**fields)
    else:
        cfg, snr_db, nframes = family_cfg(name), FAMILY_PATHS[name][1], MAIN_PATH[1]
    kind, c = cfg.modulation, MAIN_PATH[0]
    slow = cfg.cycles == 8
    reset_launches()
    t0 = time.perf_counter()
    payload, chan, clean, pcm = loopback_pcm(cfg, pcfg, c, nframes, seed=2027,
                                             dev=dev, snr_db=snr_db)
    st0, hz = acquired_state(cfg, pcm, dev)
    _, out = rx_stream(cfg, st0, pcm)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    key = f"costas_dd_{kind}"
    if slow:
        fe_key = "frontend_cm_1200"
    else:
        fe_key = "frontend_tm_power" if cfg.agc else "frontend"
    # the dd mode of this modulation is the config's: the Costas entry's
    # launches are its launches
    n = _lib.launches
    on_path = {"tx_1200" if slow else "tx": n["qpsk_tx"],
               fe_key: n["qpsk_frontend_pipe"], key: n["qpsk_costas_tm"]}
    peak = int(clean.to(torch.int32).abs().max())
    print(f"  {name}: {c} channels x {nframes} frames, TX (largest |PCM| "
          f"{peak}) -> AWGN {snr_db} dB -> acquisition (mean {float(hz.mean()):.4f} "
          f"Hz, {float(hz.min()):.3f}..{float(hz.max()):.3f}) -> RX in "
          f"{seconds:.3f} s (host clock, first call); launches {on_path}")
    for kernel, n in on_path.items():
        need(n > 0, f"the {name} path never launched {kernel}")
    need(peak <= 32767, f"TX PCM reaches {peak}")
    need(bool(torch.isfinite(out.symbols.re).all()
              and torch.isfinite(out.symbols.im).all()), "non-finite symbols")
    need(tuple(out.bits.shape) == (c, nframes, cfg.bits_per_frame),
         f"bits of shape {tuple(out.bits.shape)}")
    mod = modfam.get(kind)
    evm = modfam.evm_mod(type(out.symbols)(*(p[:, nframes // 2:].reshape(c, -1)
                                             for p in out.symbols)), mod)
    _, plain_bits, flips = check_path(
        cfg, chan, clean, pcm, out, dev, f"C={c} {name}", errs, st0=st0,
        tx_key="tx_1200" if slow else "tx",
        fe_key=fe_key if slow else "frontend_cm")
    spur = spur_channels(cfg, pcm, hz, name) if slow else None
    npk, nok, _ = compare_decodes(pcfg, out, plain_bits, flips, payload, name,
                                  modulation=kind, spur=spur)
    print(f"  {name}: EVM past the first half {float(evm.mean()):.4f}")
    # the JAX package measured PER 0 at these points
    need(nok >= 0.9 * npk, f"only {nok} of {npk} packets pass CRC ({name})")
    return {} if slow else {key: on_path[key]}


def spur_channels(cfg, pcm, hz, name: str):
    """Phase 7e: the channels whose acquisition took a spur of the M-power
    spectrum (more than 20 Hz off the offset sent; for 8PSK a line rs/8
    below the carrier's, where the loop locks a constellation step away,
    and which the JAX package's runtime repairs by a candidate sweep that
    is not ported), held against the same estimator on CPU tensors (the
    version the tests hold against JAX) on the channels the card flags:
    at most 0.1 % of all channels may be flagged on the card and not on
    the CPU.  Returns the card's (C,) bool flags."""
    import torch
    from qpsk_tpu_torch.modem import rx_acquire_hz

    spur = ((hz - TX_OFFSET_HZ).abs() > 20.0).cpu()
    flagged, c = torch.nonzero(spur).flatten(), spur.numel()
    both = 0
    if flagged.numel():
        ref = rx_acquire_hz(cfg, pcm[flagged.to(pcm.device)].cpu())
        both = int(((ref - TX_OFFSET_HZ).abs() > 20.0).sum())
    extra = flagged.numel() - both
    print(f"  {name}: {flagged.numel()} of {c} channels acquired a spur on "
          f"the card; the estimator on CPU tensors flags {both} of them too")
    need(extra <= 0.001 * c, f"{name}: the card's acquisition took a spur on "
         f"{extra} channels where the CPU's did not")
    return spur


def geometry_path(name: str, pcfg, dev, errs: dict, fields=None,
                  link=None) -> dict:
    """Phase 7f (and 8b, with ``fields`` and ``link``): one widened
    geometry at 256 channels x 32 packets through the kernels (packets ->
    TX at +50 Hz -> AWGN 10 dB -> RX), every launch counter reset before
    and each kernel's read after; then, as in phase 3, each kernel against
    its plain version on the path's own inputs and the plain path on the
    same PCM, which must sync alike and pass the same packets (with
    ``link`` false, at a point where the JAX package passes no packet
    either, only sync and CRC agreement are held).  Returns the path's
    launches by kernel instance, as ``kernel_keys`` names them."""
    import torch
    from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream

    cfg = ModemConfig(**(fields or GEOMETRY_PATHS[name]))
    c, npk = GEOMETRY_SHAPE
    nframes = npk * pcfg.frame_bits // cfg.bits_per_frame
    reset_launches()
    payload, chan, clean, pcm = loopback_pcm(cfg, pcfg, c, nframes,
                                             seed=2030, dev=dev)
    _, out = rx_stream(cfg, rx_init(cfg, (c,), device=dev), pcm)
    torch.cuda.synchronize()
    counts = kernel_launches(("tx", "frontend", "costas"))
    entries = {e: n for e, n in _lib.launches.items() if n}
    print(f"  {name}: {c} channels x {nframes} frames of {cfg.frame_size} "
          f"samples, {cfg.cycles} samples per symbol, {cfg.ntaps} taps: "
          f"launches {counts}, by entry {entries}")
    for kernel, n in counts.items():
        need(n > 0, f"the {name} path never launched the {kernel} kernel")
    need(bool(torch.isfinite(out.symbols.re).all()
              and torch.isfinite(out.symbols.im).all()), "non-finite symbols")
    keys = kernel_keys(cfg)
    on_path = {keys["tx"]: counts["tx"], keys["frontend"]: counts["frontend"]}
    _, plain_bits, flips = check_path(
        cfg, chan, clean, pcm, out, dev, f"C={c} {name}", errs,
        tx_key=keys["tx"], fe_key=keys["frontend"], tm_key=keys["frontend"],
        pow_key=keys["frontend"])
    # 2 samples per symbol carries no link at 10 dB in either package (the
    # port's bits equal the JAX package's on the same PCM,
    # tests/test_torch_loopback.py): no lock, no packet to check
    compare_decodes(pcfg, out, plain_bits, flips, payload, name,
                    link=cfg.cycles > 2 if link is None else link)
    return on_path


def kernel_keys(cfg) -> dict:
    """The ``kernels`` line's names of the TX and front-end instances that
    ``rx_stream`` / ``tx_stream`` launch for ``cfg``: the tensor-core
    instances' ("tx", "tx_1200", "frontend", "frontend_tm_power",
    "frontend_cm", "frontend_cm_1200") or the general ones' ("tx_gen",
    "frontend_gen", "frontend_gen_power", "frontend_cm_gen")."""
    from qpsk_tpu_torch import modem
    from qpsk_tpu_torch.ops.cuda import frontend_kernel as fk
    from qpsk_tpu_torch.ops.cuda import tx_kernel as tk

    slow = cfg.cycles == 8
    tx = ("tx_1200" if slow else "tx") if tk._fast(cfg) else "tx_gen"
    tm = modem._rx_path(cfg)[0] is modem._rx_stream_tm
    if not fk._fast(cfg, tm and cfg.agc):
        fe = ("frontend_gen_power" if cfg.agc else "frontend_gen") if tm \
            else "frontend_cm_gen"
    elif tm:
        fe = "frontend_tm_power" if cfg.agc else "frontend"
    else:
        fe = "frontend_cm_1200" if slow else "frontend_cm"
    return {"tx": tx, "frontend": fe}


def tx_geometries(dev, errs: dict) -> None:
    """Phase 7f: the TX kernel against its plain version at 2 samples per
    symbol (1, 200 and 8192 channels, two chained calls; 4 and 8 are held
    in phases 2 and 6a), then one call of TX_LONG symbols a channel at 2,
    4 and 8, past 65 535 blocks of 128, against chained plain calls
    (pieces of at most 65 536 symbols, each a whole number of 128 but the
    first): PCM within 2 LSB, the carried phase within 1e-5, tail exact."""
    import torch
    from qpsk_tpu_torch import ModemConfig, tx_init
    from qpsk_tpu_torch.ops.cplx import CF32
    from qpsk_tpu_torch.ops.cuda import tx_kernel as tk
    from qpsk_tpu_torch.ops.modmap import bits_to_symbols

    fast = ModemConfig(rs=4800.0)
    t = RATE_POINT[1] * fast.symbols_per_frame
    for c in COMPARE_CHANNELS:
        gen = torch.Generator(device=dev).manual_seed(c + 31)
        sym = bits_to_symbols(torch.randint(0, 2, (c, 4 * t), generator=gen,
                                            device=dev, dtype=torch.int32))
        st = tx_init(fast, (c,), device=dev)
        for i in range(2):
            s = CF32(sym.re[:, i * t:(i + 1) * t].contiguous(),
                     sym.im[:, i * t:(i + 1) * t].contiguous())
            _, st = check_tx(fast, s, st, f"rs=4800 C={c:5d} call {i}", errs)

    c, n = TX_LONG
    gen = torch.Generator(device=dev).manual_seed(37)
    sym = bits_to_symbols(torch.randint(0, 2, (c, 2 * n), generator=gen,
                                        device=dev, dtype=torch.int32))
    sym = CF32(sym.re.contiguous(), sym.im.contiguous())
    first = n % 128 + 128 if n % 128 else 0
    bounds = [0] + ([first] if first else []) + list(
        range(first + 65536, n, 65536)) + [n]
    for rs in (4800.0, 2400.0, 1200.0):
        cfg = ModemConfig(rs=rs)
        st = tx_init(cfg, (c,), device=dev)
        pk, phk, tlk = tk.tx_modulate(cfg, sym, st.nco_phase, st.fir_tail,
                                      TX_OFFSET_HZ)
        worst = 0
        for a, b in zip(bounds[:-1], bounds[1:]):
            piece = CF32(sym.re[:, a:b].contiguous(), sym.im[:, a:b].contiguous())
            pp, php, tlp = tk.tx_modulate_plain(cfg, piece, st.nco_phase,
                                                st.fir_tail, TX_OFFSET_HZ)
            worst = max(worst, int((pk[:, a * cfg.cycles:b * cfg.cycles]
                                    .to(torch.int32) - pp.to(torch.int32))
                                   .abs().max()))
            st = st._replace(nco_phase=php, fir_tail=tlp)
        ph_err = cmax_abs(phk, st.nco_phase)
        tail_err = cmax_abs(tlk, st.fir_tail)
        print(f"  tx {cfg.cycles} samples per symbol, {c} channels x {n} "
              f"symbols ({-(-n // 128)} blocks of 128) in one call: PCM within "
              f"{worst} LSB of {len(bounds) - 1} chained plain calls, phase "
              f"{ph_err:.3g}, tail {tail_err:.3g}")
        need(worst <= 2, f"TX long call: PCM differs by {worst} LSB")
        need(ph_err <= 1e-5, f"TX long call: phase differs by {ph_err}")
        need(tail_err == 0, "TX long call: the tail differs")
        errs["tx_1200" if cfg.cycles == 8 else "tx"] = max(
            errs["tx_1200" if cfg.cycles == 8 else "tx"], worst)
        del pk


def off_geometry_call(pcfg, dev) -> None:
    """Phase 7f: ``tx_stream`` and ``rx_stream`` on the card at a geometry
    past the TX and front-end kernels' coverage (131 taps): each must raise
    ``NotImplementedError`` naming the field before any kernel launches
    (CPU tensors run it)."""
    import torch
    from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream, tx_init, tx_stream

    fields, (c, nframes) = OFF_GEOMETRY
    cfg = ModemConfig(**fields)
    reset_launches()
    bits = torch.zeros((c, nframes, cfg.bits_per_frame), dtype=torch.int32,
                       device=dev)
    pcm = torch.zeros((c, nframes, cfg.frame_size), dtype=torch.int16,
                      device=dev)
    for what, call in (
            ("tx_stream", lambda: tx_stream(cfg, tx_init(cfg, (c,), device=dev),
                                            bits, TX_OFFSET_HZ)),
            ("rx_stream", lambda: rx_stream(cfg, rx_init(cfg, (c,), device=dev),
                                            pcm))):
        try:
            call()
        except NotImplementedError as err:
            need(f"ntaps={cfg.ntaps}" in str(err),
                 f"{what} at ntaps={cfg.ntaps} raised {err!r}")
            print(f"  {what} at ntaps={cfg.ntaps} on the card: "
                  f"NotImplementedError ({err})")
        else:
            need(False, f"{what} at ntaps={cfg.ntaps} ran on the card")
    launched = kernel_launches()
    need(not any(launched.values()),
         f"the off-geometry calls launched kernels: {launched}")


def family_coded(kind: str, dev, errs: dict) -> int:
    """Phase 7c: the coded 8PSK loopback (1024 channels x 48 packets,
    re-framed into modem frames with filler, AWGN at 13 dB, acquisition)
    through the kernels; on 64 sampled channels the score matrix, every
    rotation's LLR stream, the soft hunt over every lag (8 probes) and the
    tracked soft extractor (``cli.py``).  Then each modem kernel and the
    plain modem path on the same PCM, whose scores, decoded by the same
    kernel decoder, must sync alike and pass the same packets (verdicts
    may differ on <= 0.1 % of packets, each printed).  Returns the
    decoder kernel's launches."""
    import torch
    from qpsk_tpu_torch import ModemConfig, rx_stream, tx_init, tx_stream
    from qpsk_tpu_torch.channel import awgn_pcm
    from qpsk_tpu_torch.ops import modfam
    from qpsk_tpu_torch.ops.cplx import CF32
    from qpsk_tpu_torch.packet import PacketConfig, assemble_packet
    from qpsk_tpu_torch.sync import (default_max_lag,
                                     extract_packets_soft_tracked_mod,
                                     find_sync_streams, rotated_streams)

    cfg = ModemConfig(modulation="8psk")
    mod = modfam.get("8psk")
    pcfg = PacketConfig(payload_bytes=30, fec=kind)
    (c, npkt), fb, mfb = CODED_PATH, pcfg.frame_bits, cfg.bits_per_frame
    skip = 8 * fb - (8 * fb) % mod.bps           # cli.py:167-174
    channels = sorted({round(i * (c - 1) / 63) for i in range(64)})
    decoder = "viterbi" if kind == "conv" else "ldpc"

    def scores_of(sym):
        return modfam.symbol_scores(CF32(sym.re.reshape(c, -1),
                                         sym.im.reshape(c, -1)), mod,
                                    cfg.agc_target)[:, skip // mod.bps:]

    def decode(scores):
        rows = rotated_streams(None, "8psk", soft=scores)
        sync = find_sync_streams(pcfg, rows, max_lag=default_max_lag(pcfg),
                                 probe_frames=8, soft=True, lag_step=1)
        navail = (rows.shape[1] - int(sync.bit_lag)) // fb
        return sync, extract_packets_soft_tracked_mod(pcfg, scores, sync,
                                                      navail, "8psk")

    reset_launches()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(2028)
    payload = torch.randint(0, 2, (c, npkt, 8 * pcfg.payload_bytes),
                            generator=gen, device=dev, dtype=torch.int32)
    chan = assemble_packet(pcfg, payload).reshape(c, -1)
    nframes = -(-chan.shape[1] // mfb)
    filler = torch.randint(0, 2, (c, nframes * mfb - chan.shape[1]),
                           generator=gen, device=dev, dtype=torch.int32)
    frames = torch.cat([chan, filler], dim=1).reshape(c, nframes, mfb)
    _, clean = tx_stream(cfg, tx_init(cfg, (c,), device=dev), frames,
                         tx_offset_hz=TX_OFFSET_HZ)
    power = float(((clean.to(torch.float32) / cfg.pcm_scale) ** 2).mean())
    pcm = awgn_pcm(gen, clean, FAMILY_CODED_SNR_DB, power, cfg.pcm_scale)
    st0, hz = acquired_state(cfg, pcm, dev)
    _, out = rx_stream(cfg, st0, pcm)
    scores = scores_of(out.symbols)
    results = [decode(scores[ch]) for ch in channels]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n = _lib.launches
    counts = {"tx": n["qpsk_tx"], "frontend": n["qpsk_frontend_pipe"],
              "costas_dd_8psk": n["qpsk_costas_tm"],
              decoder: kernel_launches((decoder,))[decoder]}
    print(f"  8psk fec={kind}: {c} channels x {npkt} packets = {nframes} "
          f"frames, TX -> AWGN {FAMILY_CODED_SNR_DB} dB -> acquisition -> RX "
          f"-> scores -> soft hunt and tracked extraction on {len(channels)} "
          f"channels in {seconds:.3f} s (host clock, first call); launches "
          f"{counts}")
    for name, n in counts.items():
        need(n > 0, f"the coded 8psk {kind} path never launched {name}")
    need(bool(torch.isfinite(scores).all()), "non-finite scores")

    plain_sym, _, _ = check_path(cfg, frames, clean, pcm, out, dev,
                                 f"C={c} 8psk fec={kind}", errs, st0=st0)
    plain_scores = scores_of(plain_sym)
    print(f"  8psk fec={kind}: plain path scores max diff "
          f"{max_abs(plain_scores, scores):.3g} from the kernel path's")
    plain = [decode(plain_scores[ch]) for ch in channels]
    synced = nok = npk = 0
    diffs = []
    for ch, (ks, krx), (ps, prx) in zip(channels, results, plain):
        need((int(ks.rotation), int(ks.bit_lag)) == (int(ps.rotation), int(ps.bit_lag)),
             f"channel {ch}: the kernel and plain paths sync differently")
        for i in torch.nonzero(krx.crc_ok != prx.crc_ok).flatten().tolist():
            print(f"    channel {ch} packet {i}: CRC {bool(krx.crc_ok[i])}, "
                  f"plain path {bool(prx.crc_ok[i])}")
            diffs.append((ch, i))
        nok += check_payloads(krx, payload[ch], ch)
        check_payloads(prx, payload[ch], ch)
        synced += int(ks.score) > 0
        npk += krx.crc_ok.numel()
    need(len(diffs) <= 0.001 * npk, f"the kernel and plain paths differ on "
         f"{len(diffs)} of {npk} packets")
    print(f"  8psk fec={kind}: {synced}/{len(channels)} channels synced, "
          f"{nok}/{npk} packets pass CRC (PER {1 - nok / max(npk, 1):.5f}), "
          f"all bit-exact; the plain path syncs alike, {len(diffs)} CRC "
          f"verdicts differ; acquisition mean {float(hz.mean()):.4f} Hz")
    need(nok >= 0.9 * npk, f"only {nok} of {npk} coded 8psk packets pass CRC")
    return counts[decoder]


def family_rates(dev, errs: dict) -> dict:
    """Phase 7d: RX samples/s of each family configuration at 8192
    channels x 8 frames, kernel and plain path; then each dd kind's kernel
    against its plain version there (16QAM with gains, as on its path)
    and {name: (kernel ms, plain ms, bound ms, bound by)}."""
    import torch
    from qpsk_tpu_torch import rx_init
    from qpsk_tpu_torch.ops.costas import costas_init, costas_params
    from qpsk_tpu_torch.ops.cuda import costas_kernel as ck
    from qpsk_tpu_torch.ops.cuda import frontend_kernel as fk

    (c, nframes), iters = RATE_POINT, 20
    nsamples = c * nframes * 512
    times = {}
    gen = torch.Generator(device=dev).manual_seed(23)
    for name in FAMILY_PATHS:
        cfg = family_cfg(name)
        pcm = noise_pcm(cfg, c, nframes, 7, dev)
        k = cuda_time_ms(rx_step(cfg, dev, pcm, "kernel")[0], iters)
        p = cuda_time_ms(rx_step(cfg, dev, pcm, "plain")[0], 2, warmup=1)
        print(f"  rx_stream {name:6s}: kernel path {k:.4f} ms/call, "
              f"{nsamples / k * 1e3:.6g} samples/s; plain path {p:.4f} "
              f"ms/call, {nsamples / p * 1e3:.6g} samples/s")
        st = rx_init(cfg, (c,), device=dev)
        kf = fk.rx_frontend_tm(cfg, pcm, st.nco_phase, st.fir_tail,
                               st.decim_delay)
        nsym = cfg.symbols_per_frame
        params = costas_params(cfg.loop_bw, cfg.damping, cfg.min_freq,
                               cfg.max_freq)
        gains = (torch.rand((nframes, c), generator=gen, device=dev) * 1.5
                 + 0.5) if cfg.agc else None
        kw = dict(gains=gains, dd=(name, cfg.agc_target))
        args = (costas_init((c,), device=dev), kf[0], kf[1], params, nsym)
        check_costas(*args, True, f"C={c} F={nframes} noise", errs, **kw)
        key = f"costas_dd_{name}"
        times[key] = time_pair(key, ck.costas_run_tm, ck.costas_run_tm_plain,
                               args, kw, 3, iters) \
            + costas_work(c, nframes * nsym, nsym, gains=cfg.agc, dd=name)
    return times


def traced(step, steps: int) -> tuple:
    """``steps`` calls of ``step`` under ``torch.profiler`` after 3
    warm-up calls: (device operations [(start, end, name)], HtoD copies,
    host synchronisations beyond the window's own, host wall us)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace
    from fec_times import host_waits

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    ops = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == DeviceType.CUDA)
    need(ops, "the profiler saw no device operation")
    htod = sum("HtoD" in name for _, _, name in ops)
    # the host's waits, less those of a window that only synchronises
    return ops, htod, host_waits(events) - host_waits(None), wall_us


def report_trace(label: str, ops, htod, syncs, wall_us, steps: int) -> None:
    """One line per traced call: operations, busy time against the wall,
    copies, waits and the operations that take the most device time."""
    busy, reach, by_name = 0.0, ops[0][0], {}
    for start, end, name in ops:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        by_name[name] = by_name.get(name, 0.0) + end - start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"  {label}: {len(ops) / steps:.1f} "
          f"device ops per call, device busy {busy / steps / 1e3:.4f} ms of "
          f"{wall_us / steps / 1e3:.4f} ms wall per call (idle share "
          f"{1 - busy / wall_us:.3f}); {htod / steps:g} HtoD copies and "
          f"{syncs / steps:g} synchronisations per call; most device time: "
          + "; ".join(f"{n[:48]} {t / steps / 1e3:.4f} ms" for n, t in top))


def profile(cfg, dev, steps: int = 5) -> None:
    """``--profile``: a ``torch.profiler`` trace of ``steps`` kernel-path
    receive calls after 3 warm-up calls, uncoded at the rate point, coded
    at the composed coded point and each phase-6, phase-7 and phase-9
    configuration at the rate point (parity's frame scan a frame at
    PARITY_RATE's channel count): per call, the device operations
    launched, the device's busy time (the union of their intervals) beside
    the host's wall time under the profiler, and the operations that take
    the most device time.  Then the same for one ``tx_modulate`` call
    (which must be one kernel launch, no other device operation, no copy
    to the card and no wait) and one ``tx_stream`` call at the rate
    point."""
    import torch
    from qpsk_tpu_torch import (ModemConfig, config_parity, rx_init, rx_stream,
                                tx_init, tx_stream)
    from qpsk_tpu_torch.ops.cuda import tx_kernel as tk

    for label, rcfg, kind, (c, nframes) in (
            ("uncoded", cfg, None, RATE_POINT),
            ("conv", cfg, "conv", CODED_RATE_POINT),
            ("ldpc", cfg, "ldpc", CODED_RATE_POINT),
            *((name, option_cfg(name), None, RATE_POINT)
              for name in OPTION_PATHS),
            *((name, family_cfg(name), None, RATE_POINT)
              for name in FAMILY_PATHS)):
        step, _ = rx_step(rcfg, dev, noise_pcm(rcfg, c, nframes, 13, dev),
                          "kernel", kind)
        ops, htod, syncs, wall_us = traced(step, steps)
        report_trace(f"{label} RX at {c} x {nframes}", ops, htod, syncs,
                     wall_us, steps)
        if label == "uncoded":
            need(htod == 0 and syncs <= 0, "the default receive call copies to "
                 "the card or waits for it")

    c, nframes = RATE_POINT
    gen = torch.Generator(device=dev).manual_seed(41)
    bits = torch.randint(0, 2, (c, nframes, cfg.bits_per_frame), generator=gen,
                         device=dev, dtype=torch.int32)
    sym = tx_symbols(cfg, bits.reshape(c, -1))
    st = [tx_init(cfg, (c,), device=dev)]

    def modulate():
        tk.tx_modulate(cfg, sym, st[0].nco_phase, st[0].fir_tail, TX_OFFSET_HZ)

    def stream():
        st[0], _ = tx_stream(cfg, st[0], bits, TX_OFFSET_HZ)
    for label, step in (("tx_modulate", modulate), ("tx_stream", stream)):
        ops, htod, syncs, wall_us = traced(step, steps)
        report_trace(f"{label} at {c} x {nframes}", ops, htod, syncs, wall_us,
                     steps)
        if label == "tx_modulate":
            need(len(ops) == steps and all("tx_kernel" in n for *_, n in ops)
                 and htod == 0 and syncs <= 0,
                 "a tx_modulate call is not one kernel launch alone")

    # last, after the one-launch check above: the phase-9 configurations,
    # whose traces of thousands of operations a call made the next trace
    # miss a launch (seen twice on the H100 with these traces before it)
    for name in MODE_PATHS:
        mcfg = ModemConfig(**MODE_PATHS[name][0])
        step, _ = rx_step(mcfg, dev, noise_pcm(mcfg, c, nframes, 13, dev),
                          "kernel")
        ops, htod, syncs, wall_us = traced(step, steps)
        report_trace(f"{name} RX at {c} x {nframes}", ops, htod, syncs,
                     wall_us, steps)
    parity, c = config_parity(), PARITY_RATE[0]
    pcm, pst = noise_pcm(parity, c, 1, 13, dev), [rx_init(parity, (c,), device=dev)]

    def scan():
        pst[0], _ = rx_stream(parity, pst[0], pcm)
    ops, htod, syncs, wall_us = traced(scan, 2)
    report_trace(f"parity RX at {c} x 1", ops, htod, syncs, wall_us, 2)


def lowering_switches(pcfg, dev) -> None:
    """Phase 8a: the lowering switches on the card.  With every ``*_impl``
    "pallas", ``rx_stream`` and ``tx_stream`` launch the front-end, Costas
    and TX kernels (their counters move) and equal "auto"; with
    ``costas_impl="scan"`` and ``frontend_impl`` / ``tx_impl`` "xla" no
    counter moves and the outputs equal the plain wrappers'; the decoders'
    ``impl`` likewise; "pallas" on a CPU tensor raises."""
    import torch
    from qpsk_tpu_torch import ModemConfig, modem, rx_init, rx_stream, tx_init
    from qpsk_tpu_torch import tx_stream
    from qpsk_tpu_torch.ops.cuda import costas_kernel as ck
    from qpsk_tpu_torch.ops.cuda import frontend_kernel as fk
    from qpsk_tpu_torch.ops.cuda import tx_kernel as tk
    from qpsk_tpu_torch.packet import ConvCode, LdpcCode
    from qpsk_tpu_torch.packet.fec import viterbi_decode
    from qpsk_tpu_torch.packet.ldpc import ldpc_decode

    c, nframes = 64, 8
    base = ModemConfig()
    _, chan, clean, pcm = loopback_pcm(base, pcfg, c, nframes, seed=2040,
                                       dev=dev)
    pallas = dataclasses.replace(base, costas_impl="pallas",
                                 frontend_impl="pallas", tx_impl="pallas")
    plain = dataclasses.replace(base, costas_impl="scan", frontend_impl="xla",
                                tx_impl="xla")
    st0, ts0 = rx_init(base, (c,), device=dev), tx_init(base, (c,), device=dev)
    _, auto_out = rx_stream(base, st0, pcm)
    for cfg, moved in ((pallas, True), (plain, False)):
        reset_launches()
        _, out = rx_stream(cfg, st0, pcm)
        _, txp = tx_stream(cfg, ts0, chan, TX_OFFSET_HZ)
        torch.cuda.synchronize()
        launched = kernel_launches(("frontend", "costas", "tx"))
        need(all(launched.values()) if moved else not any(launched.values()),
             f"{cfg.costas_impl}/{cfg.frontend_impl}/{cfg.tx_impl}: launches "
             f"{launched}")
        if moved:
            same = (torch.equal(out.bits, auto_out.bits)
                    and torch.equal(txp, clean))
        else:
            zr, zi = fk.rx_frontend_tm_plain(base, pcm, st0.nco_phase,
                                             st0.fir_tail, st0.decim_delay)[:2]
            params, gear, dd = modem._loop(base)
            _, derot, _, bits = ck.costas_run_tm_plain(
                st0.costas, zr, zi, params, base.symbols_per_frame, gear=gear,
                dd=dd)
            sym = tx_symbols(base, chan.reshape(c, -1))
            pp, _, _ = tk.tx_modulate_plain(base, sym, ts0.nco_phase,
                                            ts0.fir_tail, TX_OFFSET_HZ)
            same = (torch.equal(out.bits.reshape(c, -1), bits)
                    and torch.equal(out.symbols.re.reshape(c, -1),
                                    derot.re.T)
                    and torch.equal(txp.reshape(c, -1), pp))
        need(same, f"{cfg.costas_impl}/{cfg.frontend_impl}/{cfg.tx_impl}: "
             "outputs differ")
        print(f"  costas_impl={cfg.costas_impl} frontend_impl="
              f"{cfg.frontend_impl} tx_impl={cfg.tx_impl}: launches "
              f"{launched}, outputs equal to the "
              f"{'kernel path' if moved else 'plain wrappers'}")
    gen = torch.Generator(device=dev).manual_seed(2041)
    llrs = torch.randn((64, 2 * 262), generator=gen, device=dev)
    ll = torch.randn((64, 512), generator=gen, device=dev)
    reset_launches()
    v = viterbi_decode(ConvCode(), llrs, 256, impl="scan")
    lq = ldpc_decode(LdpcCode(256), ll, impl="xla")
    need(not any(kernel_launches(("viterbi", "ldpc")).values()),
         "a decoder's plain impl launched its kernel")
    need(torch.equal(v, viterbi_decode(ConvCode(), llrs, 256))
         and float((lq == ldpc_decode(LdpcCode(256), ll)).float().mean())
         >= 0.999, "a decoder's plain impl differs from its kernel")
    for what, call in (
            ("costas_impl", lambda: rx_stream(
                dataclasses.replace(base, costas_impl="pallas"),
                rx_init(base, (1,), device="cpu"), pcm[:1].cpu())),
            ("tx_impl", lambda: tx_stream(
                pallas, tx_init(base, (1,), device="cpu"), chan[:1].cpu()))):
        try:
            call()
        except RuntimeError as err:
            need(what in str(err), f"{what}='pallas' on the CPU raised {err!r}")
        else:
            need(False, f"{what}='pallas' ran on CPU tensors")
    print("  viterbi impl=scan, ldpc impl=xla: no launch, equal to the "
          "kernels; 'pallas' on CPU tensors raises")


def fec8_batches(name: str, code) -> tuple:
    """The batches phase 8b decodes a general code at: ``FEC8_BATCHES``,
    but K = 15 (a block a packet) at the first two."""
    if name == "viterbi" and code.constraint >= 15:
        return FEC8_BATCHES[:2]
    return FEC8_BATCHES


def general_instances(pcfg, dev, errs: dict, counts: dict,
                      times: dict) -> None:
    """Phase 8b: the geometries and codes of the general instances on the
    card.  Loopbacks through the kernels (``GEOMETRY8_PATHS``), each kernel
    held against its plain version on the path's inputs and the plain
    path against the kernel path; TX at 16 samples per symbol, at 255
    taps and at 131 (``TX8``); the decoders' other codes against their
    plain versions (Viterbi bit-equal, LDPC >= 99.9 %), each alone in a
    CUDA graph beside its bound; each general instance's time at one
    shape beside its bound and float32-FMA floor; then calls past the
    coverage, which raise before any launch."""
    import torch
    from fec_times import graph_ms
    from qpsk_tpu_torch import ModemConfig, rx_init, tx_init
    from qpsk_tpu_torch.ops.cplx import CF32
    from qpsk_tpu_torch.ops.cuda import frontend_kernel as fk
    from qpsk_tpu_torch.ops.cuda import ldpc_kernel as lk
    from qpsk_tpu_torch.ops.cuda import tx_kernel as tk
    from qpsk_tpu_torch.ops.cuda import viterbi_kernel as vk
    from qpsk_tpu_torch.ops.modmap import bits_to_symbols
    from qpsk_tpu_torch.packet import (ConvCode, LdpcCode, conv_encode,
                                       hard_llrs, ldpc_encode)

    for name, (fields, link) in GEOMETRY8_PATHS.items():
        for key, n in geometry_path(name, pcfg, dev, errs, fields,
                                    link).items():
            if "gen" in key:
                counts[key] = counts.get(key, 0) + n
    for key in ("frontend_gen", "frontend_gen_power", "frontend_cm_gen",
                "tx_gen"):
        need(counts.get(key, 0) > 0, f"no phase-8b path launched {key}")
    for fields, (c, s) in TX8:
        cfg = ModemConfig(**fields)
        gen = torch.Generator(device=dev).manual_seed(c + s)
        sym = bits_to_symbols(torch.randint(0, 2, (c, 4 * s), generator=gen,
                                            device=dev, dtype=torch.int32))
        st = tx_init(cfg, (c,), device=dev)
        for i in range(2):
            piece = CF32(sym.re[:, i * s:(i + 1) * s].contiguous(),
                         sym.im[:, i * s:(i + 1) * s].contiguous())
            _, st = check_tx(cfg, piece, st, f"{fields} C={c} call {i}", errs,
                             key="tx_gen")

    reset_launches()
    codes = [("viterbi", ConvCode(k, polys)) for k, polys in VITERBI8] + \
        [("ldpc", LdpcCode(k, dv=dv)) for k, dv in LDPC8]
    ldpc_gen = 0
    for name, code in codes:
        nbits = 256
        ldpc_before = _lib.launches["qpsk_ldpc"]
        for b in fec8_batches(name, code):
            gen = torch.Generator(device=dev).manual_seed(b + code.k
                                                          if name == "ldpc"
                                                          else b)
            u = torch.randint(0, 2, (b, code.k if name == "ldpc" else nbits),
                              generator=gen, device=dev, dtype=torch.int32)
            cw = ldpc_encode(code, u) if name == "ldpc" else conv_encode(code, u)
            noisy = (1.0 - 2.0 * cw) + 0.7 * torch.randn(cw.shape, generator=gen,
                                                         device=dev)
            hard = hard_llrs(cw ^ (torch.rand(cw.shape, generator=gen,
                                              device=dev) < 0.03).to(torch.int32))
            for stim, llrs in (("sigma 0.7", noisy), ("hard 3 %", hard)):
                if name == "ldpc":
                    k, p = lk.ldpc_decode(code, llrs), lk.ldpc_decode_plain(code, llrs)
                else:
                    k = vk.viterbi_decode(code, llrs, nbits)
                    p = vk.viterbi_decode_plain(code, llrs, nbits)
                label = f"{code} B={b} {stim}"
                rate = agree(label, f"{name} bit", k == p, exact=name == "viterbi")
                ck_, cp = int((k == u).all(-1).sum()), int((p == u).all(-1).sum())
                need(ck_ == cp, f"{label}: {ck_} packets clean, plain {cp}")
                key = "ldpc" if name == "ldpc" and code.dv == 3 else f"{name}_gen"
                errs[key] = max(errs[key], 1.0 - rate)
            print(f"  {name}_gen {code} B={b:5d}: "
                  f"{'equal' if name == 'viterbi' else f'agreement {rate:.6f}'}"
                  f", {ck_}/{b} clean (plain {cp})")
        # a code's LDPC instance follows its dv: 3 the fast one, else general
        if name == "ldpc" and code.dv != 3:
            ldpc_gen += _lib.launches["qpsk_ldpc"] - ldpc_before
    n = _lib.launches
    counts["viterbi_gen"], counts["ldpc_gen"] = n["qpsk_viterbi_gen"], ldpc_gen
    need(counts["viterbi_gen"] > 0 and counts["ldpc_gen"] > 0,
         "the general decoder instances never launched")
    print(f"  decoder launches: viterbi {n['qpsk_viterbi']} (K=7), "
          f"{counts['viterbi_gen']} (general); ldpc "
          f"{n['qpsk_ldpc'] - ldpc_gen} (dv 3), {ldpc_gen} (general)")

    # every general decoder code alone in a CUDA graph beside its bound
    print("  the general decoder instances alone in a CUDA graph:")
    gen = torch.Generator(device=dev).manual_seed(83)
    for name, code in codes:
        if name == "ldpc" and code.dv == 3:
            continue
        b = fec8_batches(name, code)[-1]
        if name == "ldpc":
            x = torch.randn((b, code.n), generator=gen, device=dev)
            fn, work = (lambda: lk.ldpc_decode(code, x)), general_work(
                "ldpc", code=code, b=b)
        else:
            x = torch.randn((b, code.rate_den * (256 + code.constraint - 1)),
                            generator=gen, device=dev)
            fn, work = (lambda: vk.viterbi_decode(code, x, 256)), general_work(
                "viterbi", code=code, b=b, nbits=256)
        g1, g2 = graph_ms(fn), graph_ms(fn)
        print(f"  {name}_gen {code} B={b}: {g1:.4f} / {g2:.4f} ms, bound "
              f"{work[0]:.5f} ms ({work[1]}), {work[0] / min(g1, g2):.3f} "
              f"of it")

    # each general instance's time at one shape of its path, beside its
    # plain version's
    print("  times of the general instances:")
    c, nframes, iters = 256, 8, 20
    for key, fields, kind in (("frontend_gen", dict(frame_size=4096), "tm"),
                              ("frontend_gen_power",
                               dict(frame_size=1536, agc=True), "tm_power"),
                              ("frontend_cm_gen",
                               dict(rs=3200.0, frame_size=384), "cm")):
        cfg = ModemConfig(**fields)
        pcm = noise_pcm(cfg, c, nframes, 71, dev)
        st = rx_init(cfg, (c,), device=dev)
        if kind == "cm":
            check_frontend_cm(cfg, pcm, st, False, f"C={c} F={nframes} noise",
                              errs, key)
            args, kern, plain = ((cfg, pcm, st.nco_phase, st.fir_tail),
                                 fk.rx_frontend, fk.frontend_xla)
        else:
            check_frontend(cfg, pcm, st, False, f"C={c} F={nframes} noise",
                           errs, key, key)
            args, kern, plain = ((cfg, pcm, st.nco_phase, st.fir_tail,
                                  st.decim_delay), fk.rx_frontend_tm,
                                 fk.rx_frontend_tm_plain)
        times[key] = time_pair(key, kern, plain, args, {}, iters, iters) + \
            general_work(kind, cfg, c, nframes)
        print_bound(key, times[key])
    fields, (c, s) = TX8[0]
    cfg = ModemConfig(**fields)
    gen = torch.Generator(device=dev).manual_seed(73)
    sym = bits_to_symbols(torch.randint(0, 2, (c, 2 * s), generator=gen,
                                        device=dev, dtype=torch.int32))
    sym = CF32(sym.re.contiguous(), sym.im.contiguous())
    ts = tx_init(cfg, (c,), device=dev)
    times["tx_gen"] = time_pair(
        "tx_gen", tk.tx_modulate, tk.tx_modulate_plain,
        (cfg, sym, ts.nco_phase, ts.fir_tail, TX_OFFSET_HZ), {}, iters,
        iters) + general_work("tx", cfg, c, s=s)
    print_bound("tx_gen", times["tx_gen"])
    b = FEC8_BATCHES[-1]
    gen = torch.Generator(device=dev).manual_seed(79)
    code = ConvCode(*VITERBI8[1])
    llrs = torch.randn((b, code.rate_den * (256 + code.constraint - 1)),
                       generator=gen, device=dev)
    times["viterbi_gen"] = time_pair(
        f"viterbi_gen K={code.constraint}", lambda x: vk.viterbi_decode(code, x, 256),
        lambda x: vk.viterbi_decode_plain(code, x, 256), (llrs,), {}, 2,
        iters) + general_work("viterbi", code=code, b=b, nbits=256)
    code = LdpcCode(*LDPC8[1][:1], dv=LDPC8[1][1])
    ll = torch.randn((b, code.n), generator=gen, device=dev)
    times["ldpc_gen"] = time_pair(
        f"ldpc_gen dv={code.dv}", lambda x: lk.ldpc_decode(code, x),
        lambda x: lk.ldpc_decode_plain(code, x), (ll,), {}, 5, iters) + \
        general_work("ldpc", code=code, b=b)

    off_geometry_call(pcfg, dev)
    reset_launches()
    for what, field, call in (
            ("viterbi_decode", "constraint", lambda: vk.viterbi_decode(
                ConvCode(16, (0o100003, 0o170001)),
                torch.zeros((2, 2 * 23), device=dev), 8)),
            ("ldpc_decode", "dv", lambda: lk.ldpc_decode(
                LdpcCode(64, dv=9), torch.zeros((2, 128), device=dev)))):
        try:
            call()
        except NotImplementedError as err:
            need(field in str(err), f"{what} raised {err!r}")
            print(f"  {what} past the coverage on the card: "
                  f"NotImplementedError ({err})")
        else:
            need(False, f"{what} past the coverage ran on the card")
    launched = kernel_launches()
    need(not any(launched.values()),
         f"the calls past the coverage launched kernels: {launched}")


def runtime_stimulus(name: str, dev):
    """(payload (npkts, 240), int16 PCM) of a phase-8d case, both numpy:
    ``tests/test_round4_fixes.py``'s ``_tx_8psk_offset`` recipe with the
    port's functions (random packets from a numpy seed, channel bits padded
    with random bits to whole modem frames, one ``tx_stream`` call on the
    card at the case's offset), then AWGN at the case's SNR from numpy;
    the uncoded case with RUNTIME_GAP_S of weak noise in the middle."""
    import numpy as np
    import torch
    from qpsk_tpu_torch import ModemConfig, tx_init, tx_stream
    from qpsk_tpu_torch.packet import PacketConfig, assemble_packet

    fields, pfields, snr, offset, npkts = RUNTIME_CASES[name]
    cfg, pcfg = ModemConfig(**fields), PacketConfig(payload_bytes=30, **pfields)
    seed = 0 if name == "8psk_spur" else len(name)
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (npkts, 240), dtype=np.int32)
    chan = assemble_packet(pcfg, torch.from_numpy(payload).to(dev)).reshape(-1)
    mfb = cfg.bits_per_frame
    pad = torch.from_numpy(rng.integers(0, 2, ((-chan.numel()) % mfb,),
                                        dtype=np.int32)).to(dev)
    chan = torch.cat([chan, pad]).reshape(-1, mfb)
    _, pcm = tx_stream(cfg, tx_init(cfg, device=dev), chan, offset)
    x = pcm.reshape(-1).cpu().numpy().astype(np.float64)
    noise = np.random.default_rng(seed + 10)
    sigma = np.sqrt((x ** 2).mean() / 10.0 ** (snr / 10.0))
    x = np.clip(np.round(x + noise.normal(size=x.shape) * sigma), -32768,
                32767).astype(np.int16)
    if name == "uncoded":
        gap = noise.normal(0.0, 0.1 * sigma, int(RUNTIME_GAP_S * cfg.fs))
        half = x.size // 2
        x = np.concatenate([x[:half], gap.astype(np.int16), x[half:]])
    return payload, x


def runtime_tx(dev) -> None:
    """Phase 8c: ``StreamModulator`` on the card, RUNTIME_TX packets of 30
    bytes in seeded pushes of 1 up to RUNTIME_TX[1] packets, then
    ``flush``, for QPSK and 8PSK, against the same class with
    ``tx_impl="xla"`` on the card: the PCM within 3 LSB, the pending bits
    equal after every push, the carried tail exact and the phase within
    1e-5 at the end; the TX counter equals the ``tx_stream`` calls the
    class made (a push that modulates a row, and a flush that has bits to
    send) and the plain side launches nothing."""
    import numpy as np
    import torch
    from qpsk_tpu_torch import ModemConfig, StreamModulator
    from qpsk_tpu_torch.packet import PacketConfig

    npk, most = RUNTIME_TX
    for name in ("qpsk", "8psk"):
        cfg, pcfg = ModemConfig(modulation=name), PacketConfig(payload_bytes=30)
        rng = np.random.default_rng(len(name) + 200)
        payload = rng.integers(0, 2, (npk, 240), dtype=np.int32)
        cuts = np.cumsum(rng.integers(1, most + 1, npk))
        cuts = [0] + [int(v) for v in cuts[cuts < npk]] + [npk]
        out, walls, calls = {}, {}, 0
        for side, scfg in (("kernel", cfg),
                           ("plain", dataclasses.replace(cfg, tx_impl="xla"))):
            mod = StreamModulator(scfg, pcfg, tx_offset_hz=TX_OFFSET_HZ,
                                  device=dev)
            reset_launches()
            torch.cuda.synchronize()
            t0, pcm, pends, calls = time.perf_counter(), [], [], 0
            for a, b in zip(cuts[:-1], cuts[1:]):
                # a push modulates a row if its bits fill one
                bits = mod._pend.size + (b - a) * pcfg.frame_bits
                calls += mod._aligned or bits >= mod._chunk_bits
                pcm.append(mod.push(payload[a:b]))
                pends.append(mod._pend.copy())
            calls += mod._pend.size > 0
            pcm.append(mod.flush())
            torch.cuda.synchronize()
            walls[side] = time.perf_counter() - t0
            out[side] = (np.concatenate(pcm), pends, mod,
                         kernel_launches()["tx"])
        (pk, ek, mk, nk), (pp, ep, mp, np_) = out["kernel"], out["plain"]
        worst = int(np.abs(pk.astype(np.int32) - pp.astype(np.int32)).max())
        need(pk.shape == pp.shape and worst <= 3,
             f"StreamModulator {name}: PCM differs by {worst} LSB")
        need(all(np.array_equal(a, b) for a, b in zip(ek, ep)),
             f"StreamModulator {name}: pending bits differ")
        need(cmax_abs(mk._state.fir_tail, mp._state.fir_tail) == 0,
             f"StreamModulator {name}: the carried tail differs")
        ph = cmax_abs(mk._state.nco_phase, mp._state.nco_phase)
        need(ph <= 1e-5, f"StreamModulator {name}: the phase differs by {ph}")
        need(nk == calls and np_ == 0, f"StreamModulator {name}: {nk} TX "
             f"launches for {calls} tx_stream calls, plain side {np_}")
        audio = pk.size / cfg.fs
        print(f"  StreamModulator {name}: {npk} packets in {len(cuts) - 1} "
              f"pushes + flush, {audio:.1f} s of audio: PCM within {worst} "
              f"LSB of tx_impl='xla', pending bits equal, tail exact, phase "
              f"{ph:.3g}; {nk} TX launches for {calls} calls; "
              f"{audio / walls['kernel']:.1f} audio s a wall s (plain "
              f"{audio / walls['plain']:.1f})")


def runtime_case(name: str, dev, rtf: dict) -> None:
    """Phase 8d/e: one stream through ``StreamDemodulator`` on the card,
    once with the kernels ("auto") and once with ``costas_impl="scan"`` and
    ``frontend_impl="xla"`` (the decoders on "auto" both sides), on the
    same PCM in the same seeded chunks: the same packets (payload,
    ``crc_ok``, ``stream_index``) and the same counters, every passing
    payload one that was sent, every kernel counter of the path moved on
    the kernel side and the front-end's and Costas' on neither the plain
    side.  The uncoded case resyncs after its dead air under squelch, and
    is saved halfway and resumed in a fresh receiver on the card, which
    must emit the uninterrupted run's packets; the 8PSK case must sync
    through the candidate rotation.  Prints the audio seconds a wall
    second of each side and the launches per bucket."""
    import tempfile

    import numpy as np
    import torch
    from qpsk_tpu_torch import ModemConfig, StreamDemodulator
    from qpsk_tpu_torch.packet import PacketConfig

    fields, pfields, _, _, _ = RUNTIME_CASES[name]
    cfg, pcfg = ModemConfig(**fields), PacketConfig(payload_bytes=30, **pfields)
    payload, pcm = runtime_stimulus(name, dev)
    rng = np.random.default_rng(len(name) + 100)
    cuts = np.cumsum(rng.integers(1, RUNTIME_CHUNK + 1, pcm.size))
    cuts = [0] + [int(v) for v in cuts[cuts < pcm.size]] + [pcm.size]
    chunks = list(zip(cuts[:-1], cuts[1:]))
    knobs = (dict(squelch_db=RUNTIME_SQUELCH_DB) if name == "uncoded" else {})
    half = len(chunks) // 2
    path = os.path.join(tempfile.mkdtemp(), f"{name}.npz")
    runs, at_half = {}, 0
    for side, scfg in (("kernel", cfg), ("plain", path_cfg(cfg, "plain"))):
        demod = StreamDemodulator(scfg, pcfg, device=dev, **knobs)
        reset_launches()
        torch.cuda.synchronize()
        t0, saved_s = time.perf_counter(), 0.0
        pkts = []
        for i, (a, b) in enumerate(chunks):
            pkts += demod.push(pcm[a:b])
            if i == half and side == "kernel":
                t1 = time.perf_counter()
                demod.save(path)
                saved_s, at_half = time.perf_counter() - t1, len(pkts)
        pkts += demod.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - saved_s
        runs[side] = (demod, pkts, wall,
                      kernel_launches())
    (dk, pk, wk, lk_), (dp, pp, wp, lp) = runs["kernel"], runs["plain"]
    need(len(pk) == len(pp) and all(
        (a.crc_ok, a.stream_index) == (b.crc_ok, b.stream_index)
        and np.array_equal(a.payload, b.payload) for a, b in zip(pk, pp)),
        f"{name}: the kernel and plain runtimes emit different packets")
    fields_c = ("frames", "packets", "crc_failures", "resyncs", "synced")
    need(all(getattr(dk.counters, f) == getattr(dp.counters, f)
             for f in fields_c), f"{name}: counters differ: {dk.counters} vs "
         f"{dp.counters}")
    sent = {row.tobytes() for row in payload}
    ok = [p for p in pk if p.crc_ok]
    need(all(p.payload.astype(np.int32).tobytes() in sent for p in ok),
         f"{name}: a passing payload was not sent")
    path_kernels = ["frontend", "costas"] + (
        ["viterbi"] if pcfg.fec_kind == "conv" else
        ["ldpc"] if pcfg.fec_kind == "ldpc" else [])
    for k in path_kernels:
        need(lk_[k] > 0, f"{name}: the runtime never launched the {k} kernel")
    need(not lp["frontend"] and not lp["costas"],
         f"{name}: the plain runtime launched {lp}")
    need(dk.counters.synced or dk.counters.resyncs > 0,
         f"{name}: the runtime never synced")
    if name == "uncoded":
        need(dk.counters.resyncs >= 1, "uncoded: no resync after the gap")
        resumed = StreamDemodulator(cfg, pcfg, device=dev, **knobs)
        resumed.load(path)
        rest = []
        for a, b in chunks[half + 1:]:
            rest += resumed.push(pcm[a:b])
        rest += resumed.flush()
        tail = pk[at_half:]
        need(len(rest) == len(tail) and all(
            (a.crc_ok, a.stream_index) == (b.crc_ok, b.stream_index)
            and np.array_equal(a.payload, b.payload)
            for a, b in zip(rest, tail)),
            "uncoded: the resumed receiver's packets differ")
        need(resumed.counters.packets == dk.counters.packets,
             "uncoded: the resumed receiver's counters differ")
        print(f"  uncoded: saved at push {half} of {len(chunks)} "
              f"({at_half} packets out), loaded into a fresh receiver on the "
              f"card: the remaining {len(rest)} packets equal")
    if name == "8psk_spur":
        need(dk._acq_idx >= 1 and dk.counters.synced,
             f"8psk_spur: no sync through the candidate rotation "
             f"(_acq_idx {dk._acq_idx})")
    audio = pcm.size / cfg.fs
    buckets = max(lk_["frontend"], 1)
    per_bucket = {k: round(lk_[k] / buckets, 3) for k in path_kernels}
    rtf[name] = (audio / wk, audio / wp)
    print(f"  {name}: {len(pk)} packets, {len(ok)} pass CRC, counters "
          f"{ {f: getattr(dk.counters, f) for f in fields_c} }, offset "
          f"{dk.counters.detected_offset_hz:.3f} Hz, acquisition candidate "
          f"{dk._acq_idx}; the plain runtime alike.  {audio:.1f} s of audio "
          f"in {len(chunks)} pushes: kernel runtime {wk:.3f} s wall "
          f"({audio / wk:.2f} audio s a wall s), plain {wp:.3f} s "
          f"({audio / wp:.2f}); {buckets} buckets, launches per bucket "
          f"{per_bucket}")


def runtime_profile(dev, steps: int = 5) -> None:
    """``--profile``: one bucket of each phase-8d case through a synced
    ``StreamDemodulator`` on the card under ``torch.profiler``: device
    operations, device busy time against the wall, copies and waits."""
    from qpsk_tpu_torch import ModemConfig, StreamDemodulator
    from qpsk_tpu_torch.packet import PacketConfig

    for name, (fields, pfields, _, _, _) in RUNTIME_CASES.items():
        cfg = ModemConfig(**fields)
        pcfg = PacketConfig(payload_bytes=30, **pfields)
        _, pcm = runtime_stimulus(name, dev)
        demod = StreamDemodulator(cfg, pcfg, device=dev)
        bucket = demod.bucket_frames * cfg.frame_size
        pos = [0]
        demod.push(pcm[:pcm.size // 2])
        pos[0] = pcm.size // 2

        def step():
            demod.push(pcm[pos[0]:pos[0] + bucket])
            pos[0] += bucket
        ops, htod, syncs, wall_us = traced(step, steps)
        report_trace(f"runtime {name}, one bucket of {demod.bucket_frames} "
                     f"frames (synced: {demod.counters.synced})", ops, htod,
                     syncs, wall_us, steps)


def runtime_phase(pcfg, dev, errs: dict, counts: dict, times: dict) -> None:
    """Phase 8: the lowering switches, the general kernel instances and the
    streaming runtime on the card (``--runtime`` runs it alone)."""
    t0 = time.perf_counter()
    print("phase 8a: the lowering switches")
    lowering_switches(pcfg, dev)
    print("phase 8b: the general kernel instances")
    general_instances(pcfg, dev, errs, counts, times)
    print("phase 8c: StreamModulator on the card")
    runtime_tx(dev)
    print("phase 8d: StreamDemodulator on the card, one stream")
    rtf = {}
    for name in RUNTIME_CASES:
        runtime_case(name, dev, rtf)
    print("phase 8e: audio seconds a wall second, kernel runtime / plain: "
          + ", ".join(f"{n} {k:.2f} / {p:.2f}" for n, (k, p) in rtf.items())
          + f" ({nvidia_smi_line()}); phase 8 took "
          f"{time.perf_counter() - t0:.1f} s")


@contextlib.contextmanager
def no_plain():
    """Inside, a call of a kernel wrapper's plain version (Costas, either
    front-end, TX, Viterbi, LDPC) raises: a path run in it reaches the
    kernels only."""
    from qpsk_tpu_torch.ops.cuda import (costas_kernel, frontend_kernel,
                                         ldpc_kernel, tx_kernel,
                                         viterbi_kernel)
    mods = {"frontend": frontend_kernel, "costas": costas_kernel,
            "tx": tx_kernel, "viterbi": viterbi_kernel, "ldpc": ldpc_kernel}
    names = {"costas": ("costas_run_tm_plain",),
             "frontend": ("rx_frontend_tm_plain", "frontend_xla"),
             "tx": ("tx_modulate_plain",), "viterbi": ("viterbi_decode_plain",),
             "ldpc": ("ldpc_decode_plain",)}
    saved = {(k, n): getattr(mods[k], n) for k, ns in names.items() for n in ns}

    def refuse(key):
        def call(*args, **kw):
            raise SmokeFailure(f"{key[0]}.{key[1]} ran on a kernel path")
        return call
    for (k, n) in saved:
        setattr(mods[k], n, refuse((k, n)))
    try:
        yield
    finally:
        for (k, n), fn in saved.items():
            setattr(mods[k], n, fn)


@contextlib.contextmanager
def recorded_costas(seen: list, caller=None):
    """Inside, every ``costas_run_cm`` call of ``caller`` (a module; the
    modem's composed chains and ``rx_frame`` by default) is recorded in
    ``seen`` as (args, kwargs)."""
    if caller is None:
        from qpsk_tpu_torch import modem as caller
    saved = caller.costas_run_cm

    def call(*args, **kw):
        seen.append((args, kw))
        return saved(*args, **kw)
    caller.costas_run_cm = call
    try:
        yield
    finally:
        caller.costas_run_cm = saved


def check_costas_cm(seen: list, label: str, errs: dict, every: int = 1,
                    key: str = "costas") -> None:
    """The Costas kernel against its plain version on the (C, T) symbols
    and state of every ``every``-th recorded ``costas_run_cm`` call."""
    for i, ((cs, sym, params, trace), kw) in enumerate(seen):
        if i % every:
            continue
        check_costas(cs, sym.re.T.contiguous(), sym.im.T.contiguous(), params,
                     trace, True, f"{label} call {i}", errs,
                     gear=kw.get("gear"), dd=kw.get("dd"))


def mode_loopback(name: str, pcfg, dev, errs: dict) -> dict:
    """Phase 9b: one mode's loopback at full width through the kernels,
    every launch counter reset before and read after, no plain version
    allowed on the way; then each kernel against its plain version on the
    path's own inputs and the plain path on the same PCM (``check_path``),
    and the decodes of 64 sampled channels.  Returns the launches by
    kernel: TX and Costas, and the time-major front-end for DQPSK and the
    reference slicer (the timing modes run the plain full-rate front-end,
    so the front-end kernel must not launch there)."""
    import torch
    from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream, tx_init, tx_stream
    from qpsk_tpu_torch.channel import awgn_pcm, clock_offset_pcm
    from qpsk_tpu_torch.packet import assemble_packet

    fields, snr_db, nframes, skip, link = MODE_PATHS[name]
    cfg, c = ModemConfig(**fields), MAIN_PATH[0]
    reset_launches()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(2031)
    npk = nframes * cfg.bits_per_frame // pcfg.frame_bits
    payload = torch.randint(0, 2, (c, npk, 8 * pcfg.payload_bytes),
                            generator=gen, device=dev, dtype=torch.int32)
    chan = assemble_packet(pcfg, payload).reshape(c, nframes, -1)
    with no_plain():
        _, clean = tx_stream(cfg, tx_init(cfg, (c,), device=dev), chan,
                             tx_offset_hz=TX_OFFSET_HZ)
    sent = clean
    if name == "tracking":
        warped = clock_offset_pcm(clean.reshape(c, -1), *MODE_CLOCK)
        nf = warped.shape[1] // cfg.frame_size
        sent = warped[:, :nf * cfg.frame_size].reshape(c, nf, cfg.frame_size)
    power = float(((sent.to(torch.float32) / cfg.pcm_scale) ** 2).mean())
    pcm = awgn_pcm(gen, sent, snr_db, power, cfg.pcm_scale)
    with no_plain():
        _, out = rx_stream(cfg, rx_init(cfg, (c,), device=dev), pcm)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernel_launches(("tx", "frontend", "costas"))
    print(f"  {name}: {c} channels x {pcm.shape[1]} frames, TX -> "
          + (f"clock offset {MODE_CLOCK} -> " if name == "tracking" else "")
          + f"AWGN {snr_db} dB -> RX in {seconds:.3f} s (host clock, first "
          f"call); launches {counts}")
    fe_kernel = cfg.timing_mode == "power"
    for kernel, n in counts.items():
        need((n > 0) == (kernel != "frontend" or fe_kernel),
             f"the {name} path launched the {kernel} kernel {n} times")
    need(out.bits.device == pcm.device == out.symbols.re.device,
         f"{name} left the card")
    need(bool(torch.isfinite(out.symbols.re).all()
              and torch.isfinite(out.symbols.im).all()), "non-finite symbols")
    need(tuple(out.bits.shape) == (c, pcm.shape[1], cfg.bits_per_frame),
         f"bits of shape {tuple(out.bits.shape)}")
    _, plain_bits, flips = check_path(cfg, chan, clean, pcm, out, dev,
                                      f"C={c} {name}", errs)
    npk, nok, _ = compare_decodes(
        pcfg, out, plain_bits, flips, payload, name, link=link,
        skip_packets=skip, tracked=name == "tracking",
        rotation=0 if cfg.differential else None)
    if name == "tracking":
        need(nok > MODE_TRACK_PASS * npk,
             f"only {nok} of {npk} packets pass CRC ({name})")
    return counts


def mode_coded(dev, errs: dict) -> int:
    """Phase 9b: DQPSK + ``fec="conv"`` at full coded width, decoded from
    hard bits as the runtime decodes DQPSK (``_use_soft`` off): 64 sampled
    channels' four rotations into ``find_sync_streams(soft=False,
    probe_frames=8)`` and the slip-tracked hard extractor, through the
    Viterbi kernel; the same bits through the plain decoder (the same
    packets), and the plain modem path's bits (the same sync, CRC
    verdicts differing on <= 0.1 % of packets).  Every channel syncs at
    rotation 0.  Returns the Viterbi kernel's launches."""
    import torch
    from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream, tx_init, tx_stream
    from qpsk_tpu_torch.channel import awgn_pcm
    from qpsk_tpu_torch.packet import PacketConfig, assemble_packet
    from qpsk_tpu_torch.sync import (default_max_lag, extract_packets_tracked,
                                     find_sync_streams, rotated_streams)

    cfg = ModemConfig(differential=True)
    pcfg = PacketConfig(payload_bytes=30, fec="conv")
    (c, npkt), fb, mfb = MODE_CODED, pcfg.frame_bits, cfg.bits_per_frame
    skip = 8 * fb
    channels = sorted({round(i * (c - 1) / 63) for i in range(64)})

    def decode(bits):
        sync = find_sync_streams(pcfg, rotated_streams(bits),
                                 max_lag=default_max_lag(pcfg), probe_frames=8,
                                 soft=False)
        navail = (bits.numel() - int(sync.bit_lag)) // fb
        return sync, extract_packets_tracked(pcfg, bits, sync, max(navail, 1))

    reset_launches()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(2032)
    payload = torch.randint(0, 2, (c, npkt, 8 * pcfg.payload_bytes),
                            generator=gen, device=dev, dtype=torch.int32)
    chan = assemble_packet(pcfg, payload).reshape(c, -1)
    nframes = -(-chan.shape[1] // mfb)
    filler = torch.randint(0, 2, (c, nframes * mfb - chan.shape[1]),
                           generator=gen, device=dev, dtype=torch.int32)
    frames = torch.cat([chan, filler], dim=1).reshape(c, nframes, mfb)
    with no_plain():
        _, clean = tx_stream(cfg, tx_init(cfg, (c,), device=dev), frames,
                             tx_offset_hz=TX_OFFSET_HZ)
        power = float(((clean.to(torch.float32) / cfg.pcm_scale) ** 2).mean())
        pcm = awgn_pcm(gen, clean, MODE_CODED_SNR_DB, power, cfg.pcm_scale)
        _, out = rx_stream(cfg, rx_init(cfg, (c,), device=dev), pcm)
        results = [decode(out.bits[ch].reshape(-1)[skip:]) for ch in channels]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernel_launches()
    print(f"  dqpsk+conv: {c} channels x {npkt} packets = {nframes} frames, "
          f"TX -> AWGN {MODE_CODED_SNR_DB} dB -> RX -> hard sync and tracked "
          f"extraction on {len(channels)} channels in {seconds:.3f} s (host "
          f"clock, first call); launches {counts}")
    for name in ("frontend", "costas", "tx", "viterbi"):
        need(counts[name] > 0, f"the DQPSK + conv path never launched {name}")
    with plain_decoders():
        plain = [decode(out.bits[ch].reshape(-1)[skip:]) for ch in channels]
    _, plain_bits, _ = check_path(cfg, frames, clean, pcm, out, dev,
                                  f"C={c} dqpsk+conv", errs)
    plain_path = [decode(plain_bits[ch].reshape(-1)[skip:]) for ch in channels]
    nok = npk = 0
    path_diffs = []
    for ch, (ks, krx), (ps, prx), (qs, qrx) in zip(channels, results, plain,
                                                   plain_path):
        key = (int(ks.rotation), int(ks.bit_lag), int(ks.score))
        need(key == (int(ps.rotation), int(ps.bit_lag), int(ps.score))
             and all(torch.equal(a, b) for a, b in zip(krx, prx)),
             f"channel {ch}: the kernel and plain Viterbi differ")
        need(key[:2] == (int(qs.rotation), int(qs.bit_lag)),
             f"channel {ch}: the kernel and plain modem paths sync differently")
        need(key[0] == 0, f"channel {ch}: DQPSK synced at rotation {key[0]}")
        path_diffs += [(ch, i) for i in torch.nonzero(
            krx.crc_ok != qrx.crc_ok).flatten().tolist()]
        nok += check_payloads(krx, payload[ch], ch)
        npk += krx.crc_ok.numel()
    need(len(path_diffs) <= 0.001 * npk, f"the kernel and plain modem paths "
         f"differ on {len(path_diffs)} of {npk} packets: {path_diffs[:8]}")
    print(f"  dqpsk+conv: every sampled channel synced at rotation 0; "
          f"{nok}/{npk} packets pass CRC (PER {1 - nok / npk:.5f}), all "
          f"bit-exact; the kernel and plain decoders agree, the kernel and "
          f"plain modem paths differ on {len(path_diffs)} CRC verdicts")
    need(nok >= npk // 2, f"only {nok} of {npk} coded packets pass CRC")
    return counts["viterbi"]


def parity_on_card(dev, errs: dict) -> int:
    """Phase 9c: ``config_parity()`` on the card against the C reference's
    golden vectors (``tests/golden/reference_vectors.npz``) at
    ``tests/test_golden_parity.py``'s tolerances: the RRC impulse response
    (1e-6), the TX PCM of the golden bits through ``tx_bits_frame`` (2
    counts on frame 0, 32 overall), the exact mix-down and matched filter
    a frame at a time (1e-3), the decimated symbols of ``rx_stream`` (the
    frame scan; 1e-3), the Costas kernel given the reference's decimated
    input through the ``CostasLoop`` facade (1e-5), and the frequency lock (within 5 Hz of the C trajectory
    and 3 Hz of +50).  Then the Costas kernel against its plain version
    on the symbols the scan handed it.  Returns the Costas launches of the
    ``rx_stream`` call."""
    import numpy as np
    import torch
    from qpsk_tpu_torch import config_parity, rx_init, rx_stream, tx_bits_frame, tx_init
    from qpsk_tpu_torch.modem import _tmat
    from qpsk_tpu_torch.ops import nco, rrc
    from qpsk_tpu_torch.ops.costas import CostasLoop
    from qpsk_tpu_torch.ops.cplx import CF32

    here = os.path.dirname(os.path.abspath(__file__))
    golden = np.load(os.path.join(here, "tests", "golden",
                                  "reference_vectors.npz"))
    cfg = config_parity()
    fsz, nf = cfg.frame_size, golden["filt"].shape[0]      # 40 RX frames
    imp = torch.zeros(2 * cfg.ntaps, device=dev)
    imp[0] = 1.0
    y, _ = rrc.fir_block(CF32(imp, torch.zeros_like(imp)),
                         rrc.fir_init_tail(cfg.ntaps, device=dev),
                         _tmat(cfg, 2 * cfg.ntaps, dev), cfg.gain,
                         2 * cfg.ntaps, exact=True)
    e_imp = max(float(np.abs(y.re.cpu().numpy() - golden["impulse"][:, 0]).max()),
                float(np.abs(y.im.cpu().numpy() - golden["impulse"][:, 1]).max()))
    need(e_imp <= 1e-6, f"parity impulse response off by {e_imp}")

    reset_launches()
    with no_plain():
        st, pcms = tx_init(cfg, device=dev), []
        bits = torch.from_numpy(golden["bits"].astype(np.int32)).to(dev)
        for k in range(bits.shape[0]):
            st, p = tx_bits_frame(cfg, st, bits[k], tx_offset_hz=TX_OFFSET_HZ)
            pcms.append(p)
    d = (torch.stack(pcms).to(torch.int32).cpu().numpy()
         - golden["pcm"].astype(np.int32))
    d = np.abs(d)
    need(d[0].max() <= 2 and d.max() <= 32,
         f"parity TX PCM off by {d[0].max()} on frame 0, {d.max()} overall")

    x = torch.from_numpy(golden["pcm"].reshape(-1).astype(np.float32)
                         / cfg.pcm_scale).to(dev)
    ph, tail, filt = nco.nco_init(device=dev), rrc.fir_init_tail(cfg.ntaps, device=dev), []
    for k in range(nf):
        seg = CF32(x[k * fsz:(k + 1) * fsz], torch.zeros(fsz, device=dev))
        seg, ph = nco.mix(seg, ph, -cfg.omega_center, "exact")
        seg, tail = rrc.fir_block(seg, tail, _tmat(cfg, fsz, dev), cfg.gain,
                                  fsz, exact=True)
        filt.append(torch.stack([seg.re, seg.im], -1))
    filt = torch.stack(filt).cpu().numpy()
    e_filt = float(np.abs(filt - golden["filt"]).max())
    need(e_filt <= 1e-3, f"parity front-end off by {e_filt}")

    seen = []
    t0 = time.perf_counter()
    with no_plain(), recorded_costas(seen):
        _, out = rx_stream(cfg, rx_init(cfg, device=dev),
                           torch.from_numpy(golden["pcm"].reshape(nf, fsz)).to(dev))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches()["costas"]
    need(launches == nf, f"the parity scan launched the Costas kernel "
         f"{launches} times for {nf} frames")
    ti = out.timing_index.cpu().numpy()
    prev, mine = np.zeros((128, 2), np.float32), []
    for k in range(nf):
        mine.append(prev)
        prev = filt[k][np.clip(np.arange(128) * cfg.cycles + int(ti[k]), 0,
                               fsz - 1)]
    e_dec = float(np.abs(np.stack(mine)[:, :126] - golden["decim"][:, :126]).max())
    need(e_dec <= 1e-3, f"parity decimation off by {e_dec}")

    # the reference's object API (CostasLoop) over the kernel, a frame a call
    loop = CostasLoop(cfg.loop_bw, cfg.min_freq, cfg.max_freq, cfg.damping,
                      device=dev)
    dec = torch.from_numpy(golden["decim"]).to(dev)
    before = kernel_launches()["costas"]
    costas = [loop(CF32(dec[k, :, 0], dec[k, :, 1])) for k in range(nf)]
    need(kernel_launches()["costas"] - before == nf,
         "CostasLoop did not launch the Costas kernel a call")
    costas = torch.stack([torch.stack([z.re, z.im], -1) for z in costas])
    e_cos = float(np.abs(costas.cpu().numpy() - golden["costas"]).max())
    need(e_cos <= 1e-5, f"the Costas kernel given the reference input is off by {e_cos}")
    mine_hz = float(out.freq_hz[-10:].mean())
    ref_hz = float(golden["freq"][-10:, 0].mean())
    need(abs(mine_hz - ref_hz) < 5.0 and abs(mine_hz - TX_OFFSET_HZ) < 3.0,
         f"parity lock at {mine_hz} Hz, the C trajectory's {ref_hz} Hz")
    print(f"  parity against the golden vectors: impulse {e_imp:.3g}, TX PCM "
          f"{d[0].max()} LSB on frame 0 and {d.max()} overall, front-end "
          f"{e_filt:.3g}, decimation {e_dec:.3g}, Costas kernel on the "
          f"reference input {e_cos:.3g}, lock {mine_hz:.4f} Hz (C "
          f"{ref_hz:.4f}); rx_stream of {nf} frames in {seconds:.3f} s, "
          f"{launches} Costas launches")
    check_costas_cm(seen, "parity scan", errs, every=8)
    return launches


def chirp_tx(dev) -> None:
    """Phase 9d: ``tx_stream(doppler_hz_per_s=...)`` on the card (the plain
    chirp chain, as in the JAX package) against the same call on CPU
    tensors: PCM within 2 LSB."""
    import torch
    from qpsk_tpu_torch import ModemConfig, tx_init, tx_stream

    cfg = ModemConfig()
    c, nframes, rate = MODE_CHIRP
    gen = torch.Generator(device="cpu").manual_seed(2033)
    bits = torch.randint(0, 2, (c, nframes, cfg.bits_per_frame), generator=gen,
                         dtype=torch.int32)
    reset_launches()
    with no_plain():
        _, card = tx_stream(cfg, tx_init(cfg, (c,), device=dev), bits.to(dev),
                            TX_OFFSET_HZ, doppler_hz_per_s=rate)
    _, host = tx_stream(cfg, tx_init(cfg, (c,), device="cpu"), bits,
                        TX_OFFSET_HZ, doppler_hz_per_s=rate)
    worst = int((card.cpu().to(torch.int32) - host.to(torch.int32)).abs().max())
    need(worst <= 2, f"the chirped TX on the card is {worst} LSB off the CPU's")
    need(kernel_launches()["tx"] == 0, "the chirp launched the TX kernel")
    print(f"  chirp TX ({rate} Hz/s from +{TX_OFFSET_HZ} Hz, {c} channels x "
          f"{nframes} frames): within {worst} LSB of the same call on the CPU")


def mode_rates(dev, errs: dict) -> None:
    """Phase 9e: RX samples/s of the kernel path at the rate point for
    DQPSK and tracking (CUDA events), and of ``config_parity()``'s frame
    scan at PARITY_RATE (host clock around a synchronised call), with the
    launches of one call; the Costas kernel against its plain version on
    the symbols the tracking chain and the parity scan hand it there."""
    import torch
    from qpsk_tpu_torch import ModemConfig, config_parity, rx_init, rx_stream

    (c, nframes), iters = RATE_POINT, 10
    for name in ("dqpsk", "tracking"):
        cfg = ModemConfig(**MODE_PATHS[name][0])
        pcm = noise_pcm(cfg, c, nframes, 7, dev)
        seen = []
        with recorded_costas(seen):
            rx_stream(cfg, rx_init(cfg, (c,), device=dev), pcm)
        check_costas_cm(seen, f"{name} C={c} F={nframes} noise", errs)
        step = rx_step(cfg, dev, pcm, "kernel")[0]
        ms = cuda_time_ms(step, iters)
        reset_launches()
        step()
        torch.cuda.synchronize()
        print(f"  rx_stream {name:8s} kernel path: {ms:.4f} ms/call, "
              f"{c * nframes * cfg.frame_size / ms * 1e3:.6g} samples/s; "
              f"launches a call {list(kernel_launches().items())}")
    cfg = config_parity()
    c, nframes = PARITY_RATE
    pcm = noise_pcm(cfg, c, nframes, 8, dev)
    st = rx_init(cfg, (c,), device=dev)
    rx_stream(cfg, st, pcm[:, :1])                        # warm-up
    seen = []
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_costas(seen):
        rx_stream(cfg, st, pcm)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = kernel_launches()["costas"]
    print(f"  rx_stream parity   kernel path: {ms:.3f} ms/call of {nframes} "
          f"frames, {c * nframes * cfg.frame_size / ms * 1e3:.6g} samples/s, "
          f"{ms / nframes:.3f} ms a frame (host clock); Costas launches "
          f"{launches}")
    need(launches == nframes, f"parity launched Costas {launches} times")
    check_costas_cm(seen, f"parity C={c}", errs)


def forced_kernel_refusal(dev) -> None:
    """Phase 9f: ``frontend_impl="pallas"`` with tracking timing raises
    ``ValueError`` before any launch (the kernel computes power timing
    only)."""
    import torch
    from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream

    cfg = ModemConfig(timing_mode="tracking", frontend_impl="pallas")
    reset_launches()
    try:
        rx_stream(cfg, rx_init(cfg, (256,), device=dev),
                  torch.zeros((256, 2, cfg.frame_size), dtype=torch.int16,
                              device=dev))
        raise SmokeFailure("frontend_impl='pallas' with tracking ran")
    except ValueError as e:
        need("frontend_impl" in str(e), f"the refusal does not name the field: {e}")
    n = sum(_lib.launches.values())
    need(n == 0, f"{n} launches before the refusal")
    print("  frontend_impl='pallas' with timing_mode='tracking': ValueError "
          "before any launch")


def modes_phase(pcfg, dev, errs: dict, counts: dict) -> None:
    """Phase 9: the rest of the modem's modes (``--modes`` runs it alone);
    adds each loopback's launches to ``counts``."""
    t0 = time.perf_counter()
    print("phase 9a/b: DQPSK, the timing modes and the reference slicer, "
          "kernels against their plain versions on each path")
    for name in MODE_PATHS:
        got = mode_loopback(name, pcfg, dev, errs)
        for kernel, n in got.items():
            counts[kernel] = counts.get(kernel, 0) + n
    counts["viterbi"] = counts.get("viterbi", 0) + mode_coded(dev, errs)
    print("phase 9c: parity with the C reference on the card")
    counts["costas"] = counts.get("costas", 0) + parity_on_card(dev, errs)
    print("phase 9d: the chirped TX")
    chirp_tx(dev)
    print("phase 9e: rates")
    print(f"  before: {CLOCKS} = {nvidia_smi_line(CLOCKS)}")
    mode_rates(dev, errs)
    print(f"  after:  {CLOCKS} = {nvidia_smi_line(CLOCKS)}")
    print("phase 9f: the forced front-end kernel")
    forced_kernel_refusal(dev)
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s ({nvidia_smi_line()})")


def int16_close(label: str, got, want, lsb: int = 1) -> int:
    """Two int16 tensors of one shape within ``lsb``: prints the largest
    difference and the share of samples that differ; returns the former."""
    import torch
    need(tuple(got.shape) == tuple(want.shape),
         f"{label}: shapes {tuple(got.shape)} and {tuple(want.shape)}")
    d = (got.cpu().to(torch.int32) - want.cpu().to(torch.int32)).abs()
    worst = int(d.max()) if d.numel() else 0
    print(f"  {label}: largest difference {worst} LSB, "
          f"{float((d != 0).to(torch.float64).mean()):.3g} of {d.numel()} "
          f"samples differ")
    need(worst <= lsb, f"{label}: {worst} LSB apart (bound {lsb})")
    return worst


def bank_on_card(dev) -> None:
    """Phase 10a: the FDM bank at 2048 slots x 32 frames and the resampler
    on 10 minutes of one stream at 9600 -> 48 000 and 44 100 -> 9600, on
    the card against the same functions on CPU tensors, and chained calls
    against one call: the int16 outputs within 1 LSB."""
    import torch
    from qpsk_tpu_torch import fdm
    from qpsk_tpu_torch.ops import resample as rs

    t0 = time.perf_counter()
    fcfg = fdm.FdmConfig(nslots=FDM_SLOTS)
    gen = torch.Generator().manual_seed(2050)

    def pcm16(shape, rms):
        return torch.clamp(torch.round(torch.randn(shape, generator=gen)
                                       * rms), -32768, 32767).to(torch.int16)
    n = FDM_FRAMES * 512
    pcm = pcm16((fcfg.nchan, n), 6000.0)
    wide = fdm.fdm_mux(fcfg, pcm.to(dev))
    int16_close(f"fdm_mux of {fcfg.nchan} x {n} samples, card vs CPU", wide,
                fdm.fdm_mux(fcfg, pcm))
    st, parts, step = fdm.fdm_init(fcfg, dev), [], n // 4
    for i in range(4):
        w, st = fdm.fdm_mux_stream(fcfg, pcm[:, i * step:(i + 1) * step]
                                   .to(dev), st)
        parts.append(w)
    int16_close("fdm_mux in 4 chained calls vs one call, on the card",
                torch.cat(parts), wide)
    noisy = torch.clamp(wide.cpu().to(torch.float32) + pcm16(wide.shape, 300.0),
                        -32768, 32767).to(torch.int16)
    back = fdm.fdm_demux(fcfg, noisy.to(dev))
    int16_close(f"fdm_demux of {noisy.numel()} wideband samples, card vs CPU",
                back, fdm.fdm_demux(fcfg, noisy))
    st, parts, wstep = fdm.fdm_init(fcfg, dev), [], step * FDM_SLOTS
    for i in range(4):
        p, st = fdm.fdm_demux_stream(fcfg, noisy[i * wstep:(i + 1) * wstep]
                                     .to(dev), st)
        parts.append(p)
    int16_close("fdm_demux in 4 chained calls vs one call, on the card",
                torch.cat(parts, dim=1), back)
    for fs_in, fs_out in RESAMPLE_RATES:
        l, m = rs.rational_ratio(fs_in, fs_out)
        x = pcm16((fs_in * RESAMPLE_SECONDS,), 6000.0)
        y = rs.resample_pcm(x.to(dev), fs_in, fs_out)
        int16_close(f"resample_pcm {fs_in} -> {fs_out} of {x.numel()} "
                    f"samples, card vs CPU", y, rs.resample_pcm(x, fs_in, fs_out))
        st, parts, xf = rs.resample_init(l, m, device=dev), [], x.to(dev)
        for i in range(RESAMPLE_SECONDS):
            yy, st = rs.resample_stream(
                xf[i * fs_in:(i + 1) * fs_in].to(torch.float32), st, l, m)
            parts.append(yy)
        chained = torch.clamp(torch.round(torch.cat(parts)), -32768,
                              32767).to(torch.int16)
        int16_close(f"resample_stream {fs_in} -> {fs_out} in "
                    f"{RESAMPLE_SECONDS} chained 1 s calls vs one call, on "
                    f"the card", chained, y)
    print(f"  phase 10a took {time.perf_counter() - t0:.1f} s")


@contextlib.contextmanager
def plain_cli():
    """Inside, the CLI runs every kernel's plain version: its configs carry
    ``costas_impl="scan"``, ``frontend_impl="xla"`` and ``tx_impl="xla"``,
    and the packet layer decodes with ``impl`` "scan" (Viterbi) and "xla"
    (LDPC)."""
    from qpsk_tpu_torch import cli
    from qpsk_tpu_torch.packet import frame
    saved = (cli._cfg, frame.viterbi_decode, frame.ldpc_decode)
    cli._cfg = lambda args: dataclasses.replace(
        saved[0](args), costas_impl="scan", frontend_impl="xla",
        tx_impl="xla")
    frame.viterbi_decode = functools.partial(saved[1], impl="scan")
    frame.ldpc_decode = functools.partial(saved[2], impl="xla")
    try:
        yield
    finally:
        cli._cfg, frame.viterbi_decode, frame.ldpc_decode = saved


@contextlib.contextmanager
def recorded_cli(rec: dict):
    """Inside, the CLI's receive outputs (``rx_stream`` of the one-shot
    commands and of the sweep) go to ``rec["rx"]`` and its tracked
    extractions to ``rec["packets"]``, in call order."""
    from qpsk_tpu_torch import cli
    from qpsk_tpu_torch import eval as ev
    rec.update(rx=[], packets=[])
    saved = {(cli, "rx_stream"): cli.rx_stream, (ev, "rx_stream"): ev.rx_stream,
             (cli, "extract_packets_tracked"): cli.extract_packets_tracked}

    def rx(fn):
        def call(*args, **kw):
            st, out = fn(*args, **kw)
            rec["rx"].append(out)
            return st, out
        return call

    def extract(*args, **kw):
        got = saved[(cli, "extract_packets_tracked")](*args, **kw)
        rec["packets"].append(got)
        return got
    cli.rx_stream, ev.rx_stream = rx(cli.rx_stream), rx(ev.rx_stream)
    cli.extract_packets_tracked = extract
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def cli_call(argv: list, stdin: bytes | None = None) -> tuple:
    """(rc, stdout lines, stderr lines, wall s) of one in-process
    ``cli.main(argv)`` call, ``stdin`` its standard input."""
    import io

    import torch
    from qpsk_tpu_torch import cli
    # text streams over bytes: the CLI writes raw PCM to ``.buffer``
    out, err = (io.TextIOWrapper(io.BytesIO()) for _ in range(2))
    saved = sys.stdin
    if stdin is not None:
        sys.stdin = io.TextIOWrapper(io.BytesIO(stdin))
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        sys.stdin = saved
    seconds = time.perf_counter() - t0
    text = []
    for f in (out, err):
        f.flush()
        text.append(f.buffer.getvalue().decode().splitlines())
    return rc, text[0], text[1], seconds


# phase 10b: the Quickstart's command lines, each a list of steps: argv
# ("{d}" the side's scratch directory) and which half of the streamed
# spool is the step's standard input (None: none); the kernels each must
# launch
CLI_COMMANDS = {
    "loopback": ([(["loopback", "--snr-db", "10"], None)],
                 ("tx", "frontend", "costas")),
    "loopback_conv": ([(["loopback", "--fec", "conv", "--snr-db", "6",
                         "--frames", "40"], None)],
                      ("tx", "frontend", "costas", "viterbi")),
    "loopback_ldpc": ([(["loopback", "--fec", "ldpc", "--snr-db", "5"], None)],
                      ("tx", "frontend", "costas", "ldpc")),
    "tx_rx_wav": ([(["tx", "--io-rate", "48000", "--out", "{d}/x.wav"], None),
                   (["rx", "{d}/x.wav"], None)],
                  ("tx", "frontend", "costas")),
    "stream": ([(["tx", "--stream-in", "{d}/p.hex", "--out", "{d}/s.raw"],
                 None),
                (["rx", "-", "--stream", "--state-file", "{d}/rx.npz"], 0),
                (["rx", "-", "--stream", "--state-file", "{d}/rx.npz"], 1)],
               ("tx", "frontend", "costas")),
    "sweep": ([(["sweep"], None)], ("tx", "frontend", "costas")),
    "fdm": ([(["fdm", "--nslots", str(FDM_SLOTS), "--frames",
                str(FDM_FRAMES), "--snr-db", "18"], None)],
            ("tx", "frontend", "costas")),
}
# the JSON keys that are decisions (equal on the kernel and plain sides)
# and estimates (close), per record kind
_DECIDED = ("frames", "per", "ber", "sync_score", "packets",
            "sync_rotation_deg", "samples", "sample_rate", "snr_db", "nslots",
            "nchan", "wide_fs", "crc_ok", "crc_failures", "resyncs", "synced",
            "carrier_detect", "chan", "carrier_hz", "offset_hz")
_CLOSE = {"detected_offset_hz": 0.05, "detected_hz": 0.05, "evm_rms": 1e-3,
          "est_snr_db": 0.1, "carrier_snr_db": 0.05}


def cli_side(name: str, d: str, plain: bool) -> dict:
    """One side of a phase-10b command: its steps through ``cli.main`` in
    the scratch directory ``d``, the kernels only (``no_plain``) or every
    plain version (``plain_cli``), the launch counters reset before.
    Returns the steps' outputs, the recorded receive outputs and packets,
    the launches and the wall seconds."""
    import numpy as np
    steps, _ = CLI_COMMANDS[name]
    rng = np.random.default_rng(2052)
    with open(os.path.join(d, "p.hex"), "w") as fh:
        fh.write("\n".join(rng.integers(0, 256, 30, dtype=np.uint8).tobytes()
                           .hex() for _ in range(CLI_STREAM_LINES)) + "\n")
    reset_launches()
    rec, outs, wall = {}, [], 0.0
    with (plain_cli() if plain else no_plain()), recorded_cli(rec):
        for argv, half in steps:
            stdin = None
            if half is not None:
                raw = open(os.path.join(d, "s.raw"), "rb").read()
                cut = 2 * (len(raw) // 4 + 777)
                stdin = raw[:cut] if half == 0 else raw[cut:]
            rc, out, err, sec = cli_call([a.format(d=d) for a in argv], stdin)
            need(rc == 0, f"{name}: {' '.join(argv)} exited {rc}: "
                 f"{err[-3:]}")
            outs.append((out, err))
            wall += sec
    return dict(outs=outs, rec=rec, wall=wall,
                launches=kernel_launches())


def same_records(a: dict, b: dict, label: str, diffs: list) -> None:
    """Two JSON records of one kind: every decision equal (a difference is
    appended to ``diffs``), every estimate within its bound."""
    need(set(a) == set(b), f"{label}: keys {sorted(a)} vs {sorted(b)}")
    for key, va in a.items():
        vb = b[key]
        if key == "channels":
            for ca, cb in zip(va, vb):
                same_records(ca, cb, f"{label} channel {ca['chan']}", diffs)
        elif key in _CLOSE:
            need(abs(va - vb) <= _CLOSE[key], f"{label}: {key} {va} vs {vb}")
        elif key in _DECIDED and va != vb:
            diffs.append(f"{label}: {key} {va} vs {vb}")


def ties_explain(cfg, k_rx: list, p_rx: list, label: str) -> bool:
    """Whether the kernel and plain sides' receive outputs differ in some
    bits, each within NEAR_TIE of a decision boundary or on a channel
    whose loops parted at such a tie (``parted_at_a_tie``, at most one
    channel in a thousand, or one)."""
    import torch
    need(len(k_rx) == len(p_rx), f"{label}: {len(k_rx)} vs {len(p_rx)} calls")
    any_flip = False
    for i, (ko, po) in enumerate(zip(k_rx, p_rx)):
        def lead(x):
            return x if x.dim() == 3 else x[None]
        ks = type(ko.symbols)(lead(ko.symbols.re), lead(ko.symbols.im))
        ps = type(po.symbols)(lead(po.symbols.re), lead(po.symbols.im))
        kb, pb = lead(ko.bits), lead(po.bits)
        flips = kb != pb
        if not bool(flips.any()):
            continue
        any_flip = True
        away = flips & ~bit_ties(cfg, ks, kb.shape)
        parted = parted_at_a_tie(cfg, ks, ps, away, f"{label} call {i}",
                                 most=max(1.0, 0.001 * kb.shape[0]))
        print(f"  {label} call {i}: {int(flips.sum())} of {flips.numel()} "
              f"bits differ between the sides, each at a tie"
              + (f" or on a channel whose loops parted at one {parted}"
                 if parted else ""))
    return any_flip


def cli_command(name: str, root: str, counts: dict, walls: dict) -> None:
    """Phase 10b: one Quickstart command on the card through ``cli.main``,
    first through the kernels, then through every plain version on the
    same seeds: the kernels it must launch moved, none on the plain side;
    equal return codes, JSON decisions and payload lines (a decision may
    differ only where the receive bits parted at a tie, ``ties_explain``);
    the TX files within 4 LSB (2 of the TX kernel's bound through the
    resampler); the CLI's own gates (``per`` 0 where the JAX CLI's tests
    hold it so)."""
    import numpy as np
    from qpsk_tpu_torch import ModemConfig

    _, want = CLI_COMMANDS[name]
    sides = {}
    for side in ("kernel", "plain"):
        d = os.path.join(root, name, side)
        os.makedirs(d, exist_ok=True)
        sides[side] = cli_side(name, d, side == "plain")
    k, p = sides["kernel"], sides["plain"]
    walls[name] = (k["wall"], p["wall"])
    moved = {n: k["launches"][n] for n in want}
    need(all(moved.values()), f"{name}: a kernel never launched: {moved}")
    need(not any(p["launches"].values()),
         f"{name}: the plain side launched {p['launches']}")
    for n, v in moved.items():
        counts[n] = counts.get(n, 0) + v
    diffs = []
    for i, ((ko, ke), (po, pe)) in enumerate(zip(k["outs"], p["outs"])):
        label = f"{name} step {i}"
        if ko and ko[0].startswith("{"):
            for a, b in zip(map(json.loads, ko), map(json.loads, po)):
                a.pop("file", None), b.pop("file", None)
                same_records(a, b, label, diffs)
            need(len(ko) == len(po), f"{label}: {len(ko)} vs {len(po)} lines")
        else:
            need(ko == po, f"{label}: the payload lines differ: "
                 f"{len(ko)} vs {len(po)}")
        if ke and ke[-1].startswith("{"):
            same_records(json.loads(ke[-1]), json.loads(pe[-1]), label, diffs)
    if diffs:
        print(f"  {name}: decisions differ: {diffs[:6]}")
        need(ties_explain(ModemConfig(), k["rec"]["rx"], p["rec"]["rx"], name),
             f"{name}: decisions differ with equal receive bits: {diffs[:6]}")
    for f in ("x.wav", "s.raw"):
        kf = os.path.join(root, name, "kernel", f)
        if os.path.exists(kf):
            a = np.fromfile(kf, np.int16)
            b = np.fromfile(os.path.join(root, name, "plain", f), np.int16)
            need(a.size == b.size, f"{name}: {f} of {a.size} vs {b.size}")
            worst = int(np.abs(a.astype(np.int32) - b).max())
            need(worst <= 4, f"{name}: {f} {worst} LSB apart")
            print(f"  {name}: {f}, {a.size} samples, kernel and plain TX "
                  f"within {worst} LSB")
    recs = [json.loads(ln) for ln in k["outs"][-1][0]
            if ln.startswith("{")]
    if name == "tx_rx_wav":
        need(recs[0]["per"] == 0.0 and recs[0]["sync_score"] == 4,
             f"{name}: {recs[0]}")
    if name == "sweep":
        need(recs[-1]["per"] == 0.0 and recs[-1]["sync_score"] == 4,
             f"{name}: 12 dB point {recs[-1]}")
    if name == "stream":
        lines = k["outs"][1][0] + k["outs"][2][0]
        sent = set(open(os.path.join(root, name, "kernel", "p.hex"))
                   .read().split())
        need(len(lines) >= CLI_STREAM_LINES - 8 and set(lines) <= sent,
             f"{name}: {len(lines)} lines, {len(set(lines) - sent)} not sent")
    if name == "fdm":
        fdm_channels(recs[0], k["rec"]["packets"], p["rec"]["packets"])
    print(f"  {name}: kernel side {k['wall']:.2f} s, plain side "
          f"{p['wall']:.2f} s (host clock); launches {moved}; "
          + ("decisions equal" if not diffs else
             f"{len(diffs)} decisions differ at ties")
          + "; " + "; ".join(json.dumps(r)[:160] for r in recs[:1]))


def fdm_channels(rec: dict, k_pkts: list, p_pkts: list) -> None:
    """The ``fdm`` command at 2048 slots: every channel synced with no
    packet lost (the JAX CLI's test holds ``per`` 0 at 18 dB); on 64
    sampled channels the payloads bit-exact against those sent (the
    CLI's seeded draw) and equal on the kernel and plain sides."""
    import numpy as np
    import torch
    chans = rec["channels"]
    need(len(chans) == len(k_pkts) == len(p_pkts) == FDM_SLOTS // 2 - 1,
         f"fdm: {len(chans)} channels, {len(k_pkts)} extractions")
    bad = [c["chan"] for c in chans if c["sync_score"] < 3 or c["per"] > 0]
    need(not bad, f"fdm: channels without a clean link {bad[:10]}")
    sent = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2, (len(chans), FDM_FRAMES, 240), dtype=np.int32))
    sampled = sorted({round(i * (len(chans) - 1) / (CLI_SAMPLED - 1))
                      for i in range(CLI_SAMPLED)})
    nok = 0
    for ch in sampled:
        nok += check_payloads(k_pkts[ch], sent[ch], ch)
        need(torch.equal(k_pkts[ch].payload_bits.cpu(),
                         p_pkts[ch].payload_bits.cpu())
             and torch.equal(k_pkts[ch].crc_ok.cpu(), p_pkts[ch].crc_ok.cpu()),
             f"fdm channel {ch}: the kernel and plain sides' packets differ")
    offs = [c["detected_offset_hz"] for c in chans]
    print(f"  fdm: all {len(chans)} channels synced (scores "
          f"{min(c['sync_score'] for c in chans)}..4), PER 0 on every one; "
          f"{nok} packets of {len(sampled)} sampled channels bit-exact and "
          f"equal on both sides; offsets {min(offs):.2f}..{max(offs):.2f} Hz")


def fdm_receiver_on_card(dev, counts: dict) -> None:
    """Phase 10b: ``FdmReceiver`` at 16 slots (7 channels) on the card, a
    short stream in seeded chunks, kernel side (``no_plain``) against the
    plain side (the config's plain lowerings) on the same wideband PCM:
    the same packets on every channel, every passing payload sent."""
    import numpy as np
    import torch
    from qpsk_tpu_torch import ModemConfig, tx_init, tx_stream
    from qpsk_tpu_torch.channel import awgn_pcm
    from qpsk_tpu_torch.fdm import FdmConfig, FdmReceiver, fdm_mux
    from qpsk_tpu_torch.packet import PacketConfig, assemble_packet

    nslots, nframes = FDM_RX
    fcfg, cfg = FdmConfig(nslots=nslots), ModemConfig()
    pcfg, c = PacketConfig(payload_bytes=30), FdmConfig(nslots=nslots).nchan
    gen = torch.Generator(device=dev).manual_seed(2053)
    payload = torch.randint(0, 2, (c, nframes, 240), generator=gen,
                            device=dev, dtype=torch.int32)
    _, pcm = tx_stream(cfg, tx_init(cfg, (c,), device=dev),
                       assemble_packet(pcfg, payload), TX_OFFSET_HZ)
    wide = fdm_mux(fcfg, pcm.reshape(c, -1))
    power = float(((wide.to(torch.float32) / cfg.pcm_scale) ** 2).mean())
    wide = awgn_pcm(gen, wide, 18.0, power, cfg.pcm_scale).cpu().numpy()
    sizes = np.random.default_rng(2053).integers(1000, 30000, 400)
    got = {}
    for side in ("kernel", "plain"):
        reset_launches()
        rcfg = cfg if side == "kernel" else path_cfg(cfg, "plain")
        t0 = time.perf_counter()
        with (no_plain() if side == "kernel" else contextlib.nullcontext()):
            rx = FdmReceiver(fcfg, rcfg, pcfg, bucket_blocks=1024, device=dev)
            pkts = [[] for _ in range(c)]
            pos = 0
            for sz in sizes:
                if pos >= wide.size:
                    break
                for ch, new in enumerate(rx.push(wide[pos:pos + int(sz)])):
                    pkts[ch].extend(new)
                pos += int(sz)
            for ch, new in enumerate(rx.flush()):
                pkts[ch].extend(new)
        launched = kernel_launches(("frontend", "costas"))
        need(all(launched.values()) if side == "kernel"
             else not any(launched.values()),
             f"FdmReceiver {side} side: launches {launched}")
        if side == "kernel":
            for n, v in launched.items():
                counts[n] = counts.get(n, 0) + v
        got[side] = (pkts, time.perf_counter() - t0, launched)
    nok = 0
    for ch in range(c):
        a, b = got["kernel"][0][ch], got["plain"][0][ch]
        need(len(a) == len(b) and all(
            (x.crc_ok, x.stream_index) == (y.crc_ok, y.stream_index)
            and np.array_equal(x.payload, y.payload) for x, y in zip(a, b)),
             f"FdmReceiver channel {ch}: the sides' packets differ")
        ok = [x for x in a if x.crc_ok]
        sent = {bytes(row) for row in payload[ch].cpu().numpy().astype(np.int8)}
        need(len(ok) >= nframes - 10 and all(
            bytes(x.payload.astype(np.int8)) in sent for x in ok),
             f"FdmReceiver channel {ch}: {len(ok)} passing packets")
        nok += len(ok)
    print(f"  FdmReceiver at {nslots} slots ({c} channels x {nframes} "
          f"packets, 18 dB, {wide.size} wideband samples in seeded chunks): "
          f"the kernel and plain sides emit the same packets, {nok} passing, "
          f"all sent; kernel side {got['kernel'][1]:.2f} s (launches "
          f"{got['kernel'][2]}), plain side {got['plain'][1]:.2f} s")


def bank_rates(dev) -> None:
    """Phase 10c: by CUDA events, the FDM receive at 2048 slots x 8 frames
    (the wideband samples a second of demux + ``rx_stream`` over the 1023
    channels, the filterbank alone and the modem alone, state chained) and
    the resampler (10 minutes in one call; 1 s calls chained, the CLI's
    streaming use, by the host clock)."""
    import torch
    from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream
    from qpsk_tpu_torch.fdm import FdmConfig, fdm_demux_stream, fdm_init
    from qpsk_tpu_torch.ops import resample as rs

    fcfg, cfg = FdmConfig(nslots=FDM_SLOTS), ModemConfig()
    c, nf = fcfg.nchan, FDM_RATE_FRAMES
    gen = torch.Generator(device=dev).manual_seed(2054)
    wide = torch.clamp(torch.round(torch.randn(
        nf * 512 * FDM_SLOTS, generator=gen, device=dev) * 3000.0),
        -32768, 32767).to(torch.int16)
    st = {"fb": fdm_init(fcfg, dev), "rx": rx_init(cfg, (c,), device=dev)}

    def bank():
        out, st["fb"] = fdm_demux_stream(fcfg, wide, st["fb"])
        return out
    back = bank().reshape(c, nf, 512)

    def modem():
        st["rx"], _ = rx_stream(cfg, st["rx"], back)

    def composed():
        st["rx"], _ = rx_stream(cfg, st["rx"], bank().reshape(c, nf, 512))
    ms = {}
    for name, fn in (("composed", composed), ("bank", bank), ("modem", modem),
                     ("composed", composed)):
        ms.setdefault(name, []).append(cuda_time_ms(fn, 10))
    n = wide.numel()
    print(f"  FDM receive at {FDM_SLOTS} slots x {nf} frames ({n} wideband "
          f"samples a call): composed "
          + " / ".join(f"{t:.4f}" for t in ms["composed"])
          + f" ms, {n / min(ms['composed']) * 1e3:.6g} samples/s; filterbank "
          f"alone {ms['bank'][0]:.4f} ms ({n / ms['bank'][0] * 1e3:.6g} "
          f"samples/s), modem alone {ms['modem'][0]:.4f} ms "
          f"({n / ms['modem'][0] * 1e3:.6g} samples/s); the filterbank's "
          f"share {ms['bank'][0] / min(ms['composed']):.3f} "
          f"({nvidia_smi_line()})")
    for fs_in, fs_out in RESAMPLE_RATES:
        l, m = rs.rational_ratio(fs_in, fs_out)
        x = torch.randn(fs_in * RESAMPLE_SECONDS, generator=gen,
                        device=dev) * 6000.0
        one = cuda_time_ms(lambda: rs.resample(x, l, m), 3, warmup=1)
        chunks = x.reshape(RESAMPLE_SECONDS, fs_in)
        st_r = rs.resample_init(l, m, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(60):
            _, st_r = rs.resample_stream(chunks[i], st_r, l, m)
        torch.cuda.synchronize()
        chained = (time.perf_counter() - t0) / 60
        print(f"  resample {fs_in} -> {fs_out}: {RESAMPLE_SECONDS} s in one "
              f"call {one:.4f} ms ({x.numel() / one * 1e3:.6g} input "
              f"samples/s); 1 s calls chained {chained * 1e3:.4f} ms a call "
              f"({fs_in / chained:.6g} input samples/s, host clock) "
              f"({nvidia_smi_line()})")


def cli_phase(dev, counts: dict) -> None:
    """Phase 10: the resampler, the FDM bank and the command line on the
    card (``--cli`` runs it alone); adds the launches of its CLI commands
    and of ``FdmReceiver`` to ``counts``."""
    import tempfile
    t0 = time.perf_counter()
    print("phase 10a: the resampler and the FDM bank, card against CPU")
    bank_on_card(dev)
    print("phase 10b: the CLI on the card through cli.main, kernels against "
          "plain versions")
    walls = {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as root:
        for name in CLI_COMMANDS:
            cli_command(name, root, counts, walls)
    fdm_receiver_on_card(dev, counts)
    print("phase 10c: rates")
    print(f"  before: {CLOCKS} = {nvidia_smi_line(CLOCKS)}")
    bank_rates(dev)
    print(f"  after:  {CLOCKS} = {nvidia_smi_line(CLOCKS)}")
    print("  CLI wall seconds, kernel side / plain side (host clock): "
          + ", ".join(f"{n} {k:.2f} / {p:.2f}" for n, (k, p) in walls.items())
          + f" ({nvidia_smi_line()})")
    print(f"phase 10 took {time.perf_counter() - t0:.1f} s "
          f"({nvidia_smi_line()})")


def recovered(pcfg, bits, sent: dict, skip: int, label: str) -> tuple:
    """(indices of the sent packets recovered, sync, packets) of a 1-D
    stream's bits past ``skip``, the slip-tracked extractor: every
    CRC-passing payload must be one of ``sent`` (payload bytes -> index),
    bit-exact."""
    import numpy as np
    sync, rx = decode(pcfg, bits[skip:], tracked=True)
    ok, got = rx.crc_ok.cpu().numpy(), rx.payload_bits.cpu().numpy()
    found = set()
    for row in got[ok]:
        k = sent.get(np.packbits(row.astype(np.uint8)).tobytes())
        need(k is not None, f"{label}: a packet passed CRC with a payload "
             "never sent")
        found.add(k)
    return found, sync, rx


def blocks_phase(pcfg, dev, errs: dict, counts: dict, times: dict) -> None:
    """Phase 11a (``--blocks`` runs it alone): one stream received
    block-parallel (``parallel.rx_stream_blockparallel``) at full width,
    kernels only, the Costas launch counter reset before each receive;
    the Costas kernel on the blocks' own input against its plain version
    (bit-identical); the plain path on the same PCM (same sync, same
    packets, payloads bit-exact); the loss against the serial
    ``rx_stream`` on one channel; the rates.  Adds the receives' Costas
    launches and the kernel's time on the blocks' input to ``counts`` /
    ``times`` as "costas_blocks"."""
    import numpy as np
    import torch
    from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream
    from qpsk_tpu_torch.ops.cuda import costas_kernel as ck
    from qpsk_tpu_torch.parallel import blocks

    t0 = time.perf_counter()
    cfg, nframes = ModemConfig(), BLOCKS_FRAMES
    payload, _, _, pcm = loopback_pcm(cfg, pcfg, 1, nframes, seed=2111,
                                      dev=dev)
    pcm = pcm[0]
    sent = {np.packbits(row).tobytes(): k for k, row in
            enumerate(payload[0].cpu().numpy().astype(np.uint8))}
    nsamples = pcm.numel()
    print(f"  one stream of {nframes} frames ({nsamples} samples, "
          f"{nsamples / cfg.fs:.1f} s of audio), +50 Hz, 10 dB")
    _, out = rx_stream(cfg, rx_init(cfg, device=dev), pcm)
    found, sync, _ = recovered(pcfg, out.bits.reshape(-1), sent,
                               8 * pcfg.frame_bits, "serial rx_stream")
    lost_serial = nframes - len(found)
    print(f"  serial rx_stream (one channel, 8 packets skipped): sync "
          f"{int(sync.score)}/4, {len(found)} of {nframes} packets "
          f"recovered bit-exact, {lost_serial} lost")
    launched, keep = 0, None
    runs = [(nb, BLOCKS_OVERLAP) for nb in BLOCKS_NBLOCKS] + [BLOCKS_ODD]
    for nb, overlap in runs:
        label = f"{nb} blocks, overlap {overlap}"
        seen = []
        reset_launches()
        with no_plain(), recorded_costas(seen, blocks):
            sym, bits, hz = blocks.rx_stream_blockparallel(cfg, pcm, nb,
                                                           overlap)
            torch.cuda.synchronize()
        moved = kernel_launches()
        need(moved["costas"] == 1 and len(seen) == 1
             and not any(v for k, v in moved.items() if k != "costas"),
             f"{label}: launches {moved}, {len(seen)} Costas calls")
        launched += moved["costas"]
        need(bool(torch.isfinite(sym.re).all() and torch.isfinite(sym.im).all()
                  and torch.isfinite(hz).all()), f"{label}: non-finite output")
        need(tuple(bits.shape) == (nframes * 2 * cfg.symbols_per_frame,),
             f"{label}: bits of shape {tuple(bits.shape)}")
        (cs, zb, params, trace), kw = seen[0]
        body = nframes * cfg.symbols_per_frame // nb
        window = min(overlap, body) + body
        need(tuple(zb.re.shape) == (nb, window) and trace == window,
             f"{label}: the Costas input {tuple(zb.re.shape)}, trace {trace}")
        zr, zi = zb.re.T.contiguous(), zb.im.T.contiguous()
        k, p = check_costas(cs, zr, zi, params, trace, True, label, errs,
                            gear=kw.get("gear"))
        err = max(cmax_abs(k[1], p[1]), max_abs(k[2], p[2]),
                  max_abs(k[0].freq, p[0].freq),
                  max_abs(k[0].phase, p[0].phase))
        need(err == 0 and torch.equal(k[3], p[3]),
             f"{label}: the Costas kernel is {err} from its plain version")
        errs["costas_blocks"] = max(errs["costas_blocks"], err)
        if nb == BLOCKS_NBLOCKS[-1] and overlap == BLOCKS_OVERLAP:
            keep = (cs, zr, zi, params, trace)
        # the plain path: the plain Costas on the same windows
        psym, pbits, phz = blocks.rx_stream_blockparallel(
            path_cfg(cfg, "plain"), pcm, nb, overlap)
        kfound, ks, krx = recovered(pcfg, bits, sent, 0, label)
        pfound, ps, prx = recovered(pcfg, pbits, sent, 0, label + " plain")
        need((int(ks.rotation), int(ks.bit_lag)) == (int(ps.rotation),
                                                     int(ps.bit_lag))
             and torch.equal(krx.crc_ok, prx.crc_ok) and kfound == pfound,
             f"{label}: the kernel and plain paths sync or pass differently")
        need(torch.equal(bits, pbits) and cmax_abs(sym, psym) == 0
             and torch.equal(hz, phz),
             f"{label}: the kernel and plain paths' outputs differ")
        lost = nframes - len(kfound)
        mean_hz = float(hz.mean())
        # each block's loop ends within its noise of the offset; a block
        # that failed to lock would be far off
        need(abs(mean_hz - TX_OFFSET_HZ) <= 2.0
             and float((hz - TX_OFFSET_HZ).abs().max()) <= 20.0,
             f"{label}: block offsets {float(hz.min()):.2f}.."
             f"{float(hz.max()):.2f} Hz")
        if nb == BLOCKS_NBLOCKS[0]:
            need(lost <= lost_serial + nb - 1,
                 f"{label}: {lost} packets lost, the serial receive lost "
                 f"{lost_serial}: more than one a seam beyond it")
        print(f"  {label}: one Costas launch on ({nb}, {window}); the kernel "
              f"and plain paths equal (bits, symbols, offsets), sync "
              f"{int(ks.score)}/4, {len(kfound)} of {nframes} packets "
              f"recovered bit-exact, {lost} lost ({lost - lost_serial:+d} "
              f"beyond the serial receive, {nb - 1} seams); block offsets "
              f"{float(hz.min()):.3f}..{float(hz.max()):.3f} Hz, mean "
              f"{mean_hz:.4f}")
    counts["costas_blocks"] = counts.get("costas_blocks", 0) + launched
    print(f"  rates ({nvidia_smi_line()}), CUDA events:")
    st = rx_init(cfg, device=dev)
    ms = cuda_time_ms(lambda: rx_stream(cfg, st, pcm), 3, warmup=1)
    print(f"  serial rx_stream, one channel: {ms:.4f} ms/call, "
          f"{nsamples / ms * 1e3:.6g} samples/s")
    for nb in BLOCKS_NBLOCKS:
        ms_b = cuda_time_ms(lambda: blocks.rx_stream_blockparallel(
            cfg, pcm, nb, BLOCKS_OVERLAP), 10)
        print(f"  rx_stream_blockparallel, {nb} blocks: {ms_b:.4f} ms/call, "
              f"{nsamples / ms_b * 1e3:.6g} samples/s, {ms / ms_b:.1f}x the "
              f"serial receive")
        report_trace(f"rx_stream_blockparallel, {nb} blocks, under "
                     "torch.profiler", *traced(
                         lambda: blocks.rx_stream_blockparallel(
                             cfg, pcm, nb, BLOCKS_OVERLAP), 5), 5)
    cs, zr, zi, params, trace = keep
    times["costas_blocks"] = time_pair(
        "costas_blocks", ck.costas_run_tm, ck.costas_run_tm_plain,
        (cs, zr, zi, params, trace), {}, 3, 20) + costas_work(
            zr.shape[1], trace, trace)
    print(f"phase 11a took {time.perf_counter() - t0:.1f} s")


def bench_phase(dev) -> None:
    """Phase 11b: ``python -m qpsk_tpu_torch bench --suite <s>`` for every
    suite, through ``cli.main`` on the card at each suite's default sizes:
    each record names the card, has a positive finite rate, and its
    decode guard held (the suites raise otherwise; the coded suite
    decodes every packet of a call, the latency suite's packets are the
    ones sent)."""
    from qpsk_tpu_torch import benchmarks
    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    for name in benchmarks.suites():
        if name == "scaling":
            continue    # phase 12d, in its process group
        rc, out, err, wall = cli_call(["bench", "--suite", name])
        recs = [json.loads(ln) for ln in out if ln.startswith("{")]
        need(rc == 0 and recs, f"bench --suite {name}: rc {rc}, "
             f"{len(recs)} records; {err[-5:]}")
        for r in recs:
            need(r["platform"] == "gpu" and r["card"] == smi
                 and math.isfinite(r["value"]) and r["value"] > 0,
                 f"bench --suite {name}: {r}")
            if r["metric"].startswith("coded_rx"):
                need(r["packets_per_pass"] > 0, f"{name}: {r}")
            if r["metric"] == "streaming_latency":
                need(r["decoded"] >= 0.8 * r["sent"], f"{name}: {r}")
            print(f"  {json.dumps(r)}")
        print(f"  bench --suite {name}: {len(recs)} records in {wall:.1f} s")
    print(f"phase 11b took {time.perf_counter() - t0:.1f} s")


def taps_phase(dev) -> None:
    """Phase 11c: the debug taps on the card (``assert_finite`` clean and
    with an injected NaN, which raises at ``throw()`` and leaves the card
    launching kernels; ``ScatterTap``; ``trace`` writing a Chrome trace
    with the kernels' names), then each example in a subprocess on the
    card, the three at once."""
    import glob
    import tempfile

    import torch
    from qpsk_tpu_torch import ModemConfig, rx_init, rx_stream
    from qpsk_tpu_torch.utils.debug import (ScatterTap, assert_finite,
                                            checkify, trace)

    t0 = time.perf_counter()
    cfg = ModemConfig()
    pcm = noise_pcm(cfg, 256, 4, 17, dev)
    _, out = rx_stream(cfg, rx_init(cfg, (256,), device=dev), pcm)
    assert_finite(out, "clean").throw()
    bad = out.symbols.re.clone()
    bad[7, 1, 3] = float("nan")

    def fn(x):
        assert_finite(x, "x")
        return x * 2.0
    err, _ = checkify(fn)(bad)
    try:
        err.throw()
    except FloatingPointError as e:
        print(f"  assert_finite: clean rx_stream output passes; the injected "
              f"NaN raises at throw(): {e}")
    else:
        raise SmokeFailure("assert_finite missed an injected NaN")
    reset_launches()
    _, again = rx_stream(cfg, rx_init(cfg, (256,), device=dev), pcm)
    torch.cuda.synchronize()
    need(kernel_launches()["costas"] == 1
         and torch.equal(again.bits, out.bits),
         "the card does not launch kernels after the NaN check")
    tap = ScatterTap()
    tap.tap(out.symbols)
    need(tap.as_array().shape == (out.symbols.re.numel(), 2), "ScatterTap")
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root) as d:
        with trace(d):
            rx_stream(cfg, rx_init(cfg, (256,), device=dev), pcm)
            torch.cuda.synchronize()
        files = glob.glob(os.path.join(d, "trace-*.json"))
        need(len(files) == 1, f"trace wrote {files}")
        with open(files[0]) as fh:
            names = {e.get("name", "") for e in json.load(fh)["traceEvents"]
                     if e.get("cat") == "kernel"}
    need(any("costas" in n for n in names)
         and any("frontend" in n for n in names),
         f"the trace's kernels: {sorted(names)[:8]}")
    print(f"  trace: a Chrome trace with {len(names)} kernel names, the "
          f"front-end's and Costas' among them; ScatterTap took "
          f"{tap.as_array().shape[0]} points")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"qpsk_tpu_torch.examples.{name}"], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in EXAMPLES}
    for name, proc in procs.items():
        try:
            text = proc.communicate(timeout=300)[0]
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            raise SmokeFailure(f"example {name} ran past 300 s")
        need(proc.returncode == 0,
             f"example {name} exited {proc.returncode}: {text[-2000:]}")
        print(f"  example {name} on the card:")
        for line in text.strip().splitlines():
            print(f"    {line}")
    print(f"phase 11c took {time.perf_counter() - t0:.1f} s")


def gather_ranks(t):
    """``t`` of every rank, concatenated on the leading axis in rank
    order (``all_gather_into_tensor`` over NCCL)."""
    import torch.distributed as dist
    t = t.contiguous()
    out = t.new_empty((dist.get_world_size() * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t)
    return out


def ranks_max(x: float, dev) -> float:
    """The largest of the ranks' ``x``."""
    import torch
    import torch.distributed as dist
    t = torch.tensor([float(x)], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def scale_dp(cfg, pcfg, mesh, dev, rank: int, world: int, say, res: dict):
    """Phase 12b on one rank: the dp receive at full width, kernels only,
    then gates 1 and 2.  Returns (demod, state, PCM) for the rates."""
    import numpy as np
    import torch
    from qpsk_tpu_torch import rx_init, rx_stream
    from qpsk_tpu_torch.parallel.channels import (init_channels,
                                                  make_channel_demod)

    c, nframes = SCALE_DP
    total = c * world
    demod = make_channel_demod(cfg, mesh)
    t0 = time.perf_counter()
    with no_plain():
        reset_launches()
        # the global stimulus on every rank (phase 3's at world size 1)
        payload, _, _, pcm = loopback_pcm(cfg, pcfg, total, nframes,
                                          seed=2024, dev=dev)
        st0 = init_channels(cfg, total, mesh)
        _, out = demod(st0, pcm)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    moved = kernel_launches(("tx", "frontend", "costas"))
    for k, n in moved.items():
        need(n > 0, f"dp: rank {rank} never launched the {k} kernel")
        res["launches"][k] += n
    need(tuple(out.bits.shape) == (c, nframes, 2 * cfg.symbols_per_frame),
         f"dp: bits of shape {tuple(out.bits.shape)}")
    say(f"dp: {total} channels ({c} a rank) x {nframes} frames, TX -> AWGN "
        f"-> make_channel_demod in {seconds:.3f} s (host clock, first "
        f"call), kernels only; launches {moved}")
    # gate 1: the gathered outputs against one rx_stream over the whole
    # batch on rank 0's card
    bits, hz = gather_ranks(out.bits), gather_ranks(out.freq_hz)
    if rank == 0:
        _, ref = rx_stream(cfg, rx_init(cfg, (total,), device=dev), pcm)
        fd = max_abs(hz, ref.freq_hz)
        need(torch.equal(bits, ref.bits) and fd == 0,
             f"dp: the gathered receive differs from one rx_stream call "
             f"(frequency by {fd})")
        say(f"dp gate 1: the gathered bits and frequency trace of {world} "
            f"rank(s) equal one rx_stream call over all {total} channels on "
            f"rank 0's card (largest frequency difference {fd})")
    # gate 2: sync and CRC on sampled channels of this rank's block
    skip = 8 * pcfg.frame_bits
    sampled = sorted({round(i * (c - 1) / (SCALE_SAMPLED - 1))
                      for i in range(SCALE_SAMPLED)})
    npass = ntot = 0
    for ch in sampled:
        g = rank * c + ch
        sent = {np.packbits(row).tobytes(): k for k, row in
                enumerate(payload[g].cpu().numpy().astype(np.uint8))}
        found, sync, rx = recovered(pcfg, out.bits[ch].reshape(-1), sent, skip,
                                    f"dp channel {g}")
        need(int(sync.score) >= 3, f"dp channel {g}: sync {int(sync.score)}/4")
        npass += len(found)
        ntot += rx.crc_ok.numel()
    need(npass >= 0.9 * ntot, f"dp: {npass} of {ntot} packets recovered")
    say(f"dp gate 2: {len(sampled)} channels of rank {rank} synced, {npass} of "
        f"{ntot} packets pass CRC, every one a payload sent")
    return demod, st0, pcm


def scale_soft(cfg, mesh, dev, rank: int, world: int, say, res: dict) -> None:
    """Phase 12b gate 3 on one rank: the coded (conv) soft path at phase
    5b's shape a card through ``make_channel_demod``: the LLRs of the
    sharded symbols against the unsharded ones, then the soft sync hunt
    and tracked extraction through the Viterbi kernel."""
    import torch
    from qpsk_tpu_torch import rx_init, rx_stream, tx_init, tx_stream
    from qpsk_tpu_torch.channel import awgn_pcm
    from qpsk_tpu_torch.ops.modmap import demod_soft
    from qpsk_tpu_torch.packet import PacketConfig, assemble_packet
    from qpsk_tpu_torch.parallel.channels import (init_channels,
                                                  make_channel_demod)
    from qpsk_tpu_torch.sync import (default_max_lag,
                                     extract_packets_soft_tracked,
                                     find_sync_streams, rotate_soft)

    pcfg = PacketConfig(payload_bytes=30, fec="conv")
    c, npkt = SCALE_SOFT, CODED_PATH[1]
    total, fb, mfb = c * world, pcfg.frame_bits, cfg.bits_per_frame
    skip = 8 * fb
    sampled = sorted({round(i * (c - 1) / (SCALE_SOFT_SAMPLED - 1))
                      for i in range(SCALE_SOFT_SAMPLED)})
    t0 = time.perf_counter()
    with no_plain():
        reset_launches()
        gen = torch.Generator(device=dev).manual_seed(2025)
        payload = torch.randint(0, 2, (total, npkt, 8 * pcfg.payload_bytes),
                                generator=gen, device=dev, dtype=torch.int32)
        chan = assemble_packet(pcfg, payload).reshape(total, -1)
        nframes = -(-chan.shape[1] // mfb)
        filler = torch.randint(0, 2, (total, nframes * mfb - chan.shape[1]),
                               generator=gen, device=dev, dtype=torch.int32)
        frames = torch.cat([chan, filler], dim=1).reshape(total, nframes, mfb)
        _, clean = tx_stream(cfg, tx_init(cfg, (total,), device=dev), frames,
                             tx_offset_hz=TX_OFFSET_HZ)
        power = float(((clean.to(torch.float32) / cfg.pcm_scale) ** 2).mean())
        pcm = awgn_pcm(gen, clean, CODED_SNR_DB, power, cfg.pcm_scale)
        _, out = make_channel_demod(cfg, mesh)(init_channels(cfg, total, mesh),
                                               pcm)
        llrs = demod_soft(out.symbols).reshape(c, -1)
        results = []
        for ch in sampled:
            x = llrs[ch, skip:]
            rows = torch.stack([rotate_soft(x, r) for r in range(4)])
            sync = find_sync_streams(pcfg, rows, max_lag=default_max_lag(pcfg),
                                     probe_frames=8, soft=True)
            navail = (x.numel() - int(sync.bit_lag)) // fb
            results.append((sync, extract_packets_soft_tracked(pcfg, x, sync,
                                                               navail)))
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    moved = kernel_launches(("tx", "frontend", "costas", "viterbi"))
    for k, n in moved.items():
        need(n > 0, f"soft: rank {rank} never launched the {k} kernel")
        res["launches"][k] += n
    _, ref = rx_stream(cfg, rx_init(cfg, (total,), device=dev), pcm)
    ref_llrs = demod_soft(ref.symbols).reshape(total, -1)[rank * c:(rank + 1) * c]
    err = max_abs(llrs, ref_llrs)
    need(err <= 1e-5, f"soft: sharded LLRs {err} from the unsharded ones")
    nok = npk = synced = 0
    for ch, (sync, rx) in zip(sampled, results):
        synced += int(sync.score) > 0
        nok += check_payloads(rx, payload[rank * c + ch], rank * c + ch)
        npk += rx.crc_ok.numel()
    need(synced == len(sampled) and nok >= npk // 2,
         f"soft: {synced} of {len(sampled)} channels synced, {nok} of {npk} "
         "packets pass")
    say(f"soft (fec=conv, {CODED_SNR_DB} dB): {total} channels ({c} a rank) x "
        f"{npkt} packets in {seconds:.3f} s, launches {moved}; LLRs "
        f"{err:.3g} from the unsharded ones; {synced}/{len(sampled)} channels "
        f"synced, {nok} of {npk} packets pass CRC through the Viterbi "
        "kernel, every one bit-exact")


def scale_sp(cfg, pcfg, mesh, dev, rank: int, world: int, say, res: dict,
             errs: dict):
    """Phase 12c on one rank: the sp front-end against the serial one,
    the sp receive through the Costas kernel, and the plain version on a
    cut of the stream.  Returns the stream's PCM (1, frames, 512)."""
    import numpy as np
    import torch
    from qpsk_tpu_torch.modem import _tmat
    from qpsk_tpu_torch.ops import nco
    from qpsk_tpu_torch.ops import rrc as rrc_ops
    from qpsk_tpu_torch.ops.cplx import CF32
    from qpsk_tpu_torch.ops.cuda import costas_kernel as ck
    from qpsk_tpu_torch.parallel import stream

    nframes = BLOCKS_FRAMES
    payload, _, _, pcm = loopback_pcm(cfg, pcfg, 1, nframes, seed=2111,
                                      dev=dev)
    flat = pcm.reshape(-1)
    n = flat.numel()
    blk = n // world
    sent = {np.packbits(row).tobytes(): k for k, row in
            enumerate(payload[0].cpu().numpy().astype(np.uint8))}
    # the front-end against the serial mix and FIR over the whole stream
    y = stream.rx_frontend_timeparallel(cfg, flat, mesh)
    x = flat.to(torch.float32) / float(cfg.pcm_scale)
    x, _ = nco.mix(CF32(x, torch.zeros_like(x)), nco.nco_init((), dev),
                   -cfg.omega_center, "fast")
    tile = rrc_ops.pick_block(n)
    x, _ = rrc_ops.fir_block(x, rrc_ops.fir_init_tail(cfg.ntaps, (), dev),
                             _tmat(cfg, tile, dev), cfg.gain, tile)
    mine = slice(rank * blk, (rank + 1) * blk)
    fe = ranks_max(max(max_abs(y.re, x.re[mine]), max_abs(y.im, x.im[mine])),
                   dev)
    need(fe <= 2e-4, f"sp: the front-end is {fe} from the serial one")
    say(f"sp front-end: {nframes} frames ({n} samples) over {world} rank(s), "
        f"largest difference from the serial mix and FIR on one card {fe:.3g}")
    # the receive, kernels only, one Costas launch a rank
    seen = []
    with no_plain(), recorded_costas(seen, stream):
        reset_launches()
        sym, bits, hz = stream.rx_stream_timeparallel(cfg, flat, mesh)
        torch.cuda.synchronize()
    moved = kernel_launches()
    need(moved["costas"] == 1 and len(seen) == 1
         and not any(v for k, v in moved.items() if k != "costas"),
         f"sp: rank {rank} launches {moved}, {len(seen)} Costas calls")
    res["launches"]["costas_timeparallel"] += moved["costas"]
    need(bool(torch.isfinite(sym.re).all() and torch.isfinite(hz).all()),
         "sp: non-finite output")
    need(abs(float(hz[0]) - TX_OFFSET_HZ) <= 10.0,
         f"sp: rank {rank}'s loop ended at {float(hz[0])} Hz")
    found, sync, rx = recovered(pcfg, bits, sent, 0, f"sp rank {rank}")
    per_block = nframes // world
    need(len(found) >= (1.0 - SCALE_SP_LOSS) * per_block,
         f"sp: rank {rank} recovered {len(found)} of {per_block} packets")
    say(f"sp: rx_stream_timeparallel, one Costas launch on rank {rank}'s "
        f"{blk // cfg.cycles} symbols; loop at {float(hz[0]):.4f} Hz; sync "
        f"{int(sync.score)}/4, {len(found)} of its {per_block} packets "
        f"recovered bit-exact")
    # the whole chain against the same symbols as kernel calls of
    # SCALE_SP_PLAIN frames, the state carried: the length that is held
    # against the plain version below
    (cs, zc, params, trace), kw = seen[0]
    zr, zi = zc.re.T.contiguous(), zc.im.T.contiguous()
    step = SCALE_SP_PLAIN * cfg.symbols_per_frame
    with no_plain():
        whole = ck.costas_run_tm(cs, zr, zi, params, trace, gear=kw.get("gear"))
        st, parts = cs, []
        for k in range(0, trace, step):
            m = min(step, trace - k)
            st, d, f, b = ck.costas_run_tm(st, zr[k:k + m], zi[k:k + m],
                                           params, m, gear=kw.get("gear"))
            parts.append((d, b))
        torch.cuda.synchronize()
    cut_re = torch.cat([d.re for d, _ in parts])
    cut_im = torch.cat([d.im for d, _ in parts])
    wit = max([max_abs(whole[1].re, cut_re), max_abs(whole[1].im, cut_im),
               max_abs(whole[2][:, -1], f[:, -1]),
               max_abs(whole[1].re.reshape(-1), sym.re)]
              + [max_abs(a.float(), b.float()) for a, b in zip(whole[0], st)
                 if a is not None])
    need(wit == 0 and torch.equal(whole[3], torch.cat([b for _, b in parts], 1))
         and torch.equal(whole[3].reshape(-1), bits),
         f"sp: the {trace}-step Costas chain is {wit} from its {len(parts)} "
         f"calls of {step} steps")
    say(f"sp chain: the {trace}-step kernel call equals {len(parts)} chained "
        f"calls of {step} steps (symbols, bits, final state and frequency; "
        f"largest difference {wit}), and the main path's output")
    # against the plain version on SCALE_SP_PLAIN frames a rank
    cut = flat[:SCALE_SP_PLAIN * world * cfg.frame_size]
    seen = []
    with recorded_costas(seen, stream):
        ksym, kbits, khz = stream.rx_stream_timeparallel(cfg, cut, mesh)
    psym, pbits, phz = stream.rx_stream_timeparallel(path_cfg(cfg, "plain"),
                                                     cut, mesh)
    err = max(cmax_abs(ksym, psym), max_abs(khz, phz))
    need(torch.equal(kbits, pbits) and err <= 1e-4,
         f"sp: the kernel path is {err} from the plain path")
    (cs, zc, params, trace), kw = seen[0]
    zr, zi = zc.re.T.contiguous(), zc.im.T.contiguous()
    k, p = check_costas(cs, zr, zi, params, trace, True,
                        f"sp rank {rank}, {SCALE_SP_PLAIN} frames", errs,
                        gear=kw.get("gear"))
    kerr = max(cmax_abs(k[1], p[1]), max_abs(k[2], p[2]),
               max_abs(k[0].freq, p[0].freq), max_abs(k[0].phase, p[0].phase))
    need(kerr == 0 and torch.equal(k[3], p[3]),
         f"sp: the Costas kernel is {kerr} from its plain version")
    errs["costas_timeparallel"] = max(errs["costas_timeparallel"], err, kerr)
    say(f"sp plain: on {SCALE_SP_PLAIN} frames a rank the kernel and plain "
        f"paths give equal bits, symbols and loop frequency {err:.3g} apart; "
        f"the Costas kernel on the rank's {trace} symbols is {kerr} from its "
        "plain version, bits equal")
    if rank == 0:
        res["time"] = list(time_pair(
            "costas_timeparallel", ck.costas_run_tm, ck.costas_run_tm_plain,
            (cs, zr, zi, params, trace), {}, 1, 20)
            + costas_work(1, trace, trace))
    return pcm


def scale_rates(cfg, dp_run, sp_mesh, pcm, dev, say) -> None:
    """Phase 12d on one rank: the dp receive a call, the sp receive a call
    and the serial ``rx_stream`` on one channel of the same stream, by
    CUDA events, the largest over the ranks."""
    from qpsk_tpu_torch import rx_init, rx_stream
    from qpsk_tpu_torch.parallel import stream

    demod, st, pcm_dp = dp_run
    flat = pcm.reshape(-1)
    one = rx_init(cfg, device=dev)
    ms_dp = ranks_max(cuda_time_ms(lambda: demod(st, pcm_dp), 10), dev)
    ms_sp = ranks_max(cuda_time_ms(
        lambda: stream.rx_stream_timeparallel(cfg, flat, sp_mesh), 3,
        warmup=1), dev)
    ms_serial = ranks_max(cuda_time_ms(lambda: rx_stream(cfg, one, pcm[0]), 3,
                                       warmup=1), dev)
    c, nframes = SCALE_DP
    say(f"rates ({nvidia_smi_line()}), CUDA events, the largest over the "
        f"ranks: dp receive {ms_dp:.4f} ms a call ({c} channels a card x "
        f"{nframes} frames, {pcm_dp.numel() / ms_dp * 1e3:.6g} samples/s in "
        f"all); sp receive {ms_sp:.4f} ms a call ({flat.numel()} samples, "
        f"{flat.numel() / ms_sp * 1e3:.6g} samples/s); serial rx_stream on "
        f"one channel {ms_serial:.4f} ms ({flat.numel() / ms_serial * 1e3:.6g} "
        f"samples/s); sp / serial {ms_sp / ms_serial:.4f}")


def scale_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of phase 12 on card ``rank``, in the NCCL group that
    ``multihost.spawn_per_card`` started: its launches, largest
    differences and (rank 0) the Costas row's times go to
    ``tmp/rank<r>.json``."""
    import torch
    import torch.distributed as dist
    from qpsk_tpu_torch import ModemConfig
    from qpsk_tpu_torch.packet import PacketConfig
    from qpsk_tpu_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank)

    def say(msg: str) -> None:
        print(f"  [rank {rank}] {msg}" if world > 1 else f"  {msg}", flush=True)
    res = {"launches": dict.fromkeys(("frontend", "costas", "tx", "viterbi",
                                      "costas_timeparallel"), 0)}
    errs = dict.fromkeys(KERNELS, 0.0)
    say(f"rank {rank} of {world}: {dist.get_backend()} on "
        f"{nvidia_smi_line(card=rank)}")
    cfg, pcfg = ModemConfig(), PacketConfig(payload_bytes=30)
    dp = multihost.global_mesh(("dp",), device=dev)
    sp = multihost.global_mesh(("sp",), device=dev)
    dp_run = scale_dp(cfg, pcfg, dp, dev, rank, world, say, res)
    scale_soft(cfg, dp, dev, rank, world, say, res)
    pcm = scale_sp(cfg, pcfg, sp, dev, rank, world, say, res, errs)
    scale_rates(cfg, dp_run, sp, pcm, dev, say)
    res["errs"] = errs
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)


def scale_phase(errs: dict, counts: dict, times: dict) -> None:
    """Phase 12 (``--scale`` runs it alone): scale-out over every card,
    one rank a card on NCCL, spawned here; then ``bench --suite
    scaling`` through ``cli.main``, which spawns its own ranks.  Adds the
    ranks' launches to ``counts`` and the ``costas_timeparallel`` row's
    error and times."""
    import tempfile

    import torch
    from qpsk_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    print(f"  world size {world}, one rank a card; NCCL "
          f"{torch.cuda.nccl.version()}")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        multihost.spawn_per_card(scale_rank, os.path.join(tmp, "store"), tmp)
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    total = {}
    for res in ranks:
        for k, n in res["launches"].items():
            total[k] = total.get(k, 0) + n
            counts[k] = counts.get(k, 0) + n
        for k, e in res["errs"].items():
            errs[k] = max(errs[k], e)
    times["costas_timeparallel"] = tuple(ranks[0]["time"])
    print(f"  launches over the ranks: {total}")
    smi = nvidia_smi_line()
    rc, out, err, wall = cli_call(["bench", "--suite", "scaling"])
    recs = [json.loads(ln) for ln in out if ln.startswith("{")]
    need(rc == 0 and {r["mode"] for r in recs}
         == {"dp", "sp", "sp_bound", "sp_decomp"},
         f"bench --suite scaling: rc {rc}, {len(recs)} records; {err[-5:]}")
    for r in recs:
        need(r["platform"] == "gpu" and r["card"] == smi,
             f"bench --suite scaling: {r}")
        for k, v in r.items():
            if k.startswith(("time_", "throughput", "eff", "t_launch")) \
                    or k in ("t_full_s", "t_frontend_s", "t_block_s"):
                need(math.isfinite(v) and v > 0,
                     f"bench --suite scaling: {k} = {v} in {r}")
        print(f"  {json.dumps(r)}")
    print(f"  bench --suite scaling: {len(recs)} records in {wall:.1f} s")
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s "
          f"({nvidia_smi_line()})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from qpsk_tpu_torch import ModemConfig
    from qpsk_tpu_torch.ops.cuda import _lib
    from qpsk_tpu_torch.packet import PacketConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(f"card: {smi}; torch {torch.__version__} (CUDA {torch.version.cuda})")
    nvcc = subprocess.run([_lib._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[-1] if nvcc else 'unknown'}")

    print("phase 1: build")
    t0 = time.perf_counter()
    path, log = _lib.build()
    _lib.library()
    print(f"  built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())

    cfg, pcfg = ModemConfig(), PacketConfig(payload_bytes=30)
    if "--fec" in sys.argv[1:]:
        print("fec: the decoders against their plain versions")
        fec_build_lines(log)
        compare_fec(dev, dict.fromkeys(KERNELS, 0.0))
        print("fec: every kernel shape, checked and timed")
        fec_shapes(dev)
        print(smi)
        return 0
    if "--profile" in sys.argv[1:]:
        print("profile: kernel-path receive calls under torch.profiler")
        profile(cfg, dev)
        runtime_profile(dev)
        print(smi)
        return 0
    errs = dict.fromkeys(KERNELS, 0.0)
    if "--runtime" in sys.argv[1:]:
        runtime_phase(pcfg, dev, errs, {}, {})
        print(smi)
        return 0
    if "--modes" in sys.argv[1:]:
        modes_phase(pcfg, dev, errs, {})
        print(smi)
        return 0
    if "--cli" in sys.argv[1:]:
        cli_phase(dev, {})
        print(smi)
        return 0
    if "--costas" in sys.argv[1:]:
        print("phase 2c: the Costas kernel at its ragged edges")
        check_sincosf(dev)
        costas_edges(dev, errs)
        print(smi)
        return 0
    if "--scale" in sys.argv[1:]:
        print("phase 12: scale-out, one rank a card")
        scale_phase(errs, {}, {})
        print(smi)
        return 0
    if {"--blocks", "--bench"} & set(sys.argv[1:]):
        if "--blocks" in sys.argv[1:]:
            print("phase 11a: one stream, block-parallel")
            blocks_phase(pcfg, dev, errs, {}, {})
        if "--bench" in sys.argv[1:]:
            print("phase 11b: bench, every suite on the card")
            bench_phase(dev)
            print("phase 11c: the debug taps and the examples on the card")
            taps_phase(dev)
        print(smi)
        return 0
    print("phase 2: kernels against their plain versions")
    check_sincosf(dev)
    compare_kernels(cfg, pcfg, dev, errs)
    print("phase 2b: the front-end pipeline at its ragged edges")
    pipeline_edges(dev, errs)
    print("phase 2c: the Costas kernel at its ragged edges")
    costas_edges(dev, errs)
    print("phase 3: main path at full width")
    counts = main_path(cfg, pcfg, dev, errs)
    print("phase 4: rates at 8192 channels x 8 frames")
    print(f"  before: {CLOCKS} = {nvidia_smi_line(CLOCKS)}")
    times = rates(cfg, dev, errs)
    print(f"  after:  {CLOCKS} = {nvidia_smi_line(CLOCKS)}")
    print("phase 5: the coded link")
    compare_fec(dev, errs)
    for kind, name in (("conv", "viterbi"), ("ldpc", "ldpc")):
        counts[name] = coded_loopback(cfg, kind, dev, errs)
    print(f"  before: {CLOCKS} = {nvidia_smi_line(CLOCKS)}")
    times.update(coded_rates(cfg, dev, errs))
    print(f"  after:  {CLOCKS} = {nvidia_smi_line(CLOCKS)}")
    fec_build_lines(log)
    print("phase 6: the loop and channel options")
    compare_options(pcfg, dev, errs)
    for name in OPTION_PATHS:
        counts.update(option_loopback(name, pcfg, dev, errs))
    print(f"  before: {CLOCKS} = {nvidia_smi_line(CLOCKS)}")
    times.update(option_rates(dev, errs))
    print(f"  after:  {CLOCKS} = {nvidia_smi_line(CLOCKS)}")
    print("phase 7: the generic modulation family")
    compare_family(pcfg, dev, errs)
    for name in FAMILY_PATHS:
        counts.update(family_loopback(name, pcfg, dev, errs))
    for kind in ("conv", "ldpc"):
        family_coded(kind, dev, errs)
    print("phase 7e: 8PSK at 1200 baud on the composed chain")
    family_loopback("8psk_1200", pcfg, dev, errs)
    print("phase 7f: the geometries on the card")
    for name in GEOMETRY_PATHS:
        geometry_path(name, pcfg, dev, errs)
    tx_geometries(dev, errs)
    off_geometry_call(pcfg, dev)
    print(f"  before: {CLOCKS} = {nvidia_smi_line(CLOCKS)}")
    times.update(family_rates(dev, errs))
    print(f"  after:  {CLOCKS} = {nvidia_smi_line(CLOCKS)}")
    runtime_phase(pcfg, dev, errs, counts, times)
    modes_phase(pcfg, dev, errs, counts)
    cli_phase(dev, counts)
    print("phase 11a: one stream, block-parallel")
    print(f"  before: {CLOCKS} = {nvidia_smi_line(CLOCKS)}")
    blocks_phase(pcfg, dev, errs, counts, times)
    print(f"  after:  {CLOCKS} = {nvidia_smi_line(CLOCKS)}")
    print("phase 11b: bench, every suite on the card")
    bench_phase(dev)
    print("phase 11c: the debug taps and the examples on the card")
    taps_phase(dev)
    print("phase 12: scale-out, one rank a card")
    print(f"  before: {CLOCKS} = {nvidia_smi_line(CLOCKS)}")
    scale_phase(errs, counts, times)
    print(f"  after:  {CLOCKS} = {nvidia_smi_line(CLOCKS)}")

    for name in KERNELS:
        if name.startswith(("frontend", "tx")):
            print_bound(name, times[name])
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[name], "max_abs_err": errs[name],
                "ms": times[name][0], "plain_ms": times[name][1],
                "bound_ms": times[name][2], "bound_by": times[name][3],
                "library_ms": None}
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
