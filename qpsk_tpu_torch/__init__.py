"""qpsk_tpu_torch — the QPSK packet modem in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of ``qpsk_tpu`` (JAX on a TPU), which stays the reference.  This
package runs every ``ModemConfig`` the JAX package accepts: packets ->
``tx_stream`` -> int16 PCM -> ``rx_stream`` -> sync -> packets, uncoded or
coded (``PacketConfig(fec="conv" | "ldpc")``, soft sync and the tracked
soft extractors; DQPSK decodes hard input), for QPSK and DQPSK
(``differential=True``) with the AGC, the gear-shift loop, the CMA
equalizer, 1200 baud and the four timing modes, parity with the C
reference (``config_parity()``: the exact NCO and FIR, histogram timing,
the reference slicer, through the per-frame ``rx_frame``), and for the
generic family (``ModemConfig(modulation="bpsk" | "8psk" | "16qam")``),
whose receive starts with FFT carrier acquisition:
``modem.rx_acquire_hz`` -> ``rx_init(acq_freq=...)`` -> ``rx_stream`` ->
``sync.find_sync(..., modulation=...)``.  ``StreamDemodulator`` and
``StreamModulator`` (``runtime.py``) are the push-mode objects a
deployment runs: PCM of any chunk size in, packets out, with acquisition,
sync, slip tracking, squelch, soft FEC and checkpoints.  It imports torch
and numpy, never jax.
"""

from qpsk_tpu_torch.config import (ModemConfig, config_1200, config_2400,
                                   config_parity)
from qpsk_tpu_torch.modem import (rx_acquire_hz, rx_frame, rx_stream,
                                  tx_bits_frame, tx_frame, tx_stream)
from qpsk_tpu_torch.runtime import StreamDemodulator, StreamModulator
from qpsk_tpu_torch.state import RxState, TxState, rx_init, tx_init

__version__ = "0.1.0"
