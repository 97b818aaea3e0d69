"""qpsk_tpu_torch — the QPSK packet modem in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of ``qpsk_tpu`` (JAX on a TPU), which stays the reference.  This
package covers the coherent link: packets -> ``tx_stream`` -> int16 PCM ->
``rx_stream`` -> sync -> packets, uncoded or coded (``PacketConfig(fec=
"conv" | "ldpc")``, soft sync and the tracked soft extractors), for QPSK
with the AGC, the gear-shift loop, the CMA equalizer and 1200 baud, and
for the generic family (``ModemConfig(modulation="bpsk" | "8psk" |
"16qam")``), whose receive starts with FFT carrier acquisition:
``modem.rx_acquire_hz`` -> ``rx_init(acq_freq=...)`` -> ``rx_stream`` ->
``sync.find_sync(..., modulation=...)``.  ``StreamDemodulator`` and
``StreamModulator`` (``runtime.py``) are the push-mode objects a
deployment runs: PCM of any chunk size in, packets out, with acquisition,
sync, slip tracking, squelch, soft FEC and checkpoints.  It imports torch
and numpy, never jax.
"""

from qpsk_tpu_torch.config import ModemConfig, config_2400
from qpsk_tpu_torch.modem import rx_stream, tx_stream
from qpsk_tpu_torch.runtime import StreamDemodulator, StreamModulator
from qpsk_tpu_torch.state import RxState, TxState, rx_init, tx_init

__version__ = "0.1.0"
