"""A stand-in for the port's kernel library in the CPU tests: a wrapper's
launch goes through ``_lib.launch`` and ``_lib.check`` as on the card, but
the C entry it calls only records its name and arguments.  ``named`` reads
a recorded call's arguments by the names the C entry gives them
(``qpsk_tpu_torch/csrc/*.cu``)."""

from qpsk_tpu_torch.ops.cuda import _lib

_FRONTEND = ("pcm", "tail_re", "tail_im", "p0_re", "p0_im", "dd_re", "dd_im",
             "zr", "zi", "index", "ndd_re", "ndd_im", "power", "scratch",
             "nph_re", "nph_im", "ntail_re", "ntail_im", "C", "F", "fsz",
             "cycles", "ntaps", "tm", "blocks", "taps_re", "taps_im",
             "omega", "gain", "inv_scale", "stream")
ARGS = {
    "qpsk_frontend_pipe": _FRONTEND,
    "qpsk_frontend_gen": _FRONTEND,
    "qpsk_costas_tm": ("zr", "zi", "phase0", "freq0", "lev0", "locked0",
                       "gains", "outr", "outi", "ftrace", "phase_out",
                       "freq_out", "lev_out", "locked_out", "bits", "T", "C",
                       "trace_every", "nsf", "det", "params", "dd", "stream"),
    "qpsk_tx": ("sym_re", "sym_im", "tail_re", "tail_im", "p0_re", "p0_im",
                "pcm", "nph_re", "nph_im", "ntail_re", "ntail_im", "C", "S",
                "cycles", "ntaps", "taps_host", "omega", "gain", "pcm_scale",
                "stream"),
    "qpsk_tx_gen": ("sym_re", "sym_im", "tail_re", "tail_im", "p0_re",
                    "p0_im", "taps", "pcm", "nph_re", "nph_im", "ntail_re",
                    "ntail_im", "C", "S", "cycles", "ntaps", "omega", "gain",
                    "pcm_scale", "stream"),
}


class Recorder:
    """Records the C entry called and its arguments, launches nothing,
    returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("qpsk_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


def recorder(monkeypatch, sms: int = 132) -> Recorder:
    """A ``Recorder`` in place of the kernel library, on a card of ``sms``
    SMs whose current stream is 0."""
    rec = Recorder()
    monkeypatch.setattr(_lib, "library", lambda: rec)
    monkeypatch.setattr(_lib, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(_lib, "sm_count", lambda dev: sms)
    return rec


def named(name: str, args: tuple) -> dict:
    """The arguments of a recorded call of the C entry ``name`` by name."""
    names = ARGS[name]
    assert len(names) == len(args) == len(_lib._SIGNATURES[name]), name
    return dict(zip(names, args))


def routed(monkeypatch, launch, sms: int = 132):
    """(C entry, its arguments by name, the launches ``_lib.launches``
    counted) of the one launch that calling ``launch`` makes through a
    ``Recorder``."""
    rec = recorder(monkeypatch, sms)
    before = dict(_lib.launches)
    launch()
    (name, args), = rec.calls
    moved = {k: n - before.get(k, 0) for k, n in _lib.launches.items()
             if n != before.get(k, 0)}
    return name, named(name, args), moved
