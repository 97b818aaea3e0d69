"""Helpers of the CLI and IO tests (``tests/test_torch_cli*.py``,
``tests/test_torch_io.py``): one in-process call of the JAX package's CLI
or of the port's (with ``--device cpu``), the comparison a noiseless
``loopback`` record is held to, and a guarded first load of the JAX
package's native IO library."""

import fcntl
import json
import pathlib

from qpsk_tpu import cli as jcli
from qpsk_tpu_torch import cli as tcli

_LOCK = pathlib.Path(tcli.__file__).resolve().parent / "_build" / "jax_io.lock"


def load_jax_io():
    """Load (and, the first time, build) the JAX package's native IO
    library under an exclusive lock shared by the test processes: its
    loader builds in place behind a per-process lock only, so two test
    workers that first need it at once could otherwise load a half-written
    library."""
    from qpsk_tpu.io import native
    _LOCK.parent.mkdir(exist_ok=True)
    with open(_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return native.load()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def run(capsys, mod, argv):
    """(rc, stdout lines, stderr lines) of one in-process CLI call; the
    port's runs get ``--device cpu``."""
    extra = ["--device", "cpu"] if mod is tcli else []
    rc = mod.main(argv + extra)
    cap = capsys.readouterr()
    return rc, cap.out.strip().splitlines(), cap.err.strip().splitlines()


def records(lines):
    return [json.loads(ln) for ln in lines]


def loopback_both(capsys, argv):
    """The JSON record of the JAX CLI's and of the port's ``loopback``."""
    out = []
    for mod in (jcli, tcli):
        rc, lines, _ = run(capsys, mod, ["loopback"] + argv)
        assert rc == 0, (mod.__name__, argv)
        (rec,) = records(lines)
        out.append(rec)
    return out


def assert_same_link(j, t):
    """The decisions equal, the estimates close, and the link clean."""
    for key in ("frames", "snr_db", "offset_hz", "per", "sync_score",
                "packets", "sync_rotation_deg"):
        assert t[key] == j[key], (key, t[key], j[key])
    assert abs(t["detected_offset_hz"] - j["detected_offset_hz"]) <= 0.05
    assert abs(t["evm_rms"] - j["evm_rms"]) <= 1e-3
    assert abs(t["est_snr_db"] - j["est_snr_db"]) <= 0.1
    assert t["per"] == 0.0 and t["sync_score"] >= 3
