"""Debug and observability taps (port of ``qpsk_tpu.utils.debug``).

The reference's only observability is a scatter-point stream on stderr
behind ``-DTEST_SCATTER`` (qpsk.c:199-201).  Here:

* ``assert_finite`` / ``checkify``: a NaN/Inf guard over a tree of
  tensors that neither synchronises nor asserts on the device.  Each call
  records one device flag a leaf; ``throw()`` reads them all at once and
  raises, as ``checkify``'s ``err.throw()`` does in the JAX package.  (A
  device-side assert, ``torch._assert_async``, would leave the CUDA
  context unusable once it fired.)
* ``eager_assert_finite``: the same check on the host, at once.
* ``ScatterTap``: the constellation tap, a host list of the symbols each
  ``tap`` call copies out.
* ``trace``: a ``torch.profiler`` capture around a region, written as a
  Chrome trace into a directory.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import Iterator

import numpy as np
import torch

from qpsk_tpu_torch.ops.cplx import CF32


def _leaves(tree) -> list:
    """The tensors of a tree of tuples, named tuples, lists and dicts (None
    and other values skipped), in order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


class FiniteError:
    """The flags ``assert_finite`` recorded: one device boolean a checked
    leaf, True where every value is finite.  ``throw()`` reads them (one
    copy to the host) and raises ``FloatingPointError`` naming the first
    leaf that held a NaN or an Inf."""

    def __init__(self):
        self.flags: list = []

    def throw(self) -> None:
        if not self.flags:
            return
        ok = torch.stack([f.to(self.flags[0][2].device)
                          for _, _, f in self.flags]).cpu()
        for (name, i, _), good in zip(self.flags, ok.tolist()):
            if not good:
                raise FloatingPointError(
                    f"non-finite values in {name}[leaf {i}]")


_local = threading.local()


def _collectors() -> list:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def checkify(fn):
    """Wrap ``fn`` so that its ``assert_finite`` calls record their flags
    instead of returning them: the wrapped call returns ``(err, out)``,
    and ``err.throw()`` raises if any check failed."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        err = FiniteError()
        _collectors().append(err)
        try:
            out = fn(*args, **kwargs)
        finally:
            _collectors().pop()
        return err, out
    return wrapped


def assert_finite(tree, name: str = "value") -> FiniteError:
    """Record, for each floating-point leaf of ``tree``, whether all its
    values are finite, without a sync: into the innermost ``checkify``
    call, else into a fresh ``FiniteError``.  Returns that error; its
    ``throw()`` raises."""
    stack = _collectors()
    err = stack[-1] if stack else FiniteError()
    for i, leaf in enumerate(_leaves(tree)):
        if leaf.is_floating_point():
            err.flags.append((name, i, torch.isfinite(leaf).all()))
    return err


def eager_assert_finite(tree, name: str = "value") -> None:
    """Host-side finite check (copies each leaf to the host; for tests and
    debugging)."""
    for i, leaf in enumerate(_leaves(tree)):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(f"non-finite values in {name}[leaf {i}]")


class ScatterTap:
    """Collects constellation points on the host: the port's version of the
    reference's stderr scatter stream (qpsk.c:199-201).  Each ``tap`` copies
    the symbols out, which waits for the device."""

    def __init__(self):
        self.points: list[np.ndarray] = []

    def tap(self, symbols: CF32) -> None:
        self.points.append(np.stack(
            [symbols.re.detach().reshape(-1).cpu().numpy(),
             symbols.im.detach().reshape(-1).cpu().numpy()], -1))

    def as_array(self) -> np.ndarray:
        return (np.concatenate(self.points, 0)
                if self.points else np.zeros((0, 2), np.float32))


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` capture around a code region (the card's kernels
    too, when there is one), written as a Chrome trace
    ``trace-<pid>-<ns>.json`` into ``logdir``."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
