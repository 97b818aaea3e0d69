"""A run whose timed path is broken underneath comes out not correct: a
call that returns its state unchanged, half of the channels left out, an
answer altered where it is produced.  (A cell on one card has no exchange
between chips to leave out.)"""

import time

import pytest
import torch

from portbench import harness


class Broken:
    """The system under test with ``fault`` applied to each call's
    (state in, state out, outputs)."""

    def __init__(self, system, fault):
        self.system, self.fault = system, fault

    def init(self):
        return self.system.init()

    def view(self, state, out=None):
        return self.system.view(state, out)

    def call(self, state, x):
        new, out = self.system.call(state, x)
        return self.fault(state, new, out)


def stale(state, new, out):
    return state, out


def half(state, new, out):
    rx = out["rx"]
    c = rx.bits.shape[0] // 2
    zero = [rx.symbols.re, rx.symbols.im, rx.bits]
    for t in zero:
        t[c:] = 0
    return new, out


def flip_bit(state, new, out):
    rx = out["rx"]
    k = int(torch.argmax(rx.symbols.im.abs().reshape(-1)))
    rx.bits.reshape(-1)[2 * k] ^= 1
    return new, out


def flip_payload(state, new, out):
    out["packets"].payload_bits[0, 0] ^= 1
    return new, out


def alter_pcm(state, new, out):
    out["chans"][1, 100] += 40
    return new, out


CASES = [("qpsk2400.tiny", stale), ("qpsk2400.tiny", half),
         ("qpsk2400.tiny", flip_bit), ("qpsk2400-conv.tinycoded", stale),
         ("qpsk2400-conv.tinycoded", flip_payload),
         ("qpsk2400.tinyfdm", alter_pcm), ("qpsk2400.tinyfdm", half)]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__}" for w, f in CASES])
def test_broken_program_is_not_correct(tiny_root, workload, fault):
    res = harness.run(tiny_root, workload, 17, 0.2, False,
                      torch.device("cpu"), time.perf_counter(),
                      wrap=lambda s: Broken(s, fault))
    assert res["correct"] is False, res["checks"]
    assert res["failed"] >= 1
