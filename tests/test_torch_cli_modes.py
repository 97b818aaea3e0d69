"""The port's ``loopback`` against the JAX CLI's on the noiseless link
(``--device cpu``, in process) for multi-frame packets, the LDPC code and
8PSK: the same decisions, the estimates close (``torch_cli_common
.assert_same_link``)."""

import pytest
import torch

from torch_cli_common import assert_same_link, loopback_both

torch.set_num_threads(2)


@pytest.mark.parametrize("argv", [
    ["--frames", "20", "--payload-bytes", "64"],
    ["--frames", "16", "--fec", "ldpc"],
    ["--frames", "20", "--modulation", "8psk", "--offset-hz", "30"],
], ids=["payload64", "ldpc", "8psk"])
def test_noiseless_loopback_modes_match_jax(capsys, argv):
    assert_same_link(*loopback_both(capsys, argv))
