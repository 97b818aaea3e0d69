"""On the card: one short run of each repository cell through the command,
its result line well formed and correct.  Skips without a card."""

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import REPO

pytestmark = pytest.mark.card
WORKLOADS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", workload,
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu"
