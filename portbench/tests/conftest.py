"""Fixtures of the benchmark's tests: a checkout root holding tiny cells
of each generator (4 channels, or an 8-slot FDM bank of 3 subchannels)
built from the real configuration files, which the harness runs on the
CPU through the program's plain PyTorch versions; and ``card``, for the
tests that need the NVIDIA card.  Run them with
``python -m pytest portbench/tests``."""

from __future__ import annotations

import json
import pathlib
import shutil

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
TINY = {"name": "tiny", "generator": "circular_link", "channels": 4,
        "frames_per_call": 8, "period_calls": 3, "offset_hz": 50.0,
        "offset_spread_hz": 25.0, "warmup_calls": 1, "judge_channels": 4}
TINY_CODED = dict(TINY, name="tinycoded", generator="coded_link")
TINY_FDM = {"name": "tinyfdm", "generator": "fdm_link",
            "fdm": {"nslots": 8, "fs": 9600.0, "taps_per_branch": 16,
                    "beta": 8.0},
            "frames_per_call": 8, "period_calls": 3, "offset_hz": 50.0,
            "offset_spread_hz": 25.0, "warmup_calls": 1, "judge_channels": 3}
CELLS = {"qpsk2400.tiny": ("qpsk2400", "tiny"),
         "qpsk2400-conv.tinycoded": ("qpsk2400-conv", "tinycoded"),
         "qpsk2400.tinyfdm": ("qpsk2400", "tinyfdm")}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs the NVIDIA card (skips without one)")


def write_root(root: pathlib.Path, cells: dict = CELLS,
               traffic: tuple = (TINY, TINY_CODED, TINY_FDM)
               ) -> pathlib.Path:
    """A checkout root: BENCHMARK.json with ``cells`` (name -> (config,
    traffic)) and every configuration file of the repository, and
    ``traffic``."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "portbench" / "configs").mkdir(parents=True, exist_ok=True)
    (root / "portbench" / "traffic").mkdir(parents=True, exist_ok=True)
    bench["configs"] = []
    for path in sorted((REPO / "portbench" / "configs").glob("*.json")):
        rel = path.relative_to(REPO)
        shutil.copy(path, root / rel)
        bench["configs"].append({"name": path.stem, "file": str(rel)})
    for t in traffic:
        (root / "portbench" / "traffic" / f"{t['name']}.json").write_text(
            json.dumps(t))
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                           "why": "a tiny cell of the CPU tests"}
                          for n, (c, t) in cells.items()]
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> pathlib.Path:
    return write_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the NVIDIA card")
    return torch.device("cuda", 0)
