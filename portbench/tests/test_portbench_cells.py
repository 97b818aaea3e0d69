"""The harness builds a cell from data found by name, and takes a cell
added as new files and entries, its generator among them, with no edit to
a file it has."""

import json
import time

import pytest
import torch

from portbench import generators, harness
from portbench.cell import load
from portbench.tests.conftest import REPO, TINY, write_root

# a new kind of cell, as a file of its own: circular_link's links, every
# channel's symbols the same
NEW_GENERATOR = '''
import torch

from portbench import stimulus
from portbench.generators import circular_link
from portbench.generators.circular_link import (Control, System, channels,
                                                check, numbers)


def make(cell, seed, device):
    gen, hz, out = circular_link.start(cell, seed, device)
    row = torch.randint(0, 4, (1, circular_link.period_symbols(cell)),
                        generator=gen, device=device, dtype=torch.uint8)
    pcm = stimulus.channel_pcm(gen, cell.modem,
                               row.expand(cell.channels, -1), hz,
                               cell.config["snr_db"])
    out["judged"] = circular_link.draw_judged(cell, gen, device)
    out["calls"] = circular_link.split_calls(cell, pcm)
    return out
'''


def test_repository_cells_load():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = load(REPO, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert cell.gen.__name__.endswith(cell.traffic["generator"])
        assert {m["name"] for m in cell.end_to_end} == {"rx_samples_per_s",
                                                        "setup_s"}
        assert cell.per_layer
        assert set(cell.limits()) >= {"symbols_gap", "state_gap",
                                      "bits_wrong"}


def test_each_metric_has_its_reader():
    from portbench.metrics import reader
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        mod = reader(m["name"])
        assert mod.MOVES == m["moves"]
        assert mod.LAYER == m["layer"]


def test_cell_added_as_files_runs(tmp_path, monkeypatch):
    gens = tmp_path / "more_generators"
    gens.mkdir()
    (gens / "same_symbols.py").write_text(NEW_GENERATOR)
    monkeypatch.setattr(generators, "__path__",
                        [*generators.__path__, str(gens)])
    new = dict(TINY, name="tiny2", generator="same_symbols", channels=3,
               judge_channels=2)
    root = write_root(tmp_path / "checkout",
                      {"qpsk2400.tiny2": ("qpsk2400", "tiny2")}, (new,))
    cell = load(root, "qpsk2400.tiny2")
    assert cell.channels == 3 and cell.gen.__name__.endswith("same_symbols")
    res = harness.run(root, "qpsk2400.tiny2", 7, 0.2, False,
                      torch.device("cpu"), time.perf_counter())
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"rx_samples_per_s", "setup_s"}


def test_unknown_generator_is_refused(tmp_path):
    bad = dict(TINY, name="bad", generator="nope")
    root = write_root(tmp_path, {"qpsk2400.bad": ("qpsk2400", "bad")},
                      (bad,))
    with pytest.raises(ValueError):
        load(root, "qpsk2400.bad")


@pytest.mark.parametrize("config,generator", [
    ("qpsk2400-conv", "circular_link"), ("qpsk2400-conv", "fdm_link"),
    ("qpsk2400", "coded_link")])
def test_generator_refuses_a_configuration_it_does_not_drive(
        tmp_path, config, generator):
    mix = dict(TINY, name="mix", generator=generator,
               fdm={"nslots": 8, "fs": 9600.0, "taps_per_branch": 16,
                    "beta": 8.0})
    root = write_root(tmp_path, {"c.mix": (config, "mix")}, (mix,))
    with pytest.raises(ValueError):
        load(root, "c.mix")
