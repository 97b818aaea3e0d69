"""A cell of the benchmark, built from data: the ``workloads`` entry of
``BENCHMARK.json`` names a configuration (its ``file``) and a traffic mix
(``portbench/traffic/<name>.json`` under the same root), the mix names its
generator (``portbench/generators/<name>.py``), and the per-layer metrics
that the cell reports are read by ``portbench/metrics/<name>.py``.
Nothing here knows a cell by name, so a cell, a mix, a kind of cell or a
metric is added as files and entries.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import types

from portbench import generators

TRAFFIC = pathlib.Path("portbench", "traffic")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    gen: types.ModuleType  # the traffic's generator
    end_to_end: tuple      # the BENCHMARK.json entries this cell reports
    per_layer: tuple

    @property
    def modem(self) -> dict:
        return self.config["modem"]

    @property
    def channels(self) -> int:
        return self.gen.channels(self)

    @property
    def frames(self) -> int:
        return self.traffic["frames_per_call"]

    @property
    def samples_per_call(self) -> int:
        """Channel samples at the modem's rate one call carries, summed
        over the channels."""
        return self.channels * self.frames * self.modem["frame_size"]

    def limits(self) -> dict:
        """Each compared number's limit, from the configuration."""
        return self.config["limits"]


def _load(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _listed(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load(root: pathlib.Path, workload: str) -> Cell:
    """The cell ``workload`` of the ``BENCHMARK.json`` under ``root``."""
    bench = _load(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    traffic = _load(root / TRAFFIC / f"{entry['traffic']}.json")
    cell = Cell(name=workload, config=_load(root / conf["file"]),
                traffic=traffic, gen=generators.find(traffic["generator"]),
                end_to_end=tuple(m for m in bench["end_to_end"]
                                 if _listed(m, workload)),
                per_layer=tuple(m for m in bench["per_layer"]
                                if _listed(m, workload)))
    cell.gen.check(cell)
    return cell
