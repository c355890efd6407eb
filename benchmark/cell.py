"""A cell of the benchmark, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix; each has a file of its own under this directory:

- ``configs/<config>.json``: the published yml as it is run (``config``),
  its source, the keys changed from it (``reduced``) and those set where
  the source says nothing (``assumed``), the synthetic images, and the
  model FLOPs of one step at the configuration's batch, with R1 and
  without it
- ``traffic/<traffic>.json``: the keys the mix sets on top (``mixed16``,
  ``r1_interval``, ``use_mpi``), the ranks it runs on and why
- ``limits/<workload>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from

A later cell adds files; it edits none.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    workload: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict[str, Any]  # the yml keys as run, the traffic's keys applied
    meta: Dict[str, Any]  # the configuration file's other keys
    traffic: Dict[str, Any]
    limits: Dict[str, float]

    @property
    def ranks(self) -> int:
        return int(self.traffic.get("ranks", 1))

    @property
    def batch(self) -> int:
        return int(self.config["batchsize"])

    @property
    def local_batch(self) -> int:
        return self.batch // self.ranks

    @property
    def architecture(self):
        """The configuration's ``reference/<generator_architecture>.py`` (``reference/step.py``)."""
        from .reference.step import architecture

        return architecture(self.config)

    @property
    def precision(self) -> str:
        return "bf16" if self.config.get("mixed16") else "f32"

    @property
    def flops_per_step(self) -> float:
        """Model FLOPs a step, the mean over the R1 cycle: R1 on one step of
        every ``r1_interval``."""
        counts = self.meta["flops_per_step"]
        k = int(self.config.get("r1_interval") or 1)
        return counts["with_r1"] if k == 1 else (counts["with_r1"] + (k - 1) * counts["without_r1"]) / k

    @property
    def image_px(self) -> int:
        return int(self.meta["images"]["px"])


def _read(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark_json(root: Path = ROOT) -> Dict[str, Any]:
    return _read(root / "BENCHMARK.json")


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its files."""
    spec = next((w for w in benchmark_json(root)["workloads"] if w["name"] == workload), None)
    if spec is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    return make_cell(workload, spec["config"], spec["traffic"], int(spec["chips"]))


def make_cell(workload: str, config_name: str, traffic_name: str, chips: int) -> Cell:
    meta = _read(HERE / "configs" / f"{config_name}.json")
    traffic = _read(HERE / "traffic" / f"{traffic_name}.json")
    limits_path = HERE / "limits" / f"{workload}.json"
    limits = _read(limits_path)["limits"] if limits_path.exists() else {}
    config = dict(meta["config"])
    config.update(traffic.get("keys", {}))
    if config["batchsize"] % (2 * int(traffic.get("ranks", 1))):
        raise ValueError(f"{workload}: batch {config['batchsize']} does not split into even batches of "
                         f"{traffic.get('ranks', 1)} ranks")
    return Cell(workload, config_name, traffic_name, chips, config, meta, traffic, limits)
