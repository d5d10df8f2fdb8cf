"""What the harness finds by name: ``BENCHMARK.json`` at the checkout's root, and for each
cell the files its names point to.

- ``benchmark/workloads/<cell>.json``: the cell's configuration, traffic and chips (as
  ``BENCHMARK.json`` has them), the program's settings (``engine``) and the limits of the
  numbers that decide ``correct`` (``limits``);
- the configuration's ``file`` (``benchmark/configs/<config>.json``): the sizes as run;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters and its ``kind``, the module
  ``benchmark/traffic/<kind>.py`` that generates and serves it;
- ``benchmark/metrics/<metric>.py``: the reader of one per-layer metric.

A later change adds a configuration, a cell, a mix, a kind or a metric as new files
and entries, and edits none of these.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.configs = {c["name"]: c for c in self.bench["configs"]}
        self.cells = {w["name"]: w for w in self.bench["workloads"]}

    def cell(self, name: str) -> dict:
        """The cell's entry merged with its file; raises for a name that is not a cell."""
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: {sorted(self.cells)}")
        entry = self.cells[name]
        data = self._json("benchmark/workloads", name)
        for key in ("config", "traffic", "chips"):
            if data.get(key) != entry[key]:
                raise ValueError(f"{name}: {key} is {data.get(key)!r} in its file and {entry[key]!r} in BENCHMARK.json")
        return {**data, **entry}

    def config(self, name: str) -> dict:
        cfg = json.loads((self.root / self.configs[name]["file"]).read_text())
        return {**cfg, "name": name}

    def mix(self, traffic: str) -> dict:
        return self._json("benchmark/traffic", traffic)

    def _json(self, folder: str, name: str) -> dict:
        if not NAME.match(name):
            raise ValueError(f"{name!r} is not a name")
        return json.loads((self.root / folder / f"{name}.json").read_text())

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.bench["end_to_end"] if cell in m.get("workloads", self.cells)]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics this cell reports: those that list it, and those without a
        list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def reader(self, metric: str):
        """The module ``benchmark/metrics/<metric>.py``."""
        if not NAME.match(metric):
            raise ValueError(f"{metric!r} is not a name")
        path = self.root / "benchmark" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module


def kind(name: str):
    """The traffic kind's module, ``benchmark/traffic/<name>.py``."""
    if not re.match(r"^[A-Za-z_][A-Za-z0-9_]*$", name):
        raise ValueError(f"{name!r} is not a traffic kind")
    return importlib.import_module(f"benchmark.traffic.{name}")
