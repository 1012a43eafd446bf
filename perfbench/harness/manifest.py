"""`BENCHMARK.json` and the files each of its names leads to.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by name:

* ``configs[].file``: the deployment. Its ``kind`` names the module that
  sets up and drives a run (``perfbench/kinds/<kind>.py``), its
  ``pattern`` the module that makes the problems
  (``perfbench/patterns/<pattern>.py``);
* ``perfbench/traffic/<traffic>.json``: the mix. Its ``discipline`` names
  the loop that offers the work (``perfbench/disciplines/<discipline>.py``);
* ``perfbench/limits/<workload>.json``: the limits of the cell's
  correctness numbers, with the readings they were set from;
* ``perfbench/metrics/<metric>.py``, or ``<base>.py`` for a metric named
  ``<base>.<suffix>``: the reader of a per-layer metric.

Each module states the keys it reads, and a configuration or mix that
holds a key no module reads is refused, so no key looks like a setting
that changes nothing: what only describes goes under ``about``. So a later
cell, configuration, mix or metric is new files and new entries, never an
edit.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

__all__ = ["CONFIG_NOTES", "PERFBENCH", "ROOT", "TRAFFIC_NOTES", "Cell", "check_names", "load", "reader"]

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
#: keys of a configuration or a mix that describe and set nothing
CONFIG_NOTES = frozenset({"name", "source", "about", "reduced", "assumed"})
TRAFFIC_NOTES = frozenset({"about"})


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def reader(name: str, root: Path = ROOT):
    """The ``read(records)`` function of per-layer metric ``name``."""
    base = root / "perfbench" / "metrics"
    path = base / f"{name}.py"
    if not path.exists():
        path = base / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(metric: dict, workload: str, e2e_names: set[str] | None = None) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def _module(folder: str, name: str):
    """``perfbench/<folder>/<name>.py``, imported."""
    if not NAME.match(name) or "." in name:
        raise ValueError(f"{name!r} is no module name of perfbench/{folder}")
    return importlib.import_module(f"perfbench.{folder}.{name}")


def _keys(what: str, data: dict, read: frozenset, notes: frozenset) -> None:
    unread = set(data) - read - notes
    if unread:
        raise ValueError(f"{what}: no module reads {sorted(unread)}; move what only describes under 'about'")
    missing = read - set(data)
    if missing:
        raise ValueError(f"{what}: lacks {sorted(missing)}")


class Cell:
    """One entry of ``workloads`` with its configuration, traffic, limits,
    the modules that run it and the metrics it reports."""

    def __init__(self, manifest: dict, workload: str, root: Path = ROOT):
        entries = {w["name"]: w for w in manifest["workloads"]}
        if workload not in entries:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(entries)}")
        self.entry = entries[workload]
        self.name = workload
        configs = {c["name"]: c for c in manifest["configs"]}
        config_file = configs[self.entry["config"]]["file"]
        traffic_file = f"perfbench/traffic/{self.entry['traffic']}.json"
        self.config = _json(root / config_file)
        self.traffic = _json(root / traffic_file)
        self.limits = _json(root / "perfbench" / "limits" / f"{workload}.json")
        self.kind = _module("kinds", self.config["kind"])
        self.pattern = _module("patterns", self.config["pattern"])
        self.discipline = _module("disciplines", self.traffic["discipline"])
        if self.discipline.KIND != self.config["kind"]:
            raise ValueError(f"{workload}: discipline {self.traffic['discipline']!r} drives {self.discipline.KIND} "
                             f"cells, the configuration is of kind {self.config['kind']!r}")
        _keys(config_file, self.config, frozenset({"kind", "pattern"}) | self.kind.CONFIG_KEYS | self.pattern.KEYS,
              CONFIG_NOTES)
        _keys(traffic_file, self.traffic, frozenset({"discipline"}) | self.kind.TRAFFIC_KEYS | self.discipline.KEYS,
              TRAFFIC_NOTES)
        from perfbench.reference.spar_sink import COSTS

        if self.config["cost"] not in COSTS:
            raise ValueError(f"{config_file}: cost {self.config['cost']!r}; the reference judges {COSTS}")
        self.kind.check(self)
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in manifest["end_to_end"] if _applies(m, workload)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"] if _applies(m, workload, e2e)]


def check_names(manifest: dict) -> list[str]:
    """Every name and unit against the allowed characters; returns the faults."""
    faults = []
    names = [c["name"] for c in manifest["configs"]]
    for w in manifest["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    for c in manifest["configs"]:
        names += list(c["reduced"])
    for group in ("end_to_end", "per_layer"):
        for m in manifest[group]:
            names.append(m["name"])
            if not UNIT.match(m["unit"]):
                faults.append(f"unit {m['unit']!r} of {m['name']}")
    faults += [f"name {n!r}" for n in names if not NAME.match(n)]
    return faults
