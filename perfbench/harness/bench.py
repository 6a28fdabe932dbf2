"""What a cell is, found by name from ``BENCHMARK.json``.

The harness holds nothing of any one configuration, mix or metric: a
cell names its configuration (``perfbench/configs/<config>.json``) and
its mix (``perfbench/traffic/<traffic>.json``); its comparison limits
sit in ``perfbench/limits/<workload>.json``; each metric is read by
``perfbench/metrics/<metric>.py``'s ``read(run)``. A later cell adds
files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "perfbench"


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One ``workloads`` entry of ``BENCHMARK.json`` with its files."""

    def __init__(self, name: str):
        self.bench = load_json(ROOT / "BENCHMARK.json")
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            known = ", ".join(w["name"] for w in self.bench["workloads"])
            raise KeyError(f"no workload {name!r} (known: {known})")
        self.entry = found[0]
        self.name = name
        self.chips = int(self.entry["chips"])
        entry = self.entry
        self.config = load_json(HERE / "configs" / f"{entry['config']}.json")
        self.mix = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
        self.limits = load_json(HERE / "limits" / f"{name}.json")

    def end_to_end(self) -> List[Dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if name_in(self.name, m.get("workloads"))]

    def per_layer(self) -> List[Dict]:
        """The per-layer metrics this cell reports: those that list it,
        and those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


def name_in(name: str, names: Optional[List[str]]) -> bool:
    return names is None or name in names


_readers: Dict[str, Callable] = {}


def reader(metric: str) -> Callable:
    """``perfbench/metrics/<metric>.py``'s ``read``."""
    if metric not in _readers:
        path = HERE / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _readers[metric] = mod.read
    return _readers[metric]


def read_metrics(metrics: List[Dict], run) -> Dict[str, Dict]:
    """Each metric's reading, ``{"value", "unit"}``; a reader that finds
    nothing to read returns None and its metric is left out."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
