"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix;
``configs/<config>.json`` holds the configuration as it is run,
``traffic/<mix>.json`` the mix's parameters (and ``driver``, the module of
``drivers/`` that runs that kind of traffic), ``cells/<cell>.json`` the
limits of the cell's output check and its control (``control.py``), and
``metrics/<metric>.py`` the reader of one metric.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]          # benchmark/
ROOT = HERE.parent                                  # the checkout


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the manifest with everything it names."""

    def __init__(self, name: str, manifest_path: Path = ROOT / "BENCHMARK.json"):
        manifest = load_json(manifest_path)
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {manifest_path.name}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.config = load_json(HERE / "configs" / f"{self.entry['config']}.json")
        self.mix = load_json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        own = load_json(HERE / "cells" / f"{name}.json")
        self.limits = own["limits"]
        self.control = own.get("control", {})
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[Dict], ctx: Dict) -> Dict[str, Dict]:
    """Each metric's reader over ``ctx``; a reader that finds nothing
    returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
