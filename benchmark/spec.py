"""`BENCHMARK.json` and the files it names, found by name:

- a configuration: `configs/<config>.json`;
- a traffic mix: `traffic/<traffic>.json`;
- a cell's limits for its check: `workloads/<cell>.json`;
- a per-layer metric's reader: `metrics/<metric>.py`, whose `read(r)` takes
  the traced run's readings and returns the number, or None where it finds
  nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: List[dict]  # the cell's end-to-end metrics, as BENCHMARK.json gives them
    per_layer: List[dict]  # the cell's per-layer metrics


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: {sorted(cells)})")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name, _json(HERE / "configs" / f"{w['config']}.json"), _json(HERE / "traffic" / f"{w['traffic']}.json"),
                _json(HERE / "workloads" / f"{name}.json"), int(w["chips"]), e2e, layer)


def reader(metric: str) -> Callable:
    """The `read` function of `metrics/<metric>.py`."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_all(metrics: List[dict], readings) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader finds something."""
    out = {}
    for m in metrics:
        v: Optional[float] = reader(m["name"])(readings)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
