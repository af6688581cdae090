"""Find a cell's configuration, traffic, traffic kind and metrics by name.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own under ``portbench/``, found by the
names in ``BENCHMARK.json``:

* ``BENCHMARK.json``'s ``configs[].file``: the configuration as it is run
  (JSON); its ``"reference"`` names the plain reference
  ``portbench/references/<reference>.py``;
* ``portbench/traffic/<traffic>.json``: the traffic's parameters; its
  ``"kind"`` names the module ``portbench/kinds/<kind>.py`` that runs it;
* ``portbench/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(ctx) -> float | None``.

A later cell, mix or metric is a new file and a new entry; no file here
changes for it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

PACKAGE = "portbench"
_LOADED: Dict[Path, Any] = {}


def load_module(root: Path, folder: str, name: str):
    """``<root>/portbench/<folder>/<name>.py`` as a module, loaded once per
    path (names may hold dots and dashes, so it is loaded from its path)."""
    path = (Path(root) / PACKAGE / folder / f"{name}.py").resolve()
    if path in _LOADED:
        return _LOADED[path]
    if not path.is_file():
        raise LookupError(f"no {folder[:-1]} file {path}")
    mod_name = f"{PACKAGE}_{folder}_{len(_LOADED)}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    _LOADED[path] = mod
    return mod


@dataclasses.dataclass
class Cell:
    """One workload with everything it names, loaded."""

    root: Path
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self):
        return load_module(self.root, "kinds", self.traffic["kind"])

    def reference(self):
        return load_module(self.root, "references", self.config["reference"])


def _applies(metric: dict, cell: str, reported: Optional[set] = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise LookupError(f"no workload {workload!r} in BENCHMARK.json; "
                          f"known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic_path = root / PACKAGE / "traffic" / f"{w['traffic']}.json"
    traffic = json.loads(traffic_path.read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, workload, reported)]
    return Cell(root=root, name=workload, chips=int(w["chips"]),
                config=config, traffic=traffic, end_to_end=e2e,
                per_layer=layer)


def read_layer_metrics(cell: Cell, ctx) -> Dict[str, dict]:
    """Each per-layer metric of the cell, from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = load_module(cell.root, "metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
