"""The harness finds every cell's configuration, traffic, traffic kind and
metrics by the names in ``BENCHMARK.json``, files added later included,
and ``BENCHMARK.json`` keeps to its contract's shape."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench.harness import cells

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_is_found_by_name(workload):
    cell = cells.load_cell(ROOT, workload)
    assert cell.kind.run
    assert cell.reference()
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
        assert callable(cells.load_module(ROOT, "metrics", m["name"]).read)


def test_files_added_in_a_copy_are_found(checkout):
    """The tiny cells of the fixture are a configuration file, a traffic
    file and entries, added beside the real ones; a metric is one file and
    one entry more."""
    for name in ("tiny-head.r8", "tiny-rwkv.t64"):
        cell = cells.load_cell(checkout, name)
        assert cell.config["name"] == name.split(".")[0]
        assert cell.traffic["kind"] in ("private_matmul", "train")
    (checkout / "portbench" / "metrics" / "rows_traced.py").write_text(
        "def read(ctx):\n    return ctx.items * ctx.counters['shape'][0]\n")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "rows_traced", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "Session and tiling",
        "moves": "private_rows_per_s", "workloads": ["tiny-head.r8"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load_cell(checkout, "tiny-head.r8")
    assert "rows_traced" in [m["name"] for m in cell.per_layer]

    class Ctx:
        items, counters = 3, {"shape": (8, 96, 200)}

    got = cells.read_layer_metrics(
        cell.__class__(**{**cell.__dict__, "per_layer": cell.per_layer[-1:]}),
        Ctx())
    assert got == {"rows_traced": {"value": 24.0, "unit": "rows"}}


def test_an_unknown_cell_is_refused():
    with pytest.raises(LookupError):
        cells.load_cell(ROOT, "no-such.cell")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
        assert set(c["reduced"]) <= set(json.loads(
            (ROOT / c["file"]).read_text()).get("reduced", []))
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    names = set()
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        names.add(m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in names and set(m["workloads"]) <= set(WORKLOADS)
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    every = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(every) == len(set(every)) and "setup_s" in every
