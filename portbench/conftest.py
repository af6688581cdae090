"""Fixtures of the benchmark's own tests: a checkout in a temporary folder
with the benchmark's files and two tiny cells beside the real ones, one
per traffic kind, each a configuration and a traffic file added without
editing any file that is there.

The tiny training configuration carries limits of its own, set as the real
ones are, from its own readings on the CPU (four seeds each time): the
program's worst first-gradient gap read 0.0017-0.0042 and its median
change gap 0.0002-0.0005, the fp8 control 0.042-0.067 and 0.0007-0.0014,
half of each batch 0.083-0.216 and 0.0025-0.0033, a state left unchanged 1
and about 1; on the warm step (after five more steps) the program read
0.0014-0.0054 and 0.00022-0.00037, the control 0.030-0.056 and
0.00114-0.00153, half of each batch 0.072-0.130 and 0.0023-0.0046."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

HEAD_CELL = "jamba-v0.1-52b.private_head_r2048"
TRAIN_CELL = "rwkv6-1.6b.train_4x2048"
TINY = {
    "tiny-head.r8": (HEAD_CELL, {"hidden_size": 96, "vocab_size": 200},
                     {"rows": 8, "trace_calls": 2, "check_span": 4}),
    "tiny-rwkv.t64": (TRAIN_CELL, {"n_layers": 2, "d_model": 256, "d_ff": 512,
                                   "vocab": 1024,
                                   "limits": {
                                       "grad_gap": 0.015,
                                       "change_gap_median": 0.01,
                                       "warm_grad_gap": 0.015,
                                       "warm_change_gap_median": 0.0008}},
                      {"seq_len": 64, "trace_steps": 1}),
}


def make_checkout(dest: Path) -> Path:
    """Copy ``BENCHMARK.json`` and ``portbench/`` to ``dest`` and add the
    tiny cells: a configuration file, a traffic file and a workload entry
    each, their names added to the lists of the metrics the real cell of
    their kind reports."""
    dest = Path(dest)
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    for name, (like, sizes, traffic) in TINY.items():
        cfg_name, mix = name.split(".")
        real = cells[like]
        cfg = json.loads((ROOT / configs[real["config"]]["file"]).read_text())
        cfg.update(sizes, name=cfg_name)
        cfg_file = f"portbench/configs/{cfg_name}.json"
        (dest / cfg_file).write_text(json.dumps(cfg))
        mix_name = f"tiny_{mix}"
        tr = json.loads((ROOT / "portbench" / "traffic"
                         / f"{real['traffic']}.json").read_text())
        tr.update(traffic)
        (dest / "portbench" / "traffic" / f"{mix_name}.json").write_text(
            json.dumps(tr))
        bench["configs"].append({"name": cfg_name, "source": "test",
                                 "file": cfg_file, "reduced": [],
                                 "why": "a test's tiny cell"})
        bench["workloads"].append({"name": name, "config": cfg_name,
                                   "traffic": mix_name, "chips": 1,
                                   "why": "a test's tiny cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("checkout"))
