"""A run that cannot measure prints no result: with no CUDA card, and in a
folder that holds only ``BENCHMARK.json`` and ``portbench/`` (no
program)."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(where: Path, workload: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""      # no card, whatever the machine
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=where, env=env, capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("workload", ["jamba-v0.1-52b.private_head_r2048",
                                      "rwkv6-1.6b.train_4x2048"])
def test_no_card_no_result(workload):
    out = _run(ROOT, workload)
    assert out.returncode == 2, out.stderr[-2000:]
    assert out.stdout == ""
    assert "no result" in out.stderr
    assert "memory_peak_bytes" not in out.stderr


def test_benchmark_files_alone_give_no_result(checkout):
    out = _run(checkout, "tiny-head.r8")
    assert out.returncode != 0
    assert out.stdout == ""
