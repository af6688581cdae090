"""The hybrid (Jamba) training cell on the CPU at a tiny size, and its
yardstick.

A checkout with the benchmark's files and the tiny cells of
``conftest.make_checkout``, and beside them a tiny ``jamba2`` cell made the
same way (a configuration, a traffic file and a workload entry, its name
added to the lists of the metrics ``jamba2-3b.train_2x8192`` reports):
AI21-Jamba2-3B's form (20 query heads over one kv head, Δ at rank d / 16
with the inner norms, the tied head) at d 160, in bf16 as the
configuration states.  A sound run
is ``correct``; the reference with fp8 products in the program's place,
the program on half of each batch and a step that leaves its state
unchanged are not.

The tiny cell (two layers: one Mamba mixer, then attention) carries
limits of its own, set as the real cell's, from its own readings on the
CPU (four seeds): the program's worst first-gradient gap read
0.00065-0.00175 and its median change gap 0.00012-0.00018; the fp8
control 0.0136-0.0265 and 0.00036-0.00117; half of each batch
0.130-0.166 and 0.0019-0.0034; a state left unchanged 1 and about 1; on
the warm step (after five more steps) the program read 0.0006-0.0019 and
0.00010-0.00014, the control 0.0128-0.0170 and 0.00039-0.00064, half of
each batch 0.087-0.157 and 0.0016-0.0037.
"""
from __future__ import annotations

import json
import time

import pytest
import torch

from portbench.conftest import make_checkout
from portbench.harness import cells
from portbench.harness import work_hybrid as work
from portbench.harness.outcome import Run
from portbench.readings import head_variants, run_head

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4242
REAL = "jamba2-3b.train_2x8192"
TINY = "tiny-jamba2.t64"
SIZES = {"hidden_size": 160, "intermediate_size": 256, "vocab_size": 512,
         "mamba_dt_rank": 10, "num_hidden_layers": 2, "attn_layer_period": 2,
         "attn_layer_offset": 1,
         "limits": {"grad_gap": 0.006, "change_gap_median": 0.0003,
                    "warm_grad_gap": 0.006, "warm_change_gap_median": 0.00025}}
TRAFFIC = {"seq_len": 64, "trace_steps": 1}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """``make_checkout``'s, with the tiny ``jamba2`` cell added as it adds
    its own."""
    dest = make_checkout(tmp_path_factory.mktemp("hybrid"))
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    real = {w["name"]: w for w in bench["workloads"]}[REAL]
    cfg_file = {c["name"]: c for c in bench["configs"]}[real["config"]]["file"]
    cfg = json.loads((dest / cfg_file).read_text())
    cfg.update(SIZES, name="tiny-jamba2")
    (dest / "portbench/configs/tiny-jamba2.json").write_text(json.dumps(cfg))
    tr = json.loads((dest / "portbench/traffic" / f"{real['traffic']}.json")
                    .read_text())
    tr.update(TRAFFIC)
    (dest / "portbench/traffic/tiny_t64_jamba.json").write_text(json.dumps(tr))
    bench["configs"].append({"name": "tiny-jamba2", "source": "test",
                             "file": "portbench/configs/tiny-jamba2.json",
                             "reduced": [], "why": "a test's tiny cell"})
    bench["workloads"].append({"name": TINY, "config": "tiny-jamba2",
                               "traffic": "tiny_t64_jamba", "chips": 1,
                               "why": "a test's tiny cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if REAL in m.get("workloads", ()):
            m["workloads"].append(TINY)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


def _run(cell, trace=False):
    return cell.kind.run(cell, Run(seed=SEED, seconds=0.2, trace=trace,
                                   device=CPU, t_start=time.perf_counter()))


def test_sound_run_is_correct_and_prints_every_metric(checkout):
    """A traced run: correct, and every per-layer metric of the cell
    prints (on the CPU no device operation runs, so the rooflines and the
    idle share stay silent and the span metrics read 0)."""
    import portbench.run as runner

    args = runner.parse(["--workload", TINY, "--seed", str(SEED),
                         "--seconds", "0.2", "--trace", "1"])
    cell, out = runner.run_cell(checkout, args, CPU, time.perf_counter())
    assert out.correct, out.checks
    assert out.attempted >= 1 and out.end_to_end["train_tokens_per_s"] > 0
    line = runner.result_line(cell, out, True)
    # the MFU reads the untraced rest of the window, which may be empty here
    assert {"jamba2_mamba_ms", "jamba2_attention_ms"} <= set(
        line["metrics"]) <= {"jamba2_train_mfu_pct", "jamba2_mamba_ms",
                             "jamba2_attention_ms"}
    assert line["metrics"]["jamba2_mamba_ms"]["value"] == 0.0
    assert {m["name"] for m in cell.per_layer} == {
        "idle_pct.train", "jamba2_train_mfu_pct", "selective_scan_roofline",
        "selective_scan_bwd_roofline", "flash_attention_roofline",
        "flash_attention_bwd_roofline", "jamba2_mamba_ms",
        "jamba2_attention_ms"}
    assert out.layers.spans.has("model.mamba")
    assert out.layers.spans.has("model.attention")
    assert out.layers.spans.has("model.mlp")
    assert out.layers.counters["launches"]["selective_scan"] == 0


def test_fp8_control_is_not_correct(checkout, monkeypatch):
    cell = cells.load_cell(checkout, TINY)

    def control(self):
        return self.reference(precision="fp8")

    monkeypatch.setattr(cell.kind.Trainer, "first_steps", control)
    assert not _run(cell).correct


def test_half_the_batch_is_not_correct(checkout, monkeypatch):
    """The reference on one of each batch's two rows in the program's
    place (a microbatch holds one row, so the program cannot drop one)."""
    cell = cells.load_cell(checkout, TINY)

    def half(self):
        return self.reference(rows=slice(0, 1))

    monkeypatch.setattr(cell.kind.Trainer, "first_steps", half)
    assert not _run(cell).correct


def test_state_left_unchanged_is_not_correct(checkout, monkeypatch):
    from repro_torch.optim import adamw

    cell = cells.load_cell(checkout, TINY)

    def unchanged(self, grads, state, params, lr, gnorm=None):
        return params, state, torch.zeros(())

    monkeypatch.setattr(adamw.AdamW, "update", unchanged)
    out = _run(cell)
    assert not out.correct
    got = {c.name: c.value for c in out.checks}
    assert got["grad_gap"] == 1.0 and got["change_gap_median"] > 0.5


def test_a_parent_without_the_published_mixer_fails_at_once(checkout,
                                                            monkeypatch):
    """A program without ``JambaConfig`` refuses the cell before drawing a
    weight."""
    from repro_torch.models import jamba

    cell = cells.load_cell(checkout, TINY)
    monkeypatch.delattr(jamba, "JambaConfig")
    drawn = []
    monkeypatch.setattr(cell.reference(), "initial_weights",
                        lambda *a: drawn.append(a))
    with pytest.raises(ImportError, match="JambaConfig"):
        _run(cell)
    assert not drawn


def test_one_row_private_call_is_correct(checkout):
    """The ``private_head_r1`` traffic on the tiny head: one row a call."""
    cell = cells.load_cell(checkout, "tiny-head.r8")
    cell.traffic = dict(cell.traffic, rows=1)
    out = run_head(cell, SEED, CPU, 0.3, head_variants(cell)["program"])
    assert out.correct, out.checks
    assert out.end_to_end["private_rows_per_s"] > 0


# ------------------------------------------------------------ yardstick --
MS = 1e-3
CFG = {"hidden_size": 2560, "intermediate_size": 8192, "vocab_size": 65536,
       "num_hidden_layers": 28, "num_attention_heads": 20,
       "num_key_value_heads": 1, "attn_layer_period": 14,
       "attn_layer_offset": 7, "mamba_expand": 2, "mamba_d_state": 16,
       "mamba_dt_rank": 160}


def test_scan_bounds_at_the_cells_launch():
    # [1, 8192, 5120, 16] bf16: u, dt 2 x 83.9 MB, b, c 0.5 MB, a 0.3 MB,
    # y 167.8 MB fp32, the state 0.3 MB: 336.7 MB = 0.1005 ms at 3.35
    # TB/s, above 6 x 671 M = 4.03 GFLOP at 67 TFLOP/s (0.0601 ms)
    nbytes, ops = work.scan_work(1, 8192, 5120, 16, 2)
    assert nbytes == 2 * (2 * 8192 * 5120 + 2 * 8192 * 16) + 4 * 5120 * 16 \
        + 4 * 8192 * 5120 + 4 * 5120 * 16
    assert ops == 6 * 8192 * 5120 * 16
    assert work.bound_s(nbytes, ops, work.FP32_FLOPS_PER_S) / MS == \
        pytest.approx(0.1005, abs=5e-5)
    # the backward: 20 x 671 M = 13.4 GFLOP at 67 TFLOP/s = 0.2003 ms,
    # above its 588.9 MB (0.1758 ms)
    nbytes, ops = work.scan_bwd_work(1, 8192, 5120, 16, 2)
    assert nbytes == 588906496 and ops == 20 * 8192 * 5120 * 16
    assert work.bound_s(nbytes, ops, work.FP32_FLOPS_PER_S) / MS == \
        pytest.approx(0.2003, abs=5e-5)


def test_flash_bounds_at_the_cells_launch():
    # causal [1, 8192, 20/1, 128]: 8192 x 8193 / 2 visible pairs; 4 x 128 x
    # 20 flops each = 343.6 GFLOP at 989 TFLOP/s = 0.3475 ms; the backward's
    # 10 x 128 x 20 = 859.1 GFLOP = 0.8687 ms
    pairs = 8192 * 8193 // 2
    assert work.causal_pairs(8192, 8192) == pairs
    nbytes, flops, peak = work.attn_work(1, 8192, 8192, 20, 1, 128, 2)
    assert nbytes == 2 * (2 * 8192 * 20 * 128 + 2 * 8192 * 128)
    assert flops == 4 * 128 * 20 * pairs and peak == work.BF16_FLOPS_PER_S
    assert work.bound_s(nbytes, flops, peak) / MS == \
        pytest.approx(0.3475, abs=5e-5)
    nbytes, flops, peak = work.bwd_work(1, 8192, 8192, 20, 1, 128, 2)
    assert flops == 10 * 128 * 20 * pairs
    assert work.bound_s(nbytes, flops, peak) / MS == \
        pytest.approx(0.8687, abs=5e-5)
    assert work.causal_pairs(4, 6, q_offset=2) == 3 + 4 + 5 + 6
    assert work.attn_work(1, 4, 6, 1, 1, 8, 4)[2] == work.FP32_FLOPS_PER_S


def test_mfu_flops_against_a_hand_count():
    # matmul weights: 26 Mamba mixers x (2560 x 10240 + 5120 x 192 + 160 x
    # 5120 + 5120 x 2560) = 1,069,219,840; 2 attention layers x (2 x 2560^2
    # + 2 x 2560 x 128) = 27,525,120; 28 SwiGLUs x 3 x 2560 x 8192 =
    # 1,761,607,680; the tied head 65536 x 2560 = 167,772,160
    params = 1_069_219_840 + 27_525_120 + 1_761_607_680 + 167_772_160
    assert work.jamba2_matmul_params(CFG) == params == 3_026_124_800
    tokens = 2 * 8192
    attn = 12 * 128 * 20 * (8192 * 8193 // 2) * 2 * 2
    assert attn == pytest.approx(4.12e12, rel=1e-3)
    flops = work.jamba2_step_flops(CFG, 2, 8192)
    assert flops == 6 * params * tokens + attn
    assert flops / 1e12 == pytest.approx(301.60, abs=0.01)
