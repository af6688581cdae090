"""``correct`` on the CPU at tiny sizes: a sound run reads correct, and the
control in the program's place and each planted fault do not.  The look
for a card is skipped; the rest of a run is driven as the benchmark drives
it, with the timed path broken underneath.  Also: the plain references
agree with the program where both compute the same thing in float32."""
from __future__ import annotations

import time

import pytest
import torch

from portbench.harness import cells
from portbench.harness.outcome import Run
from portbench.readings import head_variants, run_head

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("variant", ["program", "control_bfloat16",
                                     "fault_altered", "fault_half_rows",
                                     "fault_survivors"])
def test_private_matmul_is_correct_only_when_sound(checkout, variant):
    cell = cells.load_cell(checkout, "tiny-head.r8")
    out = run_head(cell, SEED, CPU, 0.3, head_variants(cell)[variant])
    assert out.correct is (variant == "program"), out.checks
    got = {c.name: c.value for c in out.checks}
    if variant == "fault_survivors":
        assert got["max_abs_err"] == 0.0 and got["max_abs_err_survivors"] > 0
    assert out.attempted >= 1 and out.end_to_end["private_rows_per_s"] > 0


def test_tf32_cannot_be_the_control_here(checkout):
    """The encoded integers stay below 2^11 and their sums below 2^24, so
    float32 (and TF32) computes this product exactly."""
    cell = cells.load_cell(checkout, "tiny-head.r8")
    out = run_head(cell, SEED, CPU, 0.2, head_variants(cell)["control_tf32"])
    assert out.checks[0].value == 0.0


def _run_train(cell, seed=SEED):
    return cell.kind.run(cell, Run(seed=seed, seconds=0.2, trace=False,
                                   device=CPU, t_start=time.perf_counter()))


def test_training_sound_run_is_correct(checkout):
    cell = cells.load_cell(checkout, "tiny-rwkv.t64")
    out = _run_train(cell)
    assert out.correct, out.checks
    assert out.attempted >= 1 and out.end_to_end["train_tokens_per_s"] > 0


def test_training_control_is_not_correct(checkout, monkeypatch):
    """The reference with fp8 matrix products in the program's place."""
    cell = cells.load_cell(checkout, "tiny-rwkv.t64")
    kind = cell.kind

    def control(self):
        return self.reference(precision="fp8")

    monkeypatch.setattr(kind.Trainer, "first_steps", control)
    assert not _run_train(cell).correct


def test_training_step_that_leaves_its_state_is_not_correct(checkout,
                                                             monkeypatch):
    from repro_torch.optim import adamw

    cell = cells.load_cell(checkout, "tiny-rwkv.t64")

    def unchanged(self, grads, state, params, lr, gnorm=None):
        return params, state, torch.zeros(())

    monkeypatch.setattr(adamw.AdamW, "update", unchanged)
    out = _run_train(cell)
    assert not out.correct
    got = {c.name: c.value for c in out.checks}
    assert got["grad_gap"] == 1.0 and got["change_gap_median"] > 0.5


def test_training_step_that_goes_wrong_once_warm_is_not_correct(
        checkout, monkeypatch):
    """A step that leaves its state unchanged from the first step after the
    checked ones on: the first steps read sound, the warm step does not."""
    from repro_torch.optim import adamw

    cell = cells.load_cell(checkout, "tiny-rwkv.t64")
    sound = adamw.AdamW.update
    n0 = cell.traffic["check_steps"]

    def later(self, grads, state, params, lr, gnorm=None):
        if int(state.step) < n0:
            return sound(self, grads, state, params, lr, gnorm=gnorm)
        return params, state, torch.zeros(())

    monkeypatch.setattr(adamw.AdamW, "update", later)
    out = _run_train(cell)
    got = {c.name: c for c in out.checks}
    assert got["grad_gap"].ok and got["change_gap_median"].ok
    assert not out.correct
    assert got["warm_change_gap_median"].value > 0.5
    assert not got["warm_grad_gap"].ok


def test_training_on_half_the_batch_is_not_correct(checkout, monkeypatch):
    from repro_torch.models import rwkv

    cell = cells.load_cell(checkout, "tiny-rwkv.t64")
    whole = rwkv.loss_fn

    def half(cfg, params, tokens, targets, **kw):
        n = max(1, tokens.shape[0] // 2)
        return whole(cfg, params, tokens[:n], targets[:n], **kw)

    monkeypatch.setattr(rwkv, "loss_fn", half)
    assert not _run_train(cell).correct


def test_reference_wkv_equals_the_programs_recurrence():
    from portbench.references import rwkv6 as ref
    from repro_torch.kernels.rwkv6 import rwkv6_plain

    g = torch.Generator().manual_seed(5)
    b, t, h = 2, 48, 3
    r, k, v = (torch.randn(b, t, h, 64, generator=g) for _ in range(3))
    w = torch.randn(b, t, h, 64, generator=g) * 0.5 - 2.0
    u = torch.randn(h, 64, generator=g)
    want, _ = rwkv6_plain(r, k, v, w, u)
    got = ref.wkv(r, k, v, w, u)
    assert float((got - want).norm() / want.norm()) < 1e-6
    assert torch.allclose(got, want, rtol=1e-4,
                          atol=1e-5 * float(want.abs().max()))


def test_reference_training_equals_the_program_in_float32(checkout):
    """At float32 the program and the reference compute the same function:
    the losses, first gradients and changes agree to rounding."""
    import json

    cell = cells.load_cell(checkout, "tiny-rwkv.t64")
    cell.config = json.loads(json.dumps(cell.config))
    cell.config["dtype"] = "float32"
    trainer = cell.kind.Trainer(cell, SEED, CPU)
    prog = trainer.first_steps()
    trainer.free()
    gaps = cell.kind.compare(prog, trainer.reference())
    assert gaps["loss_gap"] < 1e-6
    assert gaps["grad_gap"] < 1e-5
    assert gaps["change_gap"] < 1e-4


def test_a_traced_run_prints_its_per_layer_metrics(checkout):
    """``--trace 1`` on the CPU: the profile reduces and the line ends with
    the checks."""
    import portbench.run as runner

    args = runner.parse(["--workload", "tiny-head.r8", "--seed", str(SEED),
                         "--seconds", "0.3", "--trace", "1"])
    cell, out = runner.run_cell(checkout, args, CPU, time.perf_counter())
    line = runner.result_line(cell, out, True)
    assert line["correct"] is True
    # the counters' and the host clock's metrics read; no device operation
    # ran, so the rooflines and the idle share stay silent
    assert "head_fill_pct" in line["metrics"]
    assert set(line["metrics"]) <= {"head_fill_pct", "head_mfu_pct"}
    assert line["device"]["window_s"] > 0 and "busy_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line)[-1] == "checks"
