"""The port's checkpoint manager, data pipeline and training driver on the
CPU.

The reference's checks (``tests/test_substrate.py``) on the port: an
atomic commit that ``keep`` garbage-collects and a torn ``.tmp`` that
stays invisible, async save then restore; bf16 leaves stored as their
bits and read back bit for bit; a module and an ``AdamWState`` restored
into the structure of ``like``.  ``SyntheticTokens.batch_np`` bit-equal
to JAX's, ``_hash_u64`` pinned to the reference's source, and
``SyntheticMatrices`` equal.  ``train_loop``: an exact-step resume from
a checkpoint gives the uninterrupted run's losses and weights bit for
bit (the CPU is deterministic), and ``main`` runs the CLI on the CPU."""
import inspect
import json
import os

import numpy as np
import pytest
import torch

from repro.data import pipeline as j_pipeline
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.data import pipeline as t_pipeline
from repro_torch.launch import train as t_train
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.train.step import TrainConfig


# ------------------------------------------------------------- checkpoint --
def test_checkpoint_atomic_commit_and_resume(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2)
    state = {"w": torch.arange(6.0).reshape(2, 3),
             "step": torch.tensor(7, dtype=torch.int32)}
    mgr.save(1, state)
    mgr.save(2, state)
    mgr.save(3, state)  # keep=2 -> step 1 garbage-collected
    assert mgr.all_steps() == [2, 3]
    # a torn write (tmp dir without manifest) is invisible
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert mgr.latest_step() == 3
    got = mgr.restore(3, state)
    assert torch.equal(got["w"], state["w"])
    assert int(got["step"]) == 7 and got["step"].dtype == torch.int32
    assert sorted(os.listdir(os.path.join(d, "step_00000003"))) == [
        "arrays.npz", "manifest.json"]


def test_checkpoint_async_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = {"a": torch.ones((4, 4))}
    mgr.save_async(10, state)
    state["a"].add_(1)              # the snapshot was taken before this
    mgr.wait()
    r = mgr.restore(10, state)
    assert torch.equal(r["a"], torch.ones((4, 4)))


def test_checkpoint_keeps_bf16_bits(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    mgr.save(1, {"x": x, "f": x.float()})
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    assert leaves["x"] == {"shape": [5, 3], "dtype": "bfloat16"}
    assert leaves["f"]["dtype"] == "float32"
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as data:
        assert data["x"].dtype == np.uint16
    got = mgr.restore(1, {"x": torch.zeros_like(x), "f": torch.zeros(5, 3)})
    assert got["x"].dtype == torch.bfloat16 and torch.equal(got["x"], x)


def test_checkpoint_restores_a_module_in_place_and_the_optimizer_state(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    lin = torch.nn.Linear(3, 2)
    opt = AdamW()
    state = opt.init(lin)
    opt.update([torch.ones(2, 3), torch.ones(2)], state, lin, 0.1)
    state = AdamWState(step=state.step + 1, mu=state.mu, nu=state.nu)
    saved = {k: p.detach().clone() for k, p in lin.named_parameters()}
    mgr.save(4, {"params": lin, "opt": state})
    fresh = torch.nn.Linear(3, 2)
    like = {"params": fresh, "opt": opt.init(fresh)}
    got = mgr.restore(4, like)
    assert got["params"] is fresh
    for k, p in fresh.named_parameters():
        assert torch.equal(p, saved[k])
    assert isinstance(got["opt"], AdamWState) and int(got["opt"].step) == 1
    for k in state.mu:
        assert torch.equal(got["opt"].mu[k], state.mu[k])
        assert torch.equal(got["opt"].nu[k], state.nu[k])


# ------------------------------------------------------------------- data --
def test_hash_is_the_reference_copy():
    assert (inspect.getsource(t_pipeline._hash_u64)
            == inspect.getsource(j_pipeline._hash_u64))
    x = np.arange(1000, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    np.testing.assert_array_equal(t_pipeline._hash_u64(x),
                                  j_pipeline._hash_u64(x))


@pytest.mark.parametrize("step,lo,hi", [(0, 0, None), (5, 2, 6), (123, 1, 3)])
def test_synthetic_tokens_bit_equal_to_jax(step, lo, hi):
    kw = dict(vocab=1000, seq_len=16, global_batch=8, seed=3)
    got = t_pipeline.SyntheticTokens(**kw).batch_np(step, lo=lo, hi=hi)
    want = j_pipeline.SyntheticTokens(**kw).batch_np(step, lo=lo, hi=hi)
    for k in ("tokens", "targets"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_tokens_on_a_device_and_matrices():
    ds = t_pipeline.SyntheticTokens(vocab=1000, seq_len=16, global_batch=8,
                                    seed=3)
    b = ds.batch(5, device="cpu")
    assert b["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(b["tokens"].numpy(), ds.batch_np(5)["tokens"])
    assert np.array_equal(next(iter(ds))["tokens"], ds.batch_np(0)["tokens"])
    for got, want in zip(t_pipeline.SyntheticMatrices(m=6, seed=2).pair(3),
                         j_pipeline.SyntheticMatrices(m=6, seed=2).pair(3),
                         strict=True):
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------- driver --
def _loop(**kw):
    cfg = reduced(get_config("llama3.2-1b"))
    tc = TrainConfig(warmup=2, stable=100, decay=2, seq_chunk=16)
    return t_train.train_loop(cfg, tc, global_batch=2, seq_len=16,
                              device="cpu", log_every=100, **kw)


def test_train_loop_resumes_at_the_exact_step(tmp_path):
    whole, whole_opt, losses = _loop(steps=4, ckpt_dir=None)
    d = str(tmp_path)
    _, _, first = _loop(steps=2, ckpt_dir=d, ckpt_every=2)
    assert CheckpointManager(d).all_steps() == [2]
    history = []
    resumed, resumed_opt, rest = _loop(steps=4, ckpt_dir=d, history=history)
    assert [h["step"] for h in history] == [2, 3]
    assert first + rest == losses
    assert int(resumed_opt.step) == int(whole_opt.step) == 4
    for (name, p), q in zip(resumed.named_parameters(), whole.parameters(),
                            strict=True):
        assert torch.equal(p, q), name
    assert CheckpointManager(d).all_steps() == [2, 4]


def test_train_main_runs_on_the_cpu(capsys):
    t_train.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                  "--steps", "3", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "[train] step     2" in out and "first-loss" in out
