"""The multi-rank trainer on gloo ranks on the CPU, against one rank.

Reduced fp32 configs of a dense family (llama3.2-1b) and of rwkv
(rwkv6-1.6b), 3 steps on a global batch of 4 rows: two ranks (``data =
2``, FSDP: the ``p_fsdp`` dims split over ``data``) and four ranks (``pod
= 2, data = 2``) give the losses and every weight of one process with
``microbatches = world`` on the whole batch, within 1e-6 relative (loss
by loss, weight by weight in Frobenius norm), and in fact to the bit: the
ranks' gradients are added from zero in rank order, as the microbatches
are, and the clip norm is taken over whole gradients (the one-rank run
takes one thread, as each rank does).  With ``compress_pod`` (``pod =
2``) the trainer's own reductions meet ``compressed_psum``'s guarantees
at every step (``tools/multicard_train.py``'s ``FeedbackCheck``) and the
loss falls.  A 2-rank run resumed from its step-2 checkpoint equals the
uninterrupted one bit for bit, on ``data = 2`` and on ``pod = 2`` with
``compress_pod`` (whose residuals the checkpoint holds).  A ``model``
axis above 1 raises.  The runs go through the harness of
``tools/multicard_train.py``, which ``chip_smoke.py`` and the card tests
share; ranks meet through a ``file://`` rendezvous in a directory of
their own (no fixed port: tests run on several workers).
"""
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get_config, reduced
from repro_torch.launch import train as t_train
from repro_torch.launch.mesh import process_mesh
from repro_torch.parallel.fsdp import Layout
from repro_torch.train.step import TrainConfig, make_train_step

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import multicard_train as mc  # noqa: E402  (the shared multi-rank harness)

STEPS, BATCH, SEQ = 3, 4, 32
TOL = 1e-6


def _tc(microbatches=1, steps=STEPS):
    return TrainConfig(peak_lr=1e-2, warmup=1, stable=steps, decay=2,
                       seq_chunk=SEQ, microbatches=microbatches)


def _job(arch, **kw):
    """A CPU job of the harness on ``arch``'s reduced config."""
    return dict(cfg=reduced(get_config(arch)), tc=_tc(), device="cpu",
                steps=STEPS, batch=BATCH, seq=SEQ, **kw)


def _resume_rank(rank, world, init, shape, axes, compress, out_dir):
    """A 4-step run against 2 steps, a checkpoint, and 2 resumed steps."""
    torch.set_num_threads(1)        # several ranks share the test's cores
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = process_mesh(shape, axes, device="cpu")
        cfg = reduced(get_config("llama3.2-1b"))
        ckpt = os.path.join(out_dir, "ckpt")
        kw = dict(global_batch=BATCH, seq_len=SEQ, device="cpu", mesh=mesh,
                  ckpt_every=2, compress_pod=compress)
        whole_p, whole_o, whole_l = t_train.train_loop(
            cfg, _tc(steps=4), steps=4, ckpt_dir=None, **kw)
        _, _, first = t_train.train_loop(cfg, _tc(steps=4), steps=2,
                                         ckpt_dir=ckpt, **kw)
        resumed_p, resumed_o, rest = t_train.train_loop(
            cfg, _tc(steps=4), steps=4, ckpt_dir=ckpt, **kw)
        layout = Layout.for_config(cfg, mesh)
        a = {n: layout.gather(n, p.detach()) for n, p in
             whole_p.named_parameters()}
        b = {n: layout.gather(n, p.detach()) for n, p in
             resumed_p.named_parameters()}
        fb = [torch.equal(whole_o.feedback[n], resumed_o.feedback[n])
              for n in whole_o.feedback]
        res = np.array([all(torch.equal(a[n], b[n]) for n in a),
                        first + rest == whole_l, all(fb),
                        len(fb) > 0 if compress else not fb])
        np.save(os.path.join(out_dir, f"rank{rank}.npy"), res)
    finally:
        dist.destroy_process_group()


def _resume(tmp_path, shape, axes, compress):
    world = int(np.prod(shape))
    init = f"file://{tmp_path / 'rendezvous'}"
    mp.spawn(_resume_rank, args=(world, init, shape, axes, compress,
                                 str(tmp_path)), nprocs=world)
    return [np.load(tmp_path / f"rank{r}.npy") for r in range(world)]


@pytest.mark.parametrize("shape,axes", [((2,), ("data",)),
                                        ((2, 2), ("pod", "data"))],
                         ids=["data2", "pod2data2"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b"])
def test_ranks_equal_one_rank_on_the_whole_batch(arch, shape, axes):
    world = int(np.prod(shape))
    job = _job(arch, repeat=False)
    got = mc.spawn(**job, shape=shape, axes=axes)
    ref = mc.one_rank(job["cfg"], _tc(world), device="cpu", steps=STEPS,
                      batch=BATCH, seq=SEQ, repeat=False)
    assert len(got["split"]) > 0         # FSDP split some leaves over data
    cmp = mc.compare(got, ref)
    assert cmp["loss_diff"] <= TOL and cmp["weight_diff"] <= TOL, cmp
    assert cmp["bit_equal_leaves"] == cmp["leaves"], cmp
    assert cmp["losses_equal"], (got["losses"], ref["losses"])


def test_compress_pod_meets_the_feedback_bounds():
    """The trainer's own reductions over ``pod = 2``, every step: the
    residuals fed back from the state, the scale, ``q`` and the residual
    exact, every element within ``scale / 2`` of the mean; the loss
    falls."""
    got = mc.spawn(**_job("llama3.2-1b"), shape=(2,), axes=("pod",),
                   compress=True)
    rep = got["report"]
    assert rep["ok"] and rep["steps"] == STEPS, rep
    assert rep["worst_over_half_scale"] <= 1.0 + 1e-5, rep
    losses = got["losses"]
    assert losses[-1] < losses[0], losses


def test_two_rank_resume_is_bit_exact(tmp_path):
    for res in _resume(tmp_path, (2,), ("data",), compress=False):
        assert res.all(), res


def test_two_rank_compress_pod_resume_is_bit_exact(tmp_path):
    """``pod = 2`` with ``compress_pod``: the error-feedback residuals are
    checkpointed with the state, so the resumed run's weights, losses and
    residuals equal the uninterrupted run's bit for bit."""
    for res in _resume(tmp_path, (2,), ("pod",), compress=True):
        assert res.all(), res


def test_a_model_axis_above_one_raises():
    class FakeMesh:
        shape = {"data": 2, "model": 2}

    cfg = reduced(get_config("llama3.2-1b"))
    with pytest.raises(ValueError, match="tensor parallelism"):
        make_train_step(cfg, _tc(), mesh=FakeMesh())
    with pytest.raises(ValueError, match="compress_pod"):
        make_train_step(cfg, _tc(), compress_pod=True)


def test_train_main_runs_ranks(capfd):
    """``launch.train --nproc``: one rank in this process equals the
    one-card CLI bit for bit; two spawned gloo ranks report their mesh."""
    argv = ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
            "--steps", "2", "--batch", "4", "--seq", "16"]
    _, _, one = t_train.main(argv)
    _, _, ranked = t_train.main(argv + ["--nproc", "1"])
    assert one == ranked
    assert t_train.main(argv + ["--nproc", "2", "--mesh", "data=2"]) is None
    out = capfd.readouterr().out
    assert "[train] 2 ranks, mesh {'data': 2}" in out
    assert "[train] 1 ranks, mesh {'data': 1}" in out
    assert t_train.parse_mesh("pod=2,data=2", 4) == ((2, 2), ("pod", "data"))
    assert t_train.parse_mesh(None, 3) == ((3,), ("data",))
