"""The port's train step against the JAX package's on reduced
llama3.2-1b (``_torch_train_common``'s limits).

One ``make_train_step`` step at ``microbatches`` 1 and 2: loss, lr, gnorm,
the updated weights and the AdamW moments; remat (per layer, and in blocks
of ``remat_block`` layers) giving the gradients of no remat, with the
attention forward run again in the backward pass; the weights frozen
unless asked trainable, and ``init_train_state``'s zero optimizer state."""
import jax
import numpy as np
import pytest
import torch
from _torch_train_common import (
    TOL,
    assert_trees_close,
    batch,
    jax_train_step,
    rel_frob,
    setup,
    to_torch,
    torch_loss_grad,
)

from repro.train import step as j_step
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models.convert import params_from_numpy, to_jax_tree
from repro_torch.train import step as t_step


def _train_configs(**kw):
    return j_step.TrainConfig(**kw), t_step.TrainConfig(**kw)


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_jax(mb):
    cfg, jp, tp = setup("llama3.2-1b")
    # warmup 0: the first step already has the peak rate
    jtc, ttc = _train_configs(warmup=0, seq_chunk=16, microbatches=mb)
    nb = batch(cfg, b=4, t=32)
    jparams, jstate, jm = jax_train_step(cfg, jtc, jp, nb)
    topt = t_step.make_optimizer(ttc).init(tp)
    tparams, tstate, tm = t_step.make_train_step(cfg, ttc)(tp, topt, to_torch(nb))
    assert tparams is tp                      # updated in place
    assert int(tstate.step) == int(jstate.step) == 1
    for key in ("loss", "lr", "gnorm"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=TOL), key
    assert float(tm["lr"]) == pytest.approx(jtc.peak_lr, rel=1e-7)
    assert_trees_close(jparams, to_jax_tree(cfg, dict(tparams.named_parameters())),
                       what="updated weight")
    assert_trees_close(jstate.mu, to_jax_tree(cfg, tstate.mu), what="mu")
    assert_trees_close(jstate.nu, to_jax_tree(cfg, tstate.nu), tol=2 * TOL,
                       what="nu")
    # the update itself (lr times the Adam direction plus decay)
    jw = jax_tree_leaf(jparams, "w_q")
    moved = tparams.layers[0].w_q.detach().numpy()
    before = np.asarray(jax_tree_leaf(jp, "w_q"))
    assert rel_frob(np.asarray(jw)[0] - before[0], moved - before[0]) <= 1e-4


def jax_tree_leaf(tree, name):
    return tree["layers"][name]


@pytest.mark.parametrize("block", [1, 2])
def test_remat_gives_the_gradients_of_no_remat(block):
    """3 layers: per-layer remat runs each attention forward twice (6
    calls).  In blocks of 2 and a tail of 1, as ``jax.checkpoint`` nested
    in the reference's scan: the block's first layer three times, its
    second twice (the block's recompute stops once the second layer's
    input is back: torch's early stop), the tail twice (7)."""
    cfg_plain, _, tp = setup("llama3.2-1b", n_layers=3)
    nb = batch(cfg_plain)
    want = torch_loss_grad(cfg_plain, tp, nb, 16)
    # the same weights (one JAX key), remat on
    cfg, _, tp2 = setup("llama3.2-1b", n_layers=3, remat=True,
                        remat_block=block)
    calls = flash_attention_plain.calls
    got = torch_loss_grad(cfg, tp2, nb, 16)
    assert flash_attention_plain.calls - calls == (6 if block == 1 else 7)
    assert got[0] == want[0]
    assert_trees_close(want[1], got[1], tol=1e-7, what="remat gradient")


def test_weights_are_frozen_unless_trainable():
    cfg, jp, _ = setup("llama3.2-1b")
    tree = jax.tree.map(np.asarray, jp)
    assert not any(p.requires_grad
                   for p in params_from_numpy(cfg, tree, device="cpu").parameters())
    params, state = t_step.init_train_state(cfg, t_step.TrainConfig(), 0,
                                            device="cpu")
    assert all(p.requires_grad for p in params.parameters())
    assert set(state.mu) == {n for n, _ in params.named_parameters()}
    assert all(m.dtype == torch.float32 and not m.any() for m in state.mu.values())
    assert int(state.step) == 0 and state.step.dtype == torch.int32
