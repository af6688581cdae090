"""Training the encdec family (whisper) on the CPU: the port against the
JAX package on the same reduced weights (``_torch_train_common``'s
limits).

``loss_fn``'s value and every gradient leaf against ``jax.value_and_grad``
of the JAX ``loss_fn``, with frames as ``embeds`` and every attention
through the flash path's autograd function: the encoder's non-causal
self-attention, the decoder's causal one and cross-attention with S (the
frames) != T (the tokens); ``cfg.remat`` giving the same gradients; one
train step's loss, lr and gnorm against JAX's."""
import dataclasses

import pytest
from _torch_train_common import (
    TOL,
    assert_trees_close,
    batch,
    jax_loss_grad,
    jax_train_step,
    setup,
    to_torch,
    torch_loss_grad,
)

from repro.train import step as j_step
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models.convert import to_jax_tree
from repro_torch.train import step as t_step


@pytest.fixture(scope="module")
def whisper():
    cfg, jp, tp = setup("whisper-small")
    nb = batch(cfg, t=24, frames=40)
    return cfg, jp, tp, nb, jax_loss_grad(cfg, jp, nb, 16)


def test_loss_and_every_gradient_equal_jax(whisper):
    cfg, _, tp, nb, (jl, jg) = whisper
    calls = flash_attention_plain.calls
    tl, tg = torch_loss_grad(cfg, tp, nb, 16)
    # every attention on the flash path: 2 encoder, 2 x 2 decoder layers
    assert flash_attention_plain.calls - calls == cfg.n_enc_layers + 2 * cfg.n_layers
    assert abs(tl - jl) <= TOL * abs(jl)
    assert_trees_close(jg, tg)


def test_remat_gives_the_same_loss_and_gradients(whisper):
    cfg, _, tp, nb, (jl, jg) = whisper
    cfg = dataclasses.replace(cfg, remat=True)
    calls = flash_attention_plain.calls
    tl, tg = torch_loss_grad(cfg, tp, nb, 16)
    assert flash_attention_plain.calls - calls == 2 * (cfg.n_enc_layers
                                                       + 2 * cfg.n_layers)
    assert abs(tl - jl) <= TOL * abs(jl)
    assert_trees_close(jg, tg)


def test_train_step_matches_jax():
    cfg, jp, tp = setup("whisper-small")
    kw = dict(warmup=0, seq_chunk=16)
    jtc, ttc = j_step.TrainConfig(**kw), t_step.TrainConfig(**kw)
    nb = batch(cfg, b=2, t=16, frames=20)
    jparams, _, jm = jax_train_step(cfg, jtc, jp, nb)
    tparams, _, tm = t_step.make_train_step(cfg, ttc)(
        tp, t_step.make_optimizer(ttc).init(tp), to_torch(nb))
    for key in ("loss", "lr", "gnorm"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=TOL), key
    assert_trees_close(jparams, to_jax_tree(cfg, dict(tparams.named_parameters())),
                       what="updated weight")
