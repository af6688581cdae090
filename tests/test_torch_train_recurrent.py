"""Training the ssm (rwkv) and hybrid (jamba) families on the CPU: the
port against the JAX package on the same reduced weights
(``_torch_train_common``'s limits).

``loss_fn``'s value and every gradient leaf against ``jax.value_and_grad``
of the JAX ``loss_fn`` (jamba's with ``0.01 * aux`` of its MoE layers);
``cfg.remat`` giving the same gradients.  On the CPU the WKV and the scan
are their kernels' plain versions, which autograd differentiates; on the
card both kernels refuse under autograd until their backward kernels land
(ROADMAP queue 1, item 15; ``tests/test_torch_gpu.py`` holds the
refusals)."""
import dataclasses

import pytest
from _torch_train_common import (
    TOL,
    assert_trees_close,
    batch,
    jax_loss_grad,
    setup,
    torch_loss_grad,
)

ARCHS = ["rwkv6-1.6b", "jamba-v0.1-52b"]


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    cfg, jp, tp = setup(request.param)
    nb = batch(cfg, t=40)
    return cfg, jp, tp, nb, jax_loss_grad(cfg, jp, nb, 16)


def test_loss_and_every_gradient_equal_jax(family):
    cfg, _, tp, nb, (jl, jg) = family
    tl, tg = torch_loss_grad(cfg, tp, nb, 16)
    assert abs(tl - jl) <= TOL * abs(jl)
    assert_trees_close(jg, tg)


def test_remat_gives_the_same_loss_and_gradients(family):
    cfg, _, tp, nb, (jl, jg) = family
    tl, tg = torch_loss_grad(dataclasses.replace(cfg, remat=True), tp, nb, 16)
    assert abs(tl - jl) <= TOL * abs(jl)
    assert_trees_close(jg, tg)
