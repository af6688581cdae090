"""Shared by the port's training tests (``test_torch_train_*.py``): both
packages on the same reduced config and weights, inputs drawn with numpy
from a seed, JAX's ``value_and_grad`` of its ``loss_fn`` beside the port's
``loss_fn`` and ``torch.autograd.grad``.

The limit is 1e-5 in relative Frobenius norm per gradient leaf and 1e-5
relative on the loss, in fp32: the two run the same math with sums in
another order (JAX's chunked online-softmax scan, XLA's fusions and two
BLAS libraries; measured at most 5.1e-6, on jamba's Mamba weights).  After
a train step the weights are held to the same 1e-5: an element whose
gradient is near 0 moves by ``lr g / (|g| + eps)``, which the last bits of
g decide."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models.api import get_model as j_get_model
from repro_torch.models.api import get_model as t_get_model
from repro_torch.models.convert import params_from_numpy, to_jax_tree

TOL = 1e-5


def setup(arch, **overrides):
    """(cfg, JAX params, the port's trainable params) of the reduced
    ``arch`` with ``overrides`` applied, from one JAX key."""
    cfg = dataclasses.replace(j_reduced(j_get_config(arch)), **overrides)
    jp = j_get_model(cfg).init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu",
                           trainable=True)
    return cfg, jp, tp


def batch(cfg, b=2, t=32, seed=1, frames=24):
    """numpy tokens, targets and (vlm, encdec) embeds."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    if cfg.family == "vlm":
        out["embeds"] = rng.standard_normal(
            (b, cfg.frontend_positions, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["embeds"] = rng.standard_normal(
            (b, frames, cfg.d_model)).astype(np.float32)
    return out


def to_torch(nb):
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v)) for k, v in nb.items()}


def jax_loss_grad(cfg, jp, nb, seq_chunk):
    """``(loss, grads)`` of the JAX ``loss_fn``, jitted (a third of the
    time of eager dispatch on these configs)."""
    model = j_get_model(cfg)

    def loss(p, tokens, targets, embeds):
        return model.loss_fn(cfg, p, tokens, targets, seq_chunk=seq_chunk,
                             embeds=embeds)

    emb = nb.get("embeds")
    value, grads = jax.jit(jax.value_and_grad(loss))(
        jp, jnp.asarray(nb["tokens"]), jnp.asarray(nb["targets"]),
        None if emb is None else jnp.asarray(emb))
    return float(value), grads


def jax_train_step(cfg, tc, jp, nb):
    """One jitted JAX ``make_train_step`` step from a fresh optimizer
    state: ``(params, opt_state, metrics)``."""
    from repro.train import step as j_step

    return jax.jit(j_step.make_train_step(cfg, tc))(
        jp, j_step.make_optimizer(tc).init(jp),
        {k: jnp.asarray(v) for k, v in nb.items()})


def torch_loss_grad(cfg, tp, nb, seq_chunk):
    model = t_get_model(cfg)
    b = to_torch(nb)
    named = dict(tp.named_parameters())
    value = model.loss_fn(cfg, tp, b["tokens"], b["targets"],
                          seq_chunk=seq_chunk, embeds=b.get("embeds"))
    grads = torch.autograd.grad(value, list(named.values()))
    return float(value.detach()), to_jax_tree(cfg, dict(zip(named, grads,
                                                            strict=True)))


def rel_frob(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    norm = np.linalg.norm(want)
    return np.linalg.norm(got - want) / (norm if norm else 1.0)


def leaves(tree):
    """``{path: array}`` of a JAX-shaped tree."""
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees_close(want, got, tol=TOL, what="gradient"):
    """Same leaves, each within ``tol`` in relative Frobenius norm."""
    w, g = leaves(want), leaves(got)
    assert sorted(w) == sorted(g)
    errs = {k: rel_frob(w[k], g[k]) for k in w}
    for k in w:
        assert g[k].shape == w[k].shape, k
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, f"{what} {worst}: {errs[worst]:.3e} > {tol}"
    return errs
