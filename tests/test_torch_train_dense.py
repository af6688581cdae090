"""Training the dense, moe and vlm families: the port against the JAX
package on the same reduced weights (``_torch_train_common``'s limits).

Every family's ``loss_fn`` value and every gradient leaf against
``jax.value_and_grad`` of the JAX ``loss_fn``, with the sequence cut into
chunks and a ragged tail that the chunked loss drops; the MoE's aux term
in the loss.  The train step is ``test_torch_train_step.py``."""
import pytest
from _torch_train_common import (
    TOL,
    assert_trees_close,
    batch,
    jax_loss_grad,
    setup,
    to_torch,
    torch_loss_grad,
)

from repro_torch.models import transformer as t_tr

FAMILIES = {"dense": "llama3.2-1b", "moe": "olmoe-1b-7b",
            "vlm": "phi-3-vision-4.2b"}


# (family, T, seq_chunk): two chunks; a ragged tail that the loss drops;
# one chunk
CASES = [("dense", 32, 16), ("dense", 40, 16), ("dense", 24, 512),
         ("moe", 40, 16), ("vlm", 32, 16)]


@pytest.mark.parametrize("fam,t,seq_chunk", CASES, ids=str)
def test_loss_and_every_gradient_equal_jax(fam, t, seq_chunk):
    cfg, jp, tp = setup(FAMILIES[fam])
    nb = batch(cfg, t=t)
    jl, jg = jax_loss_grad(cfg, jp, nb, seq_chunk)
    tl, tg = torch_loss_grad(cfg, tp, nb, seq_chunk)
    assert abs(tl - jl) <= TOL * abs(jl)
    assert_trees_close(jg, tg)


def test_moe_loss_carries_the_aux_term():
    cfg, _, tp = setup("olmoe-1b-7b")
    b = to_torch(batch(cfg))
    hidden, aux = t_tr.forward(cfg, tp, b["tokens"])
    assert float(aux) > 0
    xent = t_tr.chunked_xent(cfg, tp, hidden, b["targets"], 16, t_tr.logits_fn)
    loss = t_tr.loss_fn(cfg, tp, b["tokens"], b["targets"], seq_chunk=16)
    assert float(loss) == pytest.approx(float(xent + 0.01 * aux), rel=1e-6)
