"""Private inference on the PyTorch/CUDA port: a model's lm_head under
AGE-CMPC.

A reduced llama3.2-1b computes its lm_head projection under MPC: the
activations (one party) and the weights (another) stay private from the
worker pool; only the logits emerge.  The projection is the serving shape,
``[1, D] × [D, V]`` over the full vocabulary, tiled onto the coded block
grid.  Runs on the card; ``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/private_inference_torch.py [--device cpu]
"""
import argparse
import sys

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.mpc import MPCSpec, connect  # noqa: E402
from repro_torch.mpc.field import resolve_device  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
dev = resolve_device(ap.parse_args().device)

cfg = reduced(get_config("llama3.2-1b"))
params = tr.init_params(cfg, 0, device=dev)
gen = torch.Generator(device=dev)
gen.manual_seed(1)
toks = torch.randint(0, cfg.vocab, (1, 8), generator=gen, device=dev)

hidden, _ = tr.forward(cfg, params, toks)
h_last = hidden[0, -1:].double()                      # [1, D]
head = params.embed.T.double().contiguous()           # tied head [D, V]
logits_plain = h_last @ head

# MPC logits: one session matmul, rectangular [1, D] x [D, V] end to end
sess = connect(MPCSpec(s=2, t=2, z=2), device=dev)
logits_mpc = sess.matmul(h_last, head, key=2)

assert logits_mpc.shape == logits_plain.shape == (1, cfg.vocab)
err = float((logits_mpc - logits_plain).abs().max())
print(f"all {cfg.vocab} logits via AGE-CMPC on {dev} ([1,{cfg.d_model}]x"
      f"[{cfg.d_model},{cfg.vocab}] in {sess.stats['blocks']} coded blocks): "
      f"max |Δ| = {err:.4f}")
assert err < 0.1
top_mpc, top_plain = int(logits_mpc[0].argmax()), int(logits_plain[0].argmax())
assert top_mpc == top_plain, (top_mpc, top_plain)
print(f"greedy next token matches plaintext: {top_mpc}")
print("private inference OK — workers saw only secret shares")
