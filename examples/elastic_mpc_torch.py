"""Elastic worker pools on the PyTorch/CUDA port: spares, phase-2
failures, re-planning, and batched serving with per-request dropout, all
through the session API (``repro_torch.mpc.connect``).  Runs on the card;
``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/elastic_mpc_torch.py [--device cpu]
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch.mpc import MPCSpec, connect  # noqa: E402
from repro_torch.mpc.elastic import ElasticPool  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
dev = ap.parse_args().device

spec = MPCSpec(s=2, t=2, z=2, m=8)
pool = ElasticPool.from_spec(spec, spares=3)
n = spec.n_workers
print(f"plan: N={n} workers + {pool.spares} spares; "
      f"phase-3 tolerance {pool.phase3_tolerance()} failures")
print(f"pool alphas extend the plan's invertible set: "
      f"{pool._alphas[:n].tolist()} + spares {pool._alphas[n:].tolist()}")

# lose two workers BEFORE the exchange: spares absorb them, and the quorum
# weights come out of the plan's survivor-solve LRU
pool.fail([0, 7])
idx, _ = pool.reconstruction_weights()
print(f"after 2 failures: quorum from workers {idx[:5].tolist()}... "
      f"(spares activated: {sorted(set(idx.tolist()) - set(range(n)))}); "
      f"solve cache {pool.proto.plan.solve_cache_info()}")

# batched serving with heterogeneous per-request dropout: one engine flush
sess = connect(spec, backend="batched", spares=3, max_batch=16, device=dev)
rng = np.random.default_rng(0)
p = spec.field.p
expected = {}
for i in range(8):
    a = rng.integers(0, p, (8, 8))
    b = rng.integers(0, p, (8, 8))
    surv = None
    if i % 2:  # every other request loses a random straggler set
        surv = np.ones(n, bool)
        surv[rng.choice(n, pool.phase3_tolerance(), replace=False)] = False
    rid = sess.submit(a, b, key=i, survivors=surv, encoded=True)
    expected[rid] = np.array(
        (a.astype(object) @ b.astype(object)) % p, np.int64)
results = sess.flush()
ok = all(np.array_equal(results[r].cpu().numpy(), expected[r])
         for r in expected)
print(f"session on {sess.device}: 8 mixed-dropout requests -> "
      f"{len(results)} correct={ok}; engine stats {sess.backend.engine.stats}")

# catastrophic loss: below N, the engine re-tunes (then replans) to a
# coarser code that the survivors can run
sess.fail(list(range(1, 14)))
a = rng.integers(0, p, (8, 8))
b = rng.integers(0, p, (8, 8))
y = sess.matmul(a, b, key=42, encoded=True)
ok = np.array_equal(y.cpu().numpy(), np.array(
    (a.astype(object) @ b.astype(object)) % p, np.int64))
print(f"after losing 13 workers: re-tuned and served correct={ok}; "
      f"engine stats {sess.backend.engine.stats}")
