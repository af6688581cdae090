"""Quickstart on the PyTorch/CUDA port: AGE-CMPC in 40 lines.

Two sources hold private matrices A and B; N workers jointly compute
their product without any z-subset of them learning anything about A or B.
Runs on the card; ``--device cpu`` runs the same code on the CPU.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch.core import all_worker_counts, optimal_age_code  # noqa: E402
from repro_torch.mpc import AGECMPCProtocol, MPCSpec, connect  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
dev = ap.parse_args().device

# 1. Plan: how many edge workers does each scheme need? (paper Fig. 2 cell)
s, t, z = 2, 2, 2
print("worker counts:", all_worker_counts(s, t, z))
code, lam = optimal_age_code(s, t, z)
print(f"AGE picks gap λ*={lam}: N={code.n_workers}, "
      f"decode threshold t²+z={code.recovery_threshold}")

# 2. One spec, one session, floats in / floats out, any shapes.
spec = MPCSpec(s=s, t=t, z=z)
sess = connect(spec, device=dev)           # backend="local" | "batched"
rng = np.random.default_rng(0)
a = rng.standard_normal((16, 16))
b = rng.standard_normal((16, 16))
y = sess.matmul(a, b).cpu().numpy()
print(f"on {sess.device}: max |Y - AB| =", float(np.abs(y - a @ b).max()))
yr = sess.matmul(rng.standard_normal((3, 20)), rng.standard_normal((20, 5)))
print("rectangular [3,20]x[20,5] ->", tuple(yr.shape))

# 3. Coded fault tolerance: kill workers down to the threshold, same answer.
surv = np.zeros(spec.n_workers, bool)
surv[np.arange(spec.recovery_threshold)] = True
y2 = sess.matmul(a, b, survivors=surv).cpu().numpy()
print(f"decode from only {spec.recovery_threshold}/{spec.n_workers} "
      f"workers: max err {float(np.abs(y2 - a @ b).max()):.4f}")

# 4. The protocol object computes AᵀB on square field-encoded blocks.
proto = AGECMPCProtocol.from_spec(spec, m=16)
f = proto.field
y3 = proto.run(f.encode(a), f.encode(b), 0, device=sess.device)
y3 = f.decode(y3, products=2).cpu().numpy()
print("protocol.run (Y = AᵀB): max |Y - AᵀB| =",
      float(np.abs(y3 - a.T @ b).max()))
