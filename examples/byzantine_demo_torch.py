"""Byzantine-robust serving on the PyTorch/CUDA port: give the spec an
adversary budget, let a seeded fault injector tamper with worker shares
every round, and watch the session decode the exact product anyway,
localizing the liars by their failed MACs, evicting them like crashed
devices, and refusing when the corruption exceeds the budget.  The same
schedule runs through the local and the batched backend.  Runs on the
card; ``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/byzantine_demo_torch.py [--device cpu]
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch.mpc import FaultInjector, MPCSpec, QuorumError, connect  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
dev = ap.parse_args().device

# a=2 raises the decode quorum from t²+z = 6 to t²+z+2a = 10: the 2a extra
# MAC-checked shares let the master localize up to two liars per round
spec = MPCSpec(s=2, t=2, z=2, m=8, adversaries=2)
print(f"spec: {spec.scheme} s={spec.s} t={spec.t} z={spec.z} a=2 -> "
      f"N={spec.n_workers}, quorum {spec.recovery_threshold} -> "
      f"{spec.verified_threshold}")

rng = np.random.default_rng(0)
p = spec.field.p
a = rng.integers(0, p, (16, 16))
b = rng.integers(0, p, (16, 16))
want = np.array((a.astype(object) @ b.astype(object)) % p, np.int64)

for backend in ("local", "batched"):
    # workers 3 and 9 lie every round
    injector = FaultInjector(
        seed=7, schedule={r: [(3, "tamper"), (9, "flip")] for r in range(64)})
    sess = connect(spec, backend=backend, injector=injector, device=dev)
    y = sess.matmul(a, b, encoded=True).cpu().numpy()
    assert np.array_equal(y, want), "corrupted serving diverged"
    print(f"{backend} on {sess.device}: exact under {len(injector.log)} "
          f"injected corruptions: {sess.stats['corrections']} shares "
          f"corrected, liars {sorted(sess._dead)} evicted "
          f"({sess.stats['evicted_devices']} devices)")
    y2 = sess.matmul(a, b, encoded=True).cpu().numpy()
    assert np.array_equal(y2, want), "post-eviction serving diverged"
    print(f"  post-eviction round exact; evicted devices still "
          f"{sess.stats['evicted_devices']}")

# beyond the budget the decode refuses; it never lies
flood = FaultInjector(
    seed=11, schedule={0: [(1, "tamper"), (5, "tamper"), (11, "tamper")]})
angry = connect(spec, backend="local", injector=flood, device=dev)
try:
    angry.matmul(a, b, encoded=True)
    raise SystemExit("over-budget corruption was not detected")
except QuorumError as e:
    print(f"three liars vs budget two -> refused: {e}")
print("byzantine demo OK")
