"""Out-of-process transport demo on the PyTorch/CUDA port: run the N
workers of a plan behind the framed socket transport on the card, check
the remote decode is integer-equal to the in-process backend, kill a
worker mid-flush and watch the flush degrade into the elastic replan path
instead of hanging, then A/B the pipelined driver against the
phase-barriered one over a simulated 10 ms wire.  ``--device cpu`` runs
it on the CPU.

    PYTHONPATH=src python examples/transport_demo_torch.py [--device cpu]
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch.mpc import MPCSpec, connect  # noqa: E402
from repro_torch.mpc.protocol import AGECMPCProtocol  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
dev = ap.parse_args().device


def host(y):
    return y.cpu().numpy()


# ---- 1. loopback remote workers are integer-equal to local --------------
spec = MPCSpec(s=2, t=2, z=1)
p = spec.field.p
print(f"spec: {spec.scheme} s={spec.s} t={spec.t} z={spec.z} -> "
      f"N={spec.n_workers} remote workers")

rng = np.random.default_rng(0)
a = rng.integers(0, p, (12, 12))
b = rng.integers(0, p, (12, 12))
want = np.array((a.astype(object) @ b.astype(object)) % p, np.int64)

loc = connect(spec, device=dev)
rem = connect(spec, backend="remote", device=dev)  # loopback worker threads
print(f"device: {rem.device}")
y_loc = host(loc.matmul(a, b, encoded=True, m=6))
y_rem = host(rem.matmul(a, b, encoded=True, m=6))
if not (np.array_equal(y_rem, y_loc) and np.array_equal(y_rem, want)):
    raise SystemExit("remote decode differs from the in-process backend")
print("remote decode integer-equal to the in-process backend")

# ---- 2. a worker dies mid-flush: replan, not hang -----------------------
# a phase-2 death (the G contribution never leaves) forces the elastic
# path: fail_devices -> retune/replan -> re-dispatch, still exact
proto = AGECMPCProtocol.from_spec(spec, m=6)
rem.backend.chaos(proto, 2, die_block=0, die_after="shares")
y = host(rem.matmul(a, b, encoded=True, m=6))
if not np.array_equal(y, want):
    raise SystemExit("post-death serving diverged")
st = rem.backend.stats
print(f"worker 2 killed mid-flush -> phase_losses={st['phase_losses']}, "
      f"redispatches={st['redispatches']}, result exact")
rem.backend.close()

# ---- 3. pipelined vs phase-barriered over a simulated 10 ms wire --------
m, blocks = 32, 6
ops = [(rng.integers(0, p, (m, m)), rng.integers(0, p, (m, m)))
       for _ in range(blocks)]
wants = [np.array((x.astype(object) @ y.astype(object)) % p, np.int64)
         for x, y in ops]


def flush_once(sess):
    for x, y in ops:
        sess.submit(x, y, encoded=True, m=m)
    t0 = time.perf_counter()
    outs = sess.flush()
    vals = [host(outs[rid]) for rid in sorted(outs)]
    dt = time.perf_counter() - t0
    for v, w in zip(vals, wants, strict=True):
        if not np.array_equal(v, w):
            raise SystemExit("a flushed block is not exact")
    return dt


results = {}
for label, pipelined in (("pipelined", True), ("barriered", False)):
    sess = connect(spec, backend="remote", pipelined=pipelined,
                   delay_s=0.010, device=dev)
    flush_once(sess)  # warm-up: spawn, plan tables, kernel libraries
    results[label] = min(flush_once(sess) for _ in range(2))
    sess.backend.close()

ratio = results["barriered"] / results["pipelined"]
print(f"{blocks} blocks over a 10 ms wire: "
      f"pipelined {results['pipelined'] * 1e3:.0f} ms vs "
      f"barriered {results['barriered'] * 1e3:.0f} ms "
      f"({ratio:.2f}x from overlap)")

print("transport demo OK")
