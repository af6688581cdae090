"""Fleet simulator demo on the PyTorch/CUDA port, the twin of
``examples/fleet_sim_demo.py``: tune over a 1000-device skewed fleet,
replay tuned vs capacity-oblivious placement through the discrete-event
simulator, survive an attrition + Byzantine schedule, close the
calibration loop from the replay's own phase trace (leg 4, as the
reference runs it, with the bench-derived cost model), run the divergence
gate.  Two legs are the port's own: 4b closes the same loop against the
default cost weights, and 6 feeds the calibration live samples: the tuned
spec served by the remote backend on the card, its measured per-device
wire and compute times fitted into class multipliers.  ``--device cpu``
runs the live leg on the CPU.

Leg 4 misses the planted multipliers on the bench-derived model, as the
reference's does (its assert fails there); the twin reports the miss,
runs the remaining legs and exits 1.

    PYTHONPATH=src python examples/fleet_sim_demo_torch.py [--device cpu]
"""
import argparse
import dataclasses
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch.mpc import connect  # noqa: E402
from repro_torch.mpc.autotune import CostModel, predicted_makespan, tune  # noqa: E402
from repro_torch.sim import (  # noqa: E402
    ArrivalTrace,
    FleetEvent,
    FleetModel,
    PhaseRecorder,
    calibrate,
    predict,
    replay,
)
from repro_torch.sim.divergence import gate, skewed_fleet_pool  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default=None,
                help="torch device of the live leg (default: the card)")
dev = ap.parse_args().device

# ---- 1. a 1000-device fleet: 960 phones + 40 gateways -------------------
pool = skewed_fleet_pool(1000)
print(f"fleet: {pool.describe()} ({len(pool)} devices)")
cost = CostModel.from_bench("BENCH_PROTOCOL.json")
res = tune(pool=pool, z=2, shape=(96, 96, 96), cost=cost)
spec = res.spec
print(f"tuned: {spec.scheme} s={spec.s} t={spec.t} N={spec.n_workers} "
      f"m={spec.m}; placement classes: "
      f"{sorted({pool[d].name for d in spec.placement})}")

# ---- 2. replay tuned vs capacity-oblivious at fleet scale ---------------
# a closed burst keeps the fleet saturated, so the makespan gap IS the
# placement gap; an open poisson trace (leg 3) measures fault behavior
trace = ArrivalTrace.burst(64)
oblivious = dataclasses.replace(spec,
                                placement=tuple(range(spec.n_workers)))
reports = {}
for label, sp in (("tuned", spec), ("oblivious", oblivious)):
    fleet = FleetModel(pool, jitter=0.03, seed=3)
    reports[label] = replay(sp, trace, cost=cost, fleet=fleet)
tuned, obl = reports["tuned"], reports["oblivious"]
print(f"replayed makespan: tuned {tuned.makespan_us:.3e}µs vs oblivious "
      f"{obl.makespan_us:.3e}µs ({obl.makespan_us / tuned.makespan_us:.1f}x "
      f"win, {tuned.waves} waves for {len(trace)} requests)")
if not tuned.makespan_us < obl.makespan_us:
    raise SystemExit("replay must reproduce the cost model's placement "
                     "ranking")
pred = predict(spec, trace, cost=cost)
print(f"predicted {pred.makespan_us:.3e}µs -> replayed/predicted ratio "
      f"{tuned.makespan_us / pred.makespan_us:.3f}")

# ---- 3. attrition + Byzantine schedule over an open arrival trace ------
open_trace = ArrivalTrace.poisson(64, rate_rps=40.0, seed=7)
quorum = spec.placement[: spec.t * spec.t + spec.z]
faulty = open_trace.with_faults(
    FleetEvent(at_us=0.0, device=int(quorum[0]), kind="fail"),
    FleetEvent(at_us=0.0, device=int(quorum[1]), kind="corrupt"))
byz_spec = dataclasses.replace(spec, adversaries=1)
fleet = FleetModel(pool, jitter=0.03, seed=3)
rep = replay(byz_spec, faulty, cost=cost, fleet=fleet)
print(f"under faults: served {rep.served}/{len(trace)}, "
      f"replans={rep.replans}, corrections={rep.corrections}, "
      f"evictions={rep.evictions}")
if rep.served != len(trace) or rep.evictions < 1:
    raise SystemExit("the fault schedule was not survived")

# ---- 4. close the loop: calibrate from the replay's own trace ----------
# as the reference demo does: the same bench-derived model, the same check
planted = {"phone": (1.8, 1.4, 2.2)}
drifted = FleetModel(pool, class_multipliers=planted, jitter=0.02, seed=5)
measured = replay(oblivious, trace, cost=cost, fleet=drifted)
cal = calibrate(measured.samples, pool, cost)
got = cal.multipliers["phone"]
print(f"planted phone multipliers {planted['phone']} -> recovered "
      f"({got[0]:.2f}, {got[1]:.2f}, {got[2]:.2f}) "
      f"from {cal.samples_used} phase samples")
leg4_ok = all(abs(g - p) / p < 0.15
              for g, p in zip(got, planted["phone"], strict=True))
if leg4_ok:
    before = predicted_makespan(oblivious, cost=cost)
    after = predicted_makespan(oblivious, cost=cal.cost)
    print(f"recalibrated model: oblivious block makespan {before:.3e} -> "
          f"{after:.3e}µs (now tracks the measured fleet)")
else:
    # examples/fleet_sim_demo.py fails its assert here on the same numbers
    print(f"leg 4 MISSED the planted multipliers, as the reference demo "
          f"does: BENCH_PROTOCOL.json prices neither xi nor zeta, so the "
          f"bench-derived model weighs computation at {cost.computation} "
          f"and communication at {cost.communication} and the fit cannot "
          f"see those axes; the legs below run on, then the demo exits 1")

# ---- 4b. (not in the reference) the same loop on the default weights ---
default = CostModel()
measured = replay(oblivious, trace, cost=default, fleet=drifted)
cal = calibrate(measured.samples, pool, default)
got = cal.multipliers["phone"]
print(f"4b, default weights: planted {planted['phone']} -> recovered "
      f"({got[0]:.2f}, {got[1]:.2f}, {got[2]:.2f}) "
      f"from {cal.samples_used} phase samples")
if not all(abs(g - p) / p < 0.15
           for g, p in zip(got, planted["phone"], strict=True)):
    raise SystemExit("calibration missed the planted multipliers on the "
                     "default weights")
before = predicted_makespan(oblivious, cost=default)
after = predicted_makespan(oblivious, cost=cal.cost)
print(f"4b, recalibrated model: oblivious block makespan {before:.3e} -> "
      f"{after:.3e}µs (now tracks the measured fleet)")

# ---- 5. the divergence gate, end to end --------------------------------
report = gate(seed=0)
if not report.ok:
    raise SystemExit(f"divergence gate failed: {report.describe()}")
print("divergence gate OK: "
      + ", ".join(f"{e.label} ratio {e.ratio:.3f}" for e in report.entries))

# ---- 6. (not in the reference) live samples over the transport ---------
# the tuned spec served by the remote backend, which records each placed device's measured compute and
# wire time under its roster class; calibrate fits them like a replay's
rec = PhaseRecorder()
rem = connect(spec, backend="remote", recorder=rec, device=dev)
rng = np.random.default_rng(0)
p = spec.field.p
a = rng.integers(0, p, (spec.m, 2 * spec.m))
b = rng.integers(0, p, (2 * spec.m, spec.m))
try:
    y = rem.matmul(a, b, encoded=True, m=spec.m)
finally:
    rem.backend.close()
want = np.array((a.astype(object) @ b.astype(object)) % p, np.int64)
if not np.array_equal(y.cpu().numpy(), want):
    raise SystemExit("the remote product is not exact")
live = calibrate(rec.samples, pool, default)
print(f"live on {rem.device}: {len(rec)} samples from "
      f"{rem.backend.stats['blocks']} blocks, exact; fitted (xi, sigma, "
      f"zeta) multipliers "
      + ", ".join(f"{k} ({v[0]:.3g}, {v[1]:.3g}, {v[2]:.3g})"
                  for k, v in sorted(live.multipliers.items())))
if not leg4_ok:
    raise SystemExit("fleet sim demo: leg 4 missed the planted multipliers "
                     "(as examples/fleet_sim_demo.py does)")
print("fleet sim demo OK")
