"""The out-of-process transport on the port (``repro_torch.transport``,
``connect(spec, backend="remote", device="cpu")``): every case of
``tests/test_transport.py`` against the port, with torch CPU tensors
riding the wire where the reference sends jax arrays, and the port held
against the JAX package: remote ≡ torch local ≡ JAX local, integer-equal,
across schemes × primes, survivor masks, pipelined and barriered; a
block's I-points equal to the local ``front`` for the same key; the
kill-mid-flush cases with the same ``stats`` as JAX's remote backend; the
fault-schedule file driving both consumers; the recorder's wire samples;
one block crossing the wire between the two packages in each direction;
and process mode with the smallest spec the port accepts."""
import socket
import sys
import threading

import numpy as np
import pytest
import torch

from repro.mpc import Field as JField
from repro.mpc import MPCSpec as JSpec
from repro.mpc import connect as jconnect
from repro.sim.trace import PhaseRecorder as JRecorder
from repro.transport import worker as j_worker
from repro_torch.kernels import _build
from repro_torch.mpc import P_DEFAULT, P_MERSENNE31, Field, MPCSpec, connect
from repro_torch.mpc.api import BlockOp
from repro_torch.mpc.byzantine import FaultInjector
from repro_torch.mpc.field import generator
from repro_torch.mpc.protocol import AGECMPCProtocol
from repro_torch.sim.trace import PhaseRecorder
from repro_torch.transport import Dealer, TransportClosed, recv_msg, run_blocks
from repro_torch.transport import send_msg
from repro_torch.transport import worker as t_worker
from repro_torch.transport.framing import MAX_HEADER_BYTES

SCHEMES = ["age", "entangled", "polydot"]
PRIMES = [P_DEFAULT, P_MERSENNE31]


def exact_matmul(a, b, p):
    return np.array((a.astype(object) @ b.astype(object)) % p, np.int64)


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jspec(spec, **kw):
    """The JAX twin of a port spec."""
    return JSpec(s=spec.s, t=spec.t, z=spec.z, scheme=spec.scheme,
                 field=JField(spec.field.p, spec.field.frac_bits), **kw)


def _remote_pair(spec, **opts):
    """A (torch local, torch remote) session pair over one spec."""
    return (connect(spec, device="cpu"),
            connect(spec, backend="remote", device="cpu", **opts))


# ================================================================ framing
class TestFraming:
    def _pair(self):
        return socket.socketpair()

    def test_meta_and_arrays_round_trip(self):
        ours, theirs = self._pair()
        arrs = {"g": np.arange(12, dtype=np.int64).reshape(3, 4),
                "i": np.array([[2**62, 0], [1, -5]], dtype=np.int64)}
        send_msg(ours, {"kind": "x", "block": 7}, arrs)
        meta, got = recv_msg(theirs, timeout=5.0)
        assert meta["kind"] == "x" and meta["block"] == 7
        assert sorted(got) == ["g", "i"]
        for k in arrs:
            assert got[k].dtype == np.int64
            np.testing.assert_array_equal(got[k], arrs[k])
        ours.close(), theirs.close()

    def test_empty_payload_frame(self):
        ours, theirs = self._pair()
        send_msg(ours, {"kind": "stop"})
        meta, got = recv_msg(theirs, timeout=5.0)
        assert meta == {"kind": "stop"} and got == {}
        ours.close(), theirs.close()

    def test_many_frames_stay_ordered(self):
        ours, theirs = self._pair()
        for i in range(20):
            send_msg(ours, {"n": i}, {"a": np.full((2, 2), i, np.int64)})
        for i in range(20):
            meta, got = recv_msg(theirs, timeout=5.0)
            assert meta["n"] == i and int(got["a"][0, 0]) == i
        ours.close(), theirs.close()

    def test_oversized_header_refused_at_send(self):
        from repro_torch.mpc.errors import InvariantError

        ours, theirs = self._pair()
        with pytest.raises(InvariantError, match="header"):
            send_msg(ours, {"pad": "x" * (MAX_HEADER_BYTES + 1)})
        ours.close(), theirs.close()

    def test_recv_timeout_propagates(self):
        ours, theirs = self._pair()
        with pytest.raises(socket.timeout):
            recv_msg(theirs, timeout=0.05)
        ours.close(), theirs.close()

    def test_peer_close_raises_transport_closed(self):
        ours, theirs = self._pair()
        ours.close()
        with pytest.raises(TransportClosed):
            recv_msg(theirs, timeout=5.0)
        theirs.close()

    def test_torch_tensors_ride_the_same_wire(self):
        ours, theirs = self._pair()
        send_msg(ours, {"kind": "x"},
                 {"a": torch.arange(6).reshape(2, 3),
                  "b": torch.arange(8).reshape(2, 4)[:, 1:3]})  # a view
        _, got = recv_msg(theirs, timeout=5.0)
        np.testing.assert_array_equal(got["a"], np.arange(6).reshape(2, 3))
        np.testing.assert_array_equal(got["b"],
                                      np.arange(8).reshape(2, 4)[:, 1:3])
        ours.close(), theirs.close()


# ====================================================== loopback parity
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("p", PRIMES)
def test_remote_integer_equal_to_local_and_jax(scheme, p):
    """The acceptance sweep: loopback remote decode == the port's local
    decode == JAX's local decode, integer-equal, across schemes × primes."""
    spec = MPCSpec(s=2, t=2, z=1, scheme=scheme, field=Field(p))
    loc, rem = _remote_pair(spec)
    rng = np.random.default_rng(hash((scheme, p)) % 2**31)
    a = rng.integers(0, p, (5, 7))
    b = rng.integers(0, p, (7, 4))
    try:
        y_rem = N(rem.matmul(a, b, encoded=True))
    finally:
        rem.backend.close()
    np.testing.assert_array_equal(y_rem, N(loc.matmul(a, b, encoded=True)))
    np.testing.assert_array_equal(
        y_rem, N(jconnect(jspec(spec)).matmul(a, b, encoded=True)))
    np.testing.assert_array_equal(y_rem, exact_matmul(a, b, p))


@pytest.mark.parametrize("drop", [0, 2])
def test_remote_integer_equal_under_survivor_masks(drop):
    spec = MPCSpec(s=2, t=2, z=1)
    n, p = spec.n_workers, spec.field.p
    mask = np.ones(n, bool)
    mask[drop] = False
    loc, rem = _remote_pair(spec)
    rng = np.random.default_rng(drop)
    a = rng.integers(0, p, (6, 6))
    b = rng.integers(0, p, (6, 6))
    try:
        y_rem = N(rem.matmul(a, b, encoded=True, survivors=mask))
    finally:
        rem.backend.close()
    np.testing.assert_array_equal(
        y_rem, N(loc.matmul(a, b, encoded=True, survivors=mask)))
    np.testing.assert_array_equal(y_rem, N(jconnect(jspec(spec)).matmul(
        a, b, encoded=True, survivors=mask)))
    np.testing.assert_array_equal(y_rem, exact_matmul(a, b, p))


@pytest.mark.parametrize("pipelined", [True, False])
def test_remote_multi_block_parity(pipelined):
    """Several blocks through the double-buffered window (or one at a time,
    barriered) decode as serial local serving does in both packages, on
    the fixed-point path."""
    spec = MPCSpec(s=2, t=2, z=1)
    loc, rem = _remote_pair(spec, pipelined=pipelined)
    jloc = jconnect(jspec(spec))
    rng = np.random.default_rng(11)
    pairs = [(rng.standard_normal((8, 8)), rng.standard_normal((8, 8)))
             for _ in range(4)]
    try:
        for a, b in pairs:
            y = N(rem.matmul(a, b))
            np.testing.assert_array_equal(y, N(loc.matmul(a, b)))
            np.testing.assert_array_equal(y, N(jloc.matmul(a, b)))
        # several blocks of one call in flight together
        a, b = rng.integers(0, spec.field.p, (2, 16, 16))
        y = N(rem.matmul(a, b, encoded=True, m=6))
        np.testing.assert_array_equal(y, exact_matmul(a, b, spec.field.p))
        np.testing.assert_array_equal(y, N(loc.matmul(a, b, encoded=True,
                                                      m=6)))
        np.testing.assert_array_equal(y, N(jloc.matmul(a, b, encoded=True,
                                                       m=6)))
        assert rem.backend.stats["blocks"] >= 4 + 9
    finally:
        rem.backend.close()


def test_remote_barriered_mode_matches_pipelined():
    spec = MPCSpec(s=2, t=2, z=1)
    rng = np.random.default_rng(12)
    a = rng.integers(0, spec.field.p, (6, 6))
    b = rng.integers(0, spec.field.p, (6, 6))
    rem_p = connect(spec, backend="remote", pipelined=True, device="cpu")
    rem_b = connect(spec, backend="remote", pipelined=False, device="cpu")
    try:
        np.testing.assert_array_equal(
            N(rem_p.matmul(a, b, encoded=True)),
            N(rem_b.matmul(a, b, encoded=True)))
    finally:
        rem_p.backend.close(), rem_b.backend.close()


@pytest.mark.parametrize("pipelined", [True, False])
def test_block_ipoints_equal_local_front(pipelined):
    """The dealer draws the secrets and then the aggregate mask from the
    block's generator at once, in both modes, as the local stages do: the
    I-points it scatters equal ``front``'s for the same key, and a shared
    generator ends in the same state."""
    proto = AGECMPCProtocol(s=2, t=2, z=2, m=8)
    p, n = proto.field.p, proto.n_workers
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.integers(0, p, (8, 8))) for _ in range(2))
    dealer = Dealer(proto, device="cpu")
    sent = {}
    send = dealer.send

    def spy(slot, meta, arrays=None):
        if meta.get("kind") == "ipoint":
            sent[slot] = arrays["i"].copy()
        send(slot, meta, arrays)

    dealer.send = spy
    gen = generator(9, "cpu")
    try:
        outs, stats = run_blocks(
            dealer, [BlockOp(proto=proto, a=a, b=b, key=gen, survivors=None)],
            pipelined=pipelined)
    finally:
        dealer.close()
    # close() joins the stopped worker threads: none is left inside torch
    # when the interpreter exits
    assert len(dealer._threads) == n
    assert not any(th.is_alive() for th in dealer._threads)
    ref_gen = generator(9, "cpu")
    want = proto.plan.stages("cpu").front(a, b, ref_gen)
    np.testing.assert_array_equal(np.stack([sent[s] for s in range(n)]),
                                  want.numpy())
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    np.testing.assert_array_equal(
        outs[0].numpy(), exact_matmul(a.numpy().T, b.numpy(), p))
    assert stats["phase3_absorbed"] == 0 and stats["dealer_us"] > 0


def test_remote_rejects_byzantine_specs_at_connect():
    spec = MPCSpec(s=2, t=2, z=2, adversaries=1)
    with pytest.raises(ValueError, match="remote backend does not verify"):
        connect(spec, backend="remote", device="cpu")
    with pytest.raises(ValueError, match="remote backend does not verify"):
        connect(MPCSpec(s=2, t=2, z=2), backend="remote", device="cpu",
                injector=FaultInjector(seed=1, rate=1.0))


def test_remote_runs_on_the_card_by_default():
    """Without ``device=`` the remote backend resolves the card, and raises
    where there is none: it never falls back to the CPU quietly."""
    spec = MPCSpec(s=2, t=2, z=1)
    if torch.cuda.is_available():
        sess = connect(spec, backend="remote")
        assert sess.device.type == "cuda"
        assert sess.backend.device == sess.device
        sess.backend.close()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            connect(spec, backend="remote")
    assert connect(spec, backend="remote", device="cpu").backend.device \
        == torch.device("cpu")


# ================================================= one wire, two packages
def test_port_dealer_serves_jax_workers(monkeypatch):
    """The port's dealer drives the reference's ``worker_main`` threads:
    JAX workers compute the G rows, the port encodes, sums and decodes."""
    monkeypatch.setattr(t_worker, "worker_main",
                        lambda sock, device: j_worker.worker_main(sock))
    spec = MPCSpec(s=2, t=2, z=1)
    rng = np.random.default_rng(61)
    a = rng.integers(0, spec.field.p, (6, 6))
    b = rng.integers(0, spec.field.p, (6, 6))
    rem = connect(spec, backend="remote", device="cpu")
    try:
        y = N(rem.matmul(a, b, encoded=True, m=6))
    finally:
        rem.backend.close()
    np.testing.assert_array_equal(y, exact_matmul(a, b, spec.field.p))
    assert rem.backend.stats["blocks"] == 1


def test_jax_dealer_serves_port_workers(monkeypatch):
    """The reference's dealer drives the port's ``worker_main(…, "cpu")``
    threads: the port's workers compute the G rows on torch."""
    monkeypatch.setattr(j_worker, "worker_main",
                        lambda sock: t_worker.worker_main(sock, "cpu"))
    spec = JSpec(s=2, t=2, z=1)
    rng = np.random.default_rng(62)
    a = rng.integers(0, spec.field.p, (6, 6))
    b = rng.integers(0, spec.field.p, (6, 6))
    rem = jconnect(spec, backend="remote")
    try:
        y = np.asarray(rem.matmul(a, b, encoded=True, m=6))
    finally:
        rem.backend.close()
    np.testing.assert_array_equal(y, exact_matmul(a, b, spec.field.p))
    assert rem.backend.stats["blocks"] == 1


def test_worker_g_row_equals_reference_numpy():
    """A worker's G row (one K = 1 ``polyeval``) is integer-equal to the
    reference worker's NumPy product ``(c_{n,·} ⊗ vec H) mod p``."""
    proto = AGECMPCProtocol(s=2, t=2, z=2, m=8)
    plan, p = proto.plan, proto.field.p
    rng = np.random.default_rng(3)
    f_a = rng.integers(0, p, (4, 4))
    f_b = rng.integers(0, p, (4, 4))
    for slot in (0, 7, plan.n_workers - 1):
        g_col = torch.from_numpy(plan.g_mix[slot].reshape(-1, 1).copy())
        got = t_worker.g_row(plan.stages("cpu"), g_col, torch.from_numpy(f_a),
                             torch.from_numpy(f_b), p).numpy()
        h = exact_matmul(f_a, f_b, p).reshape(1, -1)
        want = (plan.g_mix[slot].astype(np.int64)[:, None] * h) % p
        np.testing.assert_array_equal(got, want)


# ============================================================= recorder
def test_recorder_collects_wire_phase_samples():
    """The driver feeds measured per-phase/per-device samples through the
    PhaseRecorder hook, in the shape ``sim.calibrate`` fits, with the same
    ``(device, klass, phase, scalars)`` rows as JAX's remote backend."""
    spec = MPCSpec(s=2, t=2, z=1)
    rng = np.random.default_rng(41)
    a = rng.integers(0, spec.field.p, (6, 6))
    b = rng.integers(0, spec.field.p, (6, 6))
    rows = {}
    for which, rec in (("torch", PhaseRecorder()), ("jax", JRecorder())):
        if which == "torch":
            rem = connect(spec, backend="remote", recorder=rec, device="cpu")
        else:
            rem = jconnect(jspec(spec), backend="remote", recorder=rec)
        try:
            rem.matmul(a, b, encoded=True)
        finally:
            rem.backend.close()
        rows[which] = sorted((s.device, s.klass, s.phase, s.scalars, s.lanes)
                             for s in rec.samples)
        phases = {s.phase for s in rec.samples}
        assert {"encode", "compute", "exchange", "decode"} <= phases
        per_dev = [s for s in rec.samples
                   if s.phase in ("compute", "exchange")]
        assert {s.device for s in per_dev} == set(range(spec.n_workers))
        for s in rec.samples:
            assert s.scalars > 0 and s.us >= 0.0
            assert s.klass == spec.scheme
    assert rows["torch"] == rows["jax"]


# ============================================================ processes
def test_remote_process_spawn_parity():
    """``spawn="process"``: N spawned processes on the CPU, with the
    smallest spec the port accepts (s=2, t=1, z=1: N = 5), integer-equal
    to both packages' local decode."""
    spec = MPCSpec(s=2, t=1, z=1)
    assert spec.n_workers == 5
    loc, rem = _remote_pair(spec, spawn="process")
    rng = np.random.default_rng(51)
    a = rng.integers(0, spec.field.p, (6, 6))
    b = rng.integers(0, spec.field.p, (6, 6))
    try:
        y = N(rem.matmul(a, b, encoded=True))
        dealer = next(iter(rem.backend._dealers.values()))
        procs = [ln._process for ln in dealer.links.values()]
    finally:
        rem.backend.close()
    np.testing.assert_array_equal(y, N(loc.matmul(a, b, encoded=True)))
    np.testing.assert_array_equal(
        y, np.asarray(jconnect(jspec(spec)).matmul(a, b, encoded=True)))
    assert len(procs) == 5 and not any(pr.is_alive() for pr in procs)
    # each process reported its counters on exit, outside the wire: on
    # the CPU the wrappers ran their plain versions, so nothing launched
    reports = dealer.worker_reports()
    assert [r["slot"] for r in reports] == list(range(5))
    assert all(r["device"] == "cpu" and not any(r["launches"].values())
               for r in reports)



def test_launch_counters_survive_concurrent_workers():
    """The remote backend's worker threads launch kernels concurrently:
    the wrappers' counters must lose no update (stress: more threads than
    cores, a short switch interval)."""
    def fn():
        pass

    fn.launches, fn.instances = 0, {"tensor_core": 0}
    threads, per = 32, 2000

    def hammer():
        for _ in range(per):
            _build.count(fn, "tensor_core")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=hammer) for _ in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in pool)
    assert fn.launches == fn.instances["tensor_core"] == threads * per


def test_scripted_stall_ends_when_the_dealer_hangs_up():
    """A stalled worker stops stalling once its link is closed (eviction,
    ``close``), so no stalled thread outlives its dealer; a frame queued
    behind the stall (a retry) does not end it."""
    import time

    chaos = t_worker._Chaos()
    chaos.update({"stall_block": 3, "stall_s": 30.0})
    ours, theirs = socket.socketpair()
    send_msg(ours, {"kind": "shares", "block": 3})      # a queued retry
    threading.Timer(0.3, ours.close).start()
    t0 = time.monotonic()
    with pytest.raises(TransportClosed, match="hung up"):
        chaos.maybe_stall(3, theirs)
    assert 0.25 < time.monotonic() - t0 < 5.0
    chaos.maybe_stall(4, theirs)                         # other blocks: no stall
    theirs.close()
