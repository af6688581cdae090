"""``compressed_psum`` on four gloo ranks against JAX's under ``shard_map``.

The JAX side runs as ``tests/test_substrate.py`` runs it: a subprocess
with four forced host devices and a ``("pod",)`` mesh.  It takes the
reference's input ``arange(32).reshape(4, 8) / 7.3`` (one row a pod),
then numpy-seeded normal gradients ``[4, 64]`` for three rounds with the
residuals fed back.  The port's side is four processes of
``torch.distributed`` on gloo, each with its row.  Each rank's int8
payload and the int32 sum are equal to JAX's (the JAX side computes them
with the reference's own steps, which its ``compressed_psum`` output must
reproduce); the outputs and residuals are within one fp32 ulp of JAX's.
``tools/multicard_train.py``'s ``FeedbackCheck`` holds
``compressed_psum``'s guarantees (residuals fed back, the residual ``g32 -
q·scale`` exact, every element within ``scale / 2`` of the mean) on the
same ranks, every round.  A residual's ulp is that of its ``g32``: it is
one rounding of a difference of two numbers of that size.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(ROOT, "tools"))   # the shared harness
ROUNDS, WIDTH, SEED = 3, 64, 5

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.parallel.compat import shard_map
    from repro.parallel.compressed import compressed_psum

    rounds, width, seed, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                     int(sys.argv[3]), sys.argv[4])
    mesh = jax.make_mesh((4,), ("pod",))

    def stages(g, e):
        # the reference's own steps (compressed.py), to read the payloads
        g32 = g.astype(jnp.float32) + e
        absmax = jax.lax.pmax(jnp.max(jnp.abs(g32)), "pod") + 1e-12
        scale = absmax / 127.0
        q = jnp.clip(jnp.round(g32 / scale), -127, 127).astype(jnp.int8)
        summed = jax.lax.psum(q.astype(jnp.int32), "pod")
        out, err = compressed_psum({"g": g}, "pod", {"g": e})
        return out["g"], err["g"], q, summed

    spec = P("pod", None)
    fm = jax.jit(shard_map(stages, mesh=mesh, in_specs=(spec, spec),
                           out_specs=(spec, spec, spec, spec)))
    rng = np.random.default_rng(seed)
    grads = [np.arange(32.0, dtype=np.float32).reshape(4, 8) / np.float32(7.3)]
    e = np.zeros((4, 8), np.float32)
    res = {}
    out, err, q, summed = fm(jnp.asarray(grads[0]), jnp.asarray(e))
    res["ref_out"], res["ref_err"] = np.asarray(out), np.asarray(err)
    res["ref_q"], res["ref_sum"] = np.asarray(q), np.asarray(summed)
    e = np.zeros((4, width), np.float32)
    for r in range(rounds):
        g = rng.standard_normal((4, width)).astype(np.float32)
        out, err, q, summed = fm(jnp.asarray(g), jnp.asarray(e))
        res[f"g{r}"], res[f"out{r}"], res[f"err{r}"] = g, np.asarray(out), \\
            np.asarray(err)
        res[f"q{r}"], res[f"sum{r}"] = np.asarray(q), np.asarray(summed)
        e = np.asarray(err)
    np.savez(out_path, **res)
    print("JAX_OK")
""")


def _rank(rank, world, init, jax_npz, out_dir):
    from multicard_train import FeedbackCheck
    from repro_torch.parallel.compressed import compress_leaf, compressed_psum

    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        ref = np.load(jax_npz)
        res = {}
        g = torch.from_numpy(np.arange(32.0, dtype=np.float32).reshape(4, 8)
                             / np.float32(7.3))[rank]
        leaf = compress_leaf(g, None, None)
        for k in ("out", "error", "q", "summed"):
            res[f"ref_{k}"] = leaf[k].numpy()
        check = FeedbackCheck(None)
        e = torch.zeros(WIDTH)          # the JAX side's first residuals
        for r in range(ROUNDS):
            g = torch.from_numpy(ref[f"g{r}"][rank])
            stages = {}
            _, new = compressed_psum({"g": g}, None, {"g": e}, stages=stages)
            check(stages)
            for k in ("out", "error", "q", "summed"):
                res[f"{k}{r}"] = stages["g"][k].numpy()
            e = new["g"]
        rep = check.report({"g": e})
        res["rep"] = np.array([rep["ok"], rep["steps"] == ROUNDS])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _ulps(a, b, scale=None):
    """Distance in fp32 ulps: of the values' own magnitude, or of
    ``scale``'s (a residual ``g32 - q·scale`` is one rounding of a
    difference of two numbers of ``g32``'s size)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    mag = np.maximum(np.abs(a), np.abs(b))
    if scale is not None:
        mag = np.maximum(mag, np.abs(np.asarray(scale, np.float32)))
    return np.max(np.abs(a - b) / np.spacing(mag))


def test_compressed_psum_equals_jax_on_four_gloo_ranks(tmp_path):
    jax_npz = str(tmp_path / "jax.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(ROUNDS),
                          str(WIDTH), str(SEED), jax_npz], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "JAX_OK" in res.stdout, res.stderr[-3000:]
    init = f"file://{tmp_path / 'rendezvous'}"
    mp.spawn(_rank, args=(4, init, jax_npz, str(tmp_path)), nprocs=4)
    ref = np.load(jax_npz)
    want_ref = np.arange(32.0, dtype=np.float32).reshape(4, 8) / np.float32(7.3)
    for rank in range(4):
        got = np.load(tmp_path / f"rank{rank}.npz")
        for tag in ["ref_"] + [str(r) for r in range(ROUNDS)]:
            pre = "ref_" if tag == "ref_" else ""
            suf = "" if tag == "ref_" else tag
            jq = ref[f"{pre}q{suf}"][rank]
            jsum = ref[f"{pre}sum{suf}"][rank]
            np.testing.assert_array_equal(got[f"{pre}q{suf}"], jq)
            np.testing.assert_array_equal(got[f"{pre}summed{suf}"], jsum)
            assert _ulps(got[f"{pre}out{suf}"], ref[f"{pre}out{suf}"][rank]) <= 1
            g32 = (want_ref[rank] if tag == "ref_" else
                   ref[f"g{tag}"][rank] + (0 if tag == "0" else
                                           ref[f"err{int(tag) - 1}"][rank]))
            assert _ulps(got[f"{pre}error{suf}"], ref[f"{pre}err{suf}"][rank],
                         scale=g32) <= 1
        assert got["rep"].all(), (rank, got["rep"])
    # the reference's own check: the mean of the four rows, within the
    # quantization step
    want = np.arange(32.0, dtype=np.float32).reshape(4, 8) / 7.3
    outs = np.stack([np.load(tmp_path / f"rank{r}.npz")["ref_out"]
                     for r in range(4)])
    np.testing.assert_allclose(outs[0], want.mean(0), atol=0.05)


def test_quantize_roundtrip():
    from repro_torch.parallel.compressed import dequantize_int8, quantize_int8

    x = torch.linspace(-3, 3, 101)
    q, scale = quantize_int8(x)
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    assert float(torch.max(torch.abs(dequantize_int8(q, scale) - x))) <= \
        float(scale) / 2 * (1 + 1e-6)
