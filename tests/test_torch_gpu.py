"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA card: it carries the ``gpu`` marker and skips
itself where there is none.  The file imports neither JAX nor ``repro``, so
it runs where only the port is installed::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance is 0: every comparison is ``torch.equal`` on field elements."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.modmatmul import modmatmul, modmatmul_batched, modmatmul_plain
from repro_torch.kernels.polyeval import polyeval, polyeval_plain
from repro_torch.mpc import P_DEFAULT, P_MERSENNE31, Field, MPCSpec, connect

PRIMES = [P_DEFAULT, P_MERSENNE31]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(g, p, shape):
    return torch.randint(0, p, shape, generator=g, device=g.device)


@pytest.mark.gpu
@pytest.mark.parametrize("p", PRIMES)
def test_gpu_modmatmul_kernels_equal_plain(cuda, p):
    g = torch.Generator(device=cuda)
    g.manual_seed(p % 1000)
    reset_launch_counts()
    # the last two split K across blocks (k_splits): few output tiles
    shapes = [(17, 128, 128, 128), (3, 33, 65, 17), (2, 1, 7, 1),
              (4, 64, 3000, 64), (1, 17, 300001, 1)]
    for w, m, k, n in shapes:
        a, b = _rand(g, p, (w, m, k)), _rand(g, p, (w, k, n))
        assert torch.equal(modmatmul_batched(a, b, p=p),
                           modmatmul_plain(a, b, p=p))
        assert torch.equal(modmatmul(a[0].contiguous(), b[0].contiguous(), p=p),
                           modmatmul_plain(a[0], b[0], p=p))
    a = torch.full((2, 64, 2100), p - 1, dtype=torch.int64, device=cuda)
    b = torch.full((2, 2100, 64), p - 1, dtype=torch.int64, device=cuda)
    assert bool((modmatmul_batched(a, b, p=p)
                 == (pow(p - 1, 2, p) * 2100) % p).all())
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts == {"modmatmul_batched": len(shapes) + 1,
                      "modmatmul": len(shapes), "polyeval": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("p", PRIMES)
def test_gpu_polyeval_kernel_equals_plain(cuda, p):
    g = torch.Generator(device=cuda)
    g.manual_seed(p % 977)
    reset_launch_counts()
    shapes = [(17, 6, 4096), (17, 17, 4096), (17, 2, 999), (4, 6, 4096),
              (40, 70, 333), (1, 1, 5)]
    for n, k, c in shapes:
        v, t = _rand(g, p, (n, k)), _rand(g, p, (k, c))
        assert torch.equal(polyeval(v, t, p=p), polyeval_plain(v, t, p=p))
    torch.cuda.synchronize()
    assert launch_counts()["polyeval"] == len(shapes)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fused", "kernel"])
@pytest.mark.parametrize("p", PRIMES)
def test_gpu_session_is_exact_and_runs_the_kernels(cuda, p, mode):
    """A small session on the card: exact in the field, every product a
    kernel launch (no plain op on a CUDA tensor), and equal to the same
    session on the CPU."""
    rng = np.random.default_rng(p % 101)
    a = rng.integers(0, p, (5, 40))
    b = rng.integers(0, p, (40, 24))
    want = np.array((a.astype(object) @ b.astype(object)) % p, np.int64)
    spec = MPCSpec(s=2, t=2, z=2, field=Field(p))
    sess = connect(spec, mode=mode)
    assert sess.device.type == "cuda"
    reset_launch_counts()
    got = sess.matmul(a, b, encoded=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    blocks = sess.stats["blocks"]
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    np.testing.assert_array_equal(
        connect(spec, device="cpu", mode=mode).matmul(a, b, encoded=True).numpy(),
        want)
    assert counts == {"modmatmul_batched": blocks, "modmatmul": 0,
                      "polyeval": 5 * blocks}
