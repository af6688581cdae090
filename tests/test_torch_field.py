"""The port's field, core, NumPy table machinery and Barrett ops, held
against the JAX package (integer-equal everywhere), plus the port's
hygiene: no JAX or ``repro`` imports, lint-clean, no silent CPU fallback."""
import ast
import itertools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import jitlint
from repro.core import age as j_age
from repro.core import worker_counts as j_wc
from repro.kernels import barrett as j_barrett
from repro.mpc import field as j_field
from repro.mpc import lagrange as j_lag
from repro_torch.core import age as t_age
from repro_torch.core import worker_counts as t_wc
from repro_torch.kernels import _build
from repro_torch.kernels import barrett as t_barrett
from repro_torch.mpc import MPCSpec, connect
from repro_torch.mpc import field as t_field
from repro_torch.mpc import lagrange as t_lag

ROOT = pathlib.Path(__file__).resolve().parents[1]
PRIMES = [j_field.P_DEFAULT, j_field.P_MERSENNE31]


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ field
def test_acc_window_and_primes():
    for p in PRIMES + [97, 2**20 + 7, 65537]:
        assert t_field.acc_window(p) == j_field.acc_window(p)
    assert t_field.acc_window(t_field.P_DEFAULT) == 2048
    assert t_field.acc_window(t_field.P_MERSENNE31) == 2
    for n in range(0, 3000):
        assert t_field.is_prime(n) == j_field.is_prime(n)
    for n in (2**31 - 1, 2**26 - 5, 2**61 - 1, 2**32 + 1, 561, 1105):
        assert t_field.is_prime(n) == j_field.is_prime(n)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("frac_bits", [0, 8, 12])
def test_encode_decode_equal_jax(p, frac_bits):
    rng = np.random.default_rng(frac_bits + p % 97)
    x = rng.normal(scale=40.0, size=500)
    # exact ties at every scale: round-half-to-even must agree
    ties = (np.arange(-40, 40) + 0.5) / (1 << frac_bits)
    x = np.concatenate([x, ties, [0.0, -0.0]])
    jf, tf = j_field.Field(p, frac_bits), t_field.Field(p, frac_bits)
    enc_j = np.asarray(jf.encode(jnp.asarray(x)))
    enc_t = N(tf.encode(T(x)))
    np.testing.assert_array_equal(enc_t, enc_j)
    for products in (1, 2):
        np.testing.assert_array_equal(
            N(tf.decode(T(enc_t), products=products)),
            np.asarray(jf.decode(jnp.asarray(enc_j), products=products)))


@pytest.mark.parametrize("p", PRIMES)
def test_field_ops_and_matmul_equal_jax(p):
    rng = np.random.default_rng(p % 1000)
    a = rng.integers(0, p, (3, 5, 7))
    b = rng.integers(0, p, (3, 7, 4))
    jf, tf = j_field.Field(p), t_field.Field(p)
    for op in ("add", "sub", "mul"):
        np.testing.assert_array_equal(
            N(getattr(tf, op)(T(a), T(a[::-1].copy()))),
            np.asarray(getattr(jf, op)(jnp.asarray(a), jnp.asarray(a[::-1]))))
    np.testing.assert_array_equal(N(tf.neg(T(a))),
                                  np.asarray(jf.neg(jnp.asarray(a))))
    np.testing.assert_array_equal(N(tf.matmul(T(a), T(b))),
                                  np.asarray(jf.matmul(a, b)))
    assert tf.inv_scalar(12345) == jf.inv_scalar(12345)
    assert tf.pow_scalar(3, 1000) == jf.pow_scalar(3, 1000)


def test_field_random_on_generator_device():
    g = torch.Generator(device="cpu")
    g.manual_seed(3)
    x = t_field.Field(t_field.P_MERSENNE31).random(g, (4, 5))
    assert x.dtype == torch.int64 and x.shape == (4, 5)
    assert int(x.min()) >= 0 and int(x.max()) < t_field.P_MERSENNE31


def test_fold_in_and_generators():
    seeds = {t_field.fold_in(7, i) for i in range(1000)}
    assert len(seeds) == 1000 and all(0 <= s < 2**63 for s in seeds)
    g = torch.Generator()
    g.manual_seed(7)
    assert t_field.fold_in(g, 3) == t_field.fold_in(7, 3)
    assert t_field.generator(g, torch.device("cpu")) is g
    a = torch.randint(0, 9, (5,), generator=t_field.generator(11, "cpu"))
    b = torch.randint(0, 9, (5,), generator=t_field.generator(11, "cpu"))
    assert torch.equal(a, b)


# ------------------------------------------------------------------- core
CONFIG_FILES = ["models/config.py"] + sorted(
    f"configs/{p.name}" for p in (ROOT / "src/repro/configs").glob("*.py"))


@pytest.mark.parametrize("name", ["core/__init__.py", "core/age.py",
                                  "core/worker_counts.py",
                                  "core/overheads.py", "mpc/errors.py",
                                  "mpc/workers.py", "sim/__init__.py",
                                  "sim/events.py", "sim/trace.py",
                                  "sim/devices.py", "sim/replay.py",
                                  "sim/calibrate.py", "sim/divergence.py",
                                  "transport/framing.py"]
                         + CONFIG_FILES)
def test_framework_free_copies_are_verbatim(name):
    orig = (ROOT / "src/repro" / name).read_bytes()
    port = (ROOT / "src/repro_torch" / name).read_bytes()
    assert port == orig


@pytest.mark.parametrize("s,t", list(itertools.product(range(1, 7), range(2, 7))))
def test_core_worker_counts_equal_on_theorem3_grid(s, t):
    for z in range(1, 16):
        assert t_wc.n_age_cmpc(s, t, z) == j_wc.n_age_cmpc(s, t, z)
        assert t_wc.all_worker_counts(s, t, z) == j_wc.all_worker_counts(s, t, z)
        for lam in range(z + 1):
            assert t_wc.gamma(s, t, z, lam) == j_wc.gamma(s, t, z, lam)
            assert (t_age.AGECode(s, t, z, lam).n_workers
                    == j_age.AGECode(s, t, z, lam).n_workers)


def test_mask_shape_error_taxonomy():
    from repro_torch.mpc.errors import MaskShapeError, QuorumError

    assert issubclass(MaskShapeError, QuorumError)
    assert issubclass(MaskShapeError, ValueError)
    assert issubclass(QuorumError, RuntimeError)


# -------------------------------------------------------- numpy machinery
@pytest.mark.parametrize("p", PRIMES)
def test_lagrange_tables_equal_jax(p):
    jf, tf = j_field.Field(p), t_field.Field(p)
    rng = np.random.default_rng(5)
    al = rng.integers(1, p, 17)
    pw = rng.integers(0, 60, 11)
    np.testing.assert_array_equal(t_lag.vandermonde(tf, al, pw),
                                  j_lag.vandermonde(jf, al, pw))
    np.testing.assert_array_equal(t_lag.power_table(tf, al, 40),
                                  j_lag.power_table(jf, al, 40))
    v = j_lag.vandermonde(jf, al[:9], np.arange(9))
    np.testing.assert_array_equal(t_lag.inv_mod(tf, v), j_lag.inv_mod(jf, v))
    np.testing.assert_array_equal(t_lag.inv_mod_ref(tf, v),
                                  j_lag.inv_mod_ref(jf, v))
    a, b = rng.integers(0, p, (6, 3000)), rng.integers(0, p, (3000, 4))
    np.testing.assert_array_equal(t_lag.matmul_mod(a, b, p),
                                  j_lag.matmul_mod(a, b, p))
    alphas_t, w_t = t_lag.choose_alphas_with_inverse(tf, 9, np.arange(9) * 3)
    alphas_j, w_j = j_lag.choose_alphas_with_inverse(jf, 9, np.arange(9) * 3)
    np.testing.assert_array_equal(alphas_t, alphas_j)
    np.testing.assert_array_equal(w_t, w_j)
    assert t_lag.ALPHA_SEARCH_SEED == j_lag.ALPHA_SEARCH_SEED
    assert t_lag.ALPHA_SEARCH_TRIES == j_lag.ALPHA_SEARCH_TRIES
    assert t_lag.ALPHA_POOL_LIMIT == j_lag.ALPHA_POOL_LIMIT


# ----------------------------------------------------------------- barrett
@pytest.mark.parametrize("p", PRIMES + [97])
def test_barrett_params_and_mod_p(p):
    assert t_barrett.barrett_params(p) == j_barrett.barrett_params(p)
    rng = np.random.default_rng(p)
    x = np.concatenate([rng.integers(0, 2**63 - 1, 4000, dtype=np.int64),
                        [0, 1, p - 1, p, p + 1, 2 * p, 2**63 - 1]])
    got = N(t_barrett.mod_p(T(x), p))
    np.testing.assert_array_equal(got, np.asarray(j_barrett.mod_p(jnp.asarray(x), p)))
    np.testing.assert_array_equal(got, x % p)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("shape", [(4, 7, 5), (2, 33, 3), (3, 3, 64, 2),
                                   (1, 1, 1)])
def test_matmul_ops_equal_jax(p, shape):
    lead, m, k, n = shape[:-3], shape[-3], shape[-2], shape[-1]
    rng = np.random.default_rng(sum(shape) + p % 13)
    a = rng.integers(0, p, lead + (m, k))
    b = rng.integers(0, p, lead + (k, n))
    want = np.asarray(j_barrett.matmul_folded(a, b, p=p,
                                              window=j_field.acc_window(p)))
    got_f = N(t_barrett.matmul_folded(T(a), T(b), p=p,
                                      window=t_field.acc_window(p)))
    got_l = N(t_barrett.matmul_limbs(T(a), T(b), p=p))
    np.testing.assert_array_equal(got_f, want)
    np.testing.assert_array_equal(got_l, np.asarray(
        j_barrett.matmul_limbs(a, b, p=p)))
    np.testing.assert_array_equal(got_l, want)


@pytest.mark.parametrize("p", PRIMES)
def test_matmul_ops_corner_and_chunk_path(p):
    """All-(p−1) operands with K past the field window: the chunk-then-fold
    path (K > acc_window) and the limb path stay exact."""
    k = t_field.acc_window(p) * 2 + 3
    a = np.full((3, k), p - 1, np.int64)
    b = np.full((k, 2), p - 1, np.int64)
    want = np.full((3, 2), pow(p - 1, 2, p) * k % p)
    win = t_field.acc_window(p)
    np.testing.assert_array_equal(
        N(t_barrett.matmul_folded(T(a), T(b), p=p, window=win)), want)
    np.testing.assert_array_equal(N(t_barrett.matmul_limbs(T(a), T(b), p=p)),
                                  want)
    np.testing.assert_array_equal(
        np.asarray(j_barrett.matmul_folded(a, b, p=p, window=win)), want)
    np.testing.assert_array_equal(N(t_barrett.matmul_plain(T(a), T(b), p=p,
                                                           window=win)), want)


# ----------------------------------------------------------------- hygiene
def _port_files():
    return sorted((ROOT / "src/repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text())
    banned = ("jax", "jaxlib", "repro")
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in banned, f"{path}: imports {name}"


def test_port_is_lint_clean():
    found = jitlint.lint_paths([str(ROOT / "src/repro_torch")])
    assert found == [], "\n".join(f.render() for f in found)


def test_no_card_means_connect_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        connect(MPCSpec(s=2, t=2, z=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MPCSpec(s=2, t=2, z=2, m=8).protocol().run(
            np.zeros((8, 8), np.int64), np.zeros((8, 8), np.int64), 0)
    assert connect(MPCSpec(s=2, t=2, z=2), device="cpu").device.type == "cpu"


def test_kernel_build_refuses_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.nvcc()
    with pytest.raises(_build.KernelBuildError, match="unknown"):
        _build.build(["nope"])


def test_kernel_fold_args_refuse_unsupported_primes():
    assert _build.fold_args(t_field.P_DEFAULT) == (t_field.P_DEFAULT, 26, 5, 2,
                                                   2048)
    assert _build.fold_args(t_field.P_MERSENNE31)[3:] == (2, 2)
    with pytest.raises(ValueError, match="pseudo-Mersenne"):
        _build.fold_args(1000003)
    with pytest.raises(ValueError, match="pseudo-Mersenne"):
        _build.fold_args(2**61 - 1)
    with pytest.raises(_build.KernelLaunchError, match="cudaError_t 98"):
        _build.check(98, "x")
    jax.numpy.zeros(1)  # JAX stays importable beside torch in one process
