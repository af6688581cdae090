"""The port's static analysis (``repro_torch.analysis``) against the JAX
package's, and the certificates its kernels consume.

* ``intervals`` and ``report`` are verbatim copies of the reference's;
* ``certified_window`` equals JAX's ``certified_bk`` and the port's
  ``acc_window`` on both primes, ``certified_k_run`` equals the tensor-core
  instance's ``K_RUN_MAX``, and one past each is rejected;
* every obligation of the CUDA accumulators rejects its mutated constant
  (window + 1, K-run + 1, one fold fewer, a limb GEMM at twice its chunk,
  65536 split partials), and so does the CLI;
* the port's spec-space proof counts the same tuner configs as JAX's;
* ``_build.fold_args``, the tensor-core launch and ``barrett.matmul_folded``
  read the certificates and refuse a window or K-run past them;
* the plain versions at the certificates' edges (all-(p-1) operands at
  K = 2·window + 1 and K = 2·K_RUN_MAX + 1) equal the closed form and
  JAX's ``modmatmul_ref``;
* the lint's rules, in torch form, fire on their minimal triggers, honor
  ``# analysis: allow``, and report nothing over ``src/repro_torch``;
* the invariant prover proves over the port's paths and fails the audit on
  a weakened quorum.

Each check is exact; the whole file runs in about 30 s on one worker.
"""
import filecmp
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import overflow as j_overflow
from repro.kernels.ref import modmatmul_ref
from repro_torch.analysis import invariants, jitlint, overflow
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis.report import (Finding, diff_baseline,
                                         load_baseline, write_baseline)
from repro_torch.kernels import _build, barrett
from repro_torch.kernels import modmatmul as mm
from repro_torch.mpc import field as t_field
from repro_torch.mpc.errors import InvariantError
from repro_torch.mpc.field import P_DEFAULT, P_MERSENNE31, acc_window

ROOT = Path(__file__).resolve().parents[1]
PRIMES = (P_DEFAULT, P_MERSENNE31)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64))


# ------------------------------------------------------------ the copies
@pytest.mark.parametrize("name", ["intervals.py", "report.py"])
def test_framework_free_modules_are_verbatim_copies(name):
    assert filecmp.cmp(ROOT / "src/repro/analysis" / name,
                       ROOT / "src/repro_torch/analysis" / name,
                       shallow=False)


# ------------------------------------------------------ the certificates
def test_self_check_certifies_both_primes_and_the_k_run():
    assert overflow.self_check() == {
        "window": {P_DEFAULT: 2048, P_MERSENNE31: 2}, "k_run": 8256}


@pytest.mark.parametrize("p", PRIMES)
def test_certified_window_equals_jax_and_acc_window(p):
    assert (overflow.certified_window(p) == j_overflow.certified_bk(p)
            == acc_window(p) == t_field.ACC_WINDOW[p])


def test_certified_k_run_equals_k_run_max():
    assert overflow.certified_k_run() == mm.K_RUN_MAX == 8256
    overflow.prove_tensor_core(P_DEFAULT, mm.K_RUN_MAX)
    with pytest.raises(overflow.OverflowProofError, match="s32"):
        overflow.prove_tensor_core(P_DEFAULT, mm.K_RUN_MAX + 1)


@pytest.mark.parametrize("p", PRIMES)
def test_field_pipeline_certifies(p):
    stats = overflow.verify_field_pipeline(p)
    assert stats["verified_window"] == stats["certified_window"] == \
        acc_window(p)
    assert stats["certified_k_run"] == mm.K_RUN_MAX


def _mutations(p):
    """(name, obligation at the certified edge, the same one past it)."""
    w = overflow.certified_window(p)
    nf = barrett.barrett_params(p)[2]
    k_max = overflow.limb_k_max(p)
    return [
        ("cuda_core window", lambda: overflow.prove_cuda_core(p, w),
         lambda: overflow.prove_cuda_core(p, w + 1)),
        ("skinny window", lambda: overflow.prove_skinny(p, w),
         lambda: overflow.prove_skinny(p, w + 1)),
        ("polyeval window", lambda: overflow.prove_polyeval(p, w),
         lambda: overflow.prove_polyeval(p, w + 1)),
        ("matmul_folded window", lambda: overflow.prove_matmul_folded(p, w),
         lambda: overflow.prove_matmul_folded(p, w + 1)),
        ("tensor_core K-run",
         lambda: overflow.prove_tensor_core(p, mm.K_RUN_MAX),
         lambda: overflow.prove_tensor_core(p, mm.K_RUN_MAX + 1)),
        ("mod_p folds", lambda: overflow.prove_barrett_fold(p, nf),
         lambda: overflow.prove_barrett_fold(p, nf - 1)),
        ("limb GEMM chunk", lambda: overflow.prove_limb_gemm(p, k_max),
         lambda: overflow.prove_limb_gemm(p, 2 * k_max, k_max=2 * k_max)),
        ("sum_splits partials",
         lambda: overflow.prove_sum_splits(p, mm.MAX_GRID_Z),
         lambda: overflow.prove_sum_splits(p, mm.MAX_GRID_Z + 1)),
    ]


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("case", range(8))
def test_each_obligation_rejects_its_mutated_constant(p, case):
    name, edge, past = _mutations(p)[case]
    edge()
    with pytest.raises(overflow.OverflowProofError):
        past()


@pytest.mark.parametrize("p", PRIMES)
def test_pipeline_rejects_an_overwide_window(p):
    with pytest.raises(overflow.OverflowProofError):
        overflow.verify_field_pipeline(
            p, window=overflow.certified_window(p) + 1)


def test_ring_fold_bound():
    for p in PRIMES:
        overflow.prove_ring_fold(p)
    # a sum of two residues near 2^32 wraps uint32
    with pytest.raises(overflow.OverflowProofError, match="uint32"):
        overflow.prove_ring_fold(2**32 + 15)


@pytest.mark.parametrize("p", PRIMES)
def test_spec_space_counts_the_same_configs_as_jax(p):
    got = overflow.verify_spec_space(p, max_m=256)
    want = j_overflow.verify_spec_space(p, max_m=256)
    assert got["configs"] == want["configs"] == 10577
    assert got["certified_window"] == want["certified_bk"]
    assert got["certified_k_run"] == mm.K_RUN_MAX
    assert got["max_inner_dim"] == want["max_inner_dim"]


# ------------------------------------------- the kernels read the proofs
def test_fold_args_refuses_a_window_the_proof_does_not_certify(monkeypatch):
    assert _build.fold_args(P_DEFAULT)[4] == 2048
    monkeypatch.setattr(_build, "acc_window", lambda p: 2049)
    with pytest.raises(InvariantError, match="certifies 2048"):
        _build.fold_args(P_DEFAULT)


def test_tensor_core_launch_refuses_a_drifted_k_run(monkeypatch):
    assert mm.check_k_run() == 8256
    with pytest.raises(InvariantError, match="K_RUN_MAX = 8257"):
        mm.check_k_run(8257)
    monkeypatch.setattr(mm, "K_RUN_MAX", 8257)
    mm._certified_run.cache_clear()
    a = torch.ones((1, 64, 8), dtype=torch.int64)
    b = torch.ones((1, 8, 64), dtype=torch.int64)
    try:
        with pytest.raises(InvariantError, match="certifies a K-run of 8256"):
            mm._launch(a, b, p=P_DEFAULT, instance="tensor_core")
    finally:
        mm._certified_run.cache_clear()


@pytest.mark.parametrize("p", PRIMES)
def test_matmul_folded_refuses_a_window_past_the_certificate(p):
    w = acc_window(p)
    a = T(np.ones((2, 3)))
    b = T(np.ones((3, 2)))
    for fn in (barrett.matmul_folded, barrett.matmul_plain):
        with pytest.raises(ValueError, match="acc_window"):
            fn(a, b, p=p, window=w + 1)
        with pytest.raises(ValueError, match="acc_window"):
            fn(a, b, p=p, window=0)
        assert torch.equal(fn(a, b, p=p, window=w), T(np.full((2, 2), 3)))
    with pytest.raises(ValueError, match="acc_window"):
        t_field.Field(p).matmul(a, b, chunk=w + 1)


@pytest.mark.parametrize("p", PRIMES)
@pytest.mark.parametrize("edge", ["window", "k_run"])
def test_plain_versions_at_the_certificates_edges(p, edge):
    """All-(p-1) operands at K = 2·window + 1 (three folds of the CUDA-core,
    skinny and polyeval chains) and K = 2·K_RUN_MAX + 1 (three s32 runs):
    ``matmul_folded`` and the tensor-core emulation equal the closed form
    and JAX's ``modmatmul_ref``."""
    k = (2 * overflow.certified_window(p) + 1 if edge == "window"
         else 2 * overflow.certified_k_run() + 1)
    a = np.full((2, k), p - 1, np.int64)
    b = np.full((k, 3), p - 1, np.int64)
    want = np.full((2, 3), k * (p - 1) ** 2 % p)
    np.testing.assert_array_equal(
        np.asarray(modmatmul_ref(jnp.asarray(a), jnp.asarray(b), p=p)), want)
    got = barrett.matmul_folded(T(a), T(b), p=p, window=acc_window(p))
    np.testing.assert_array_equal(got.numpy(), want)
    emu = mm.modmatmul_tc_emulation(T(a), T(b), p=p)
    np.testing.assert_array_equal(emu.numpy(), want)


# -------------------------------------------------------------- the lint
def _lint(tmp_path, source, rules=jitlint.RULES):
    f = tmp_path / "snippet.py"
    f.write_text(source)
    return jitlint.lint_file(str(f), rules)


def test_lint_host_sync(tmp_path):
    src = ("import numpy as np\n"
           "import torch\n"
           "def f(x):\n"
           "    a = np.asarray(x)\n"
           "    b = np.array(x)\n"
           "    c = x.item()\n"
           "    d = x.tolist()\n"
           "    e = x.cpu()\n"
           "    g = x.numpy()\n"
           "    torch.cuda.synchronize()\n"
           "    h = x.to('cpu', non_blocking=True)\n"
           "    return a, b, c, d, e, g, h\n")
    found = _lint(tmp_path, src)
    assert [f.rule for f in found] == ["host-sync"] * 7
    assert [f.line for f in found] == [4, 5, 6, 7, 8, 9, 10]


def test_lint_shape_loop(tmp_path):
    src = ("import torch\n"
           "def f(n, buf):\n"
           "    out = []\n"
           "    for i in range(n):\n"
           "        out.append(torch.zeros((i, 4)))\n"
           "        out.append(torch.arange(i))\n"
           "        out.append(torch.zeros((n, 4)))\n"
           "        out.append(torch.zeros_like(buf[i]))\n"
           "        torch.randint(0, 7, buf[i].shape, out=buf[i])\n"
           "    return out\n")
    found = _lint(tmp_path, src)
    assert [(f.rule, f.line) for f in found] == [("shape-loop", 5),
                                                 ("shape-loop", 6)]


def test_lint_bare_assert_and_dropped_jax_rules(tmp_path):
    assert [f.rule for f in _lint(tmp_path, "def f(x):\n    assert x\n")] \
        == ["no-bare-assert"]
    assert jitlint.RULES == ("host-sync", "shape-loop", "no-bare-assert")
    # the reference's jit-only rules have no torch meaning: nothing fires
    src = ("import jax\n"
           "g = jax.jit(lambda x, n: x, static_argnums=(1,))\n"
           "step = jax.jit(lambda s, b: s, donate_argnums=(0,))\n"
           "def train(state, batch):\n"
           "    out = step(state, batch)\n"
           "    return state, out\n")
    assert _lint(tmp_path, src) == []


def test_lint_suppression_same_line_and_above(tmp_path):
    same = ("def f(x):\n"
            "    return x.item()  # analysis: allow(host-sync)\n")
    above = ("def f(x):\n"
             "    # analysis: allow(host-sync): test fixture\n"
             "    return x.cpu().numpy()\n")
    star = ("def f(x):\n"
            "    return x.tolist()  # analysis: allow(*)\n")
    other = ("def f(x):\n"
             "    return x.tolist()  # analysis: allow(shape-loop)\n")
    too_far = ("def f(x):\n"
               "    # analysis: allow(host-sync)\n"
               "    # an interposed comment breaks the suppression\n"
               "    return x.item()\n")
    assert _lint(tmp_path, same) == []
    assert _lint(tmp_path, above) == []
    assert _lint(tmp_path, star) == []
    assert [f.rule for f in _lint(tmp_path, other)] == ["host-sync"]
    assert [f.rule for f in _lint(tmp_path, too_far)] == ["host-sync"]


def test_port_lints_clean_under_the_torch_rules():
    found = jitlint.lint_paths([str(ROOT / "src/repro_torch")])
    assert found == [], "\n".join(f.render() for f in found)


def test_baseline_absorbs_then_resurrects(tmp_path):
    src_file = tmp_path / "legacy.py"
    src_file.write_text("def f(x):\n    return x.item()\n")
    found = jitlint.lint_file(str(src_file))
    assert len(found) == 1
    base = tmp_path / "baseline.json"
    write_baseline(str(base), found)
    loaded = load_baseline(str(base))
    assert diff_baseline(jitlint.lint_file(str(src_file)), loaded) == []
    src_file.write_text("def f(x):\n    return (x + 1).item()\n")
    assert len(diff_baseline(jitlint.lint_file(str(src_file)), loaded)) == 1
    dup = Finding(rule="host-sync", file=str(src_file), line=2,
                  message="", snippet="return x.item()")
    assert len(diff_baseline([dup, dup], {dup.fingerprint(): 1})) == 1


# ------------------------------------------------------------ invariants
def test_invariants_prove_over_the_port():
    stats = invariants.run(str(ROOT / "src"))
    assert stats["escalation_sources"] == 2
    assert all(v > 0 for v in stats.values())


def test_weakened_quorum_fails_the_audit(tmp_path):
    for rel in invariants._QUORUM_SOURCES:
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / "src" / rel, tmp_path / rel)
    assert invariants.audit_escalation_sources(str(tmp_path)) == 2
    elastic = tmp_path / "repro_torch/mpc/elastic.py"
    text = elastic.read_text()
    weak = text.replace("t * t + self.z + 2 * self.adversaries",
                        "t * t + self.z + self.adversaries")
    assert weak != text
    elastic.write_text(weak)
    with pytest.raises(invariants.InvariantProofError, match="t²\\+z\\+2a"):
        invariants.audit_escalation_sources(str(tmp_path))


# ------------------------------------------------------------------- CLI
def test_cli_proves_the_port(tmp_path):
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "src/repro_torch"], capture_output=True, text=True,
                       cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "certified K-run 8256" in r.stdout
    assert f"p={P_DEFAULT}: 12 pipeline obligations, 10577 tuner" in r.stdout
    assert "certified window=2048" in r.stdout
    assert "certified window=2\n" in r.stdout
    assert "[invariants]" in r.stdout and "OK: no unsuppressed" in r.stdout
    dirty = tmp_path / "dirty.py"
    dirty.write_text("def f(x):\n    return x.cpu()\n")
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "--passes", "jitlint", str(dirty)],
                       capture_output=True, text=True, cwd=ROOT)
    assert r.returncode == 1 and "FAILED" in r.stdout


@pytest.mark.parametrize("mutation", ["window", "k_run", "folds", "limb"])
def test_cli_fails_on_a_one_past_mutation(monkeypatch, capsys, mutation):
    if mutation == "window":
        monkeypatch.setattr(t_field, "acc_window",
                            lambda p, f=t_field.acc_window: f(p) + 1)
    elif mutation == "k_run":
        monkeypatch.setattr(mm, "K_RUN_MAX", mm.K_RUN_MAX + 1)
    elif mutation == "folds":
        params = barrett.barrett_params
        monkeypatch.setattr(barrett, "barrett_params",
                            lambda p: (*params(p)[:2], params(p)[2] - 1))
    else:
        monkeypatch.setattr(overflow, "limb_k_max",
                            lambda p, f=overflow.limb_k_max: 2 * f(p))
    assert cli.main(["--passes", "overflow"]) == 1
    assert "[overflow]" in capsys.readouterr().out
