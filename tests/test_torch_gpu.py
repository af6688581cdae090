"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA card: it carries the ``gpu`` marker and skips
itself where there is none.  The file imports neither JAX nor ``repro``, so
it runs where only the port is installed::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Mod-p comparisons are ``torch.equal`` on field elements (tolerance 0).
Attention is held within ``flash_attention.agreement``'s limits: 2e-5 in
fp32; in bf16 two ULP of each element (2^-6 of |ref| plus its row's rms)
and 2^-8 in relative Frobenius norm.  The WKV-6 kernel is held within
``rwkv6.agreement``'s limits: 1e-4 of each element's |ref| plus its row's
rms, and 1e-5 in relative Frobenius norm; so is Mamba's selective scan
(``selective_scan.agreement`` is the same check).  The served models' logits are
held at 1e-4 against the same model on the CPU (sums in another order).

Where a wrapper chooses between kernels (``modmatmul*``: ``tensor_core``,
``skinny`` or ``cuda_core``; ``flash_attention``: ``wgmma``, ``mma_sync``
or ``cuda_core``), each instance is held here, the ones the chooser would
not pick through the module's private ``_launch``.  The batched engine's
stages and the verified backends are held against the same calls on the
CPU, and the kernels that size their shared memory per launch against a
second card where the process sees one.  The sharded runner is held on a
mesh of one card repeated four times against the local backend, and on
two cards where the process sees two; olmoe's prefill attention (D = 128,
T = 2048) on the ``wgmma`` instance.  Reduced jamba and whisper run
their prefill through the kernels (1 flash and 7 scan launches; 6 flash
launches) and match the CPU.

Training: the flash backward kernel against its plain version within
``flash_attention.grad_agreement``'s limits (fp32: 1e-5 relative Frobenius
per gradient; bf16: 2^-7, and per element 2^-6 of |ref| plus the row's
rms plus a tenth of the gradient's rms) at every head dim and dtype, the
routed instance (``choose_bwd_instance``: ``wgmma`` for aligned bf16 at D
64 and 128), the ``wgmma`` and ``mma_sync`` instances on the same operands
(T = 1500, T != S, q_offset), the same bits twice, three planted faults
rejected; the serve forward writing no lse; one reduced fp32 train step on the
card against the CPU's.  The recurrences' backward kernels (``rwkv6_bwd``,
``selective_scan_bwd``) against ``torch.autograd.grad`` of their plain
forwards within ``rwkv6.grad_agreement`` and ``selective_scan
.grad_agreement`` (the flash backward's limits), at the training
microbatches cut in width, ragged T, both dtypes, with start and final
state gradients; the same bits twice; planted faults rejected; both
running under autograd, and reduced rwkv and jamba train steps on the card
against the CPU's.  The selective scan's ``tma`` and
``simple`` instances on the same operands.

Several ranks: one NCCL rank equals the one-card trainer bit for
bit; two gloo ranks on the one card (FSDP over ``data = 2``) equal one
rank with 2 microbatches within 1e-6; ``compress_pod`` keeps
``compressed_psum``'s guarantees on CUDA tensors, read from the trainer's
own reductions (both through ``tools/multicard_train.py``, the harness
``chip_smoke.py`` shares); no wrapper launches on a ``meta`` tensor.

Every mod-p kernel on all-(p-1) operands at the edge of the overflow
obligation that certifies it (``repro_torch.analysis.overflow``), equal to
the closed form; ``python -m repro_torch.launch.serve`` on the card at a
reduced config, launching the model's kernel, the same tokens twice.

Without the ``gpu`` marker (they run on the CPU; nothing launches): the
backward's and the scan's choosers on strided CPU views."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import (
    _build,
    instance_counts,
    launch_counts,
    reset_launch_counts,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import modmatmul as mm
from repro_torch.kernels.flash_attention import (
    agreement,
    flash_attention,
    flash_attention_plain,
)
from repro_torch.kernels.modmatmul import modmatmul, modmatmul_batched, modmatmul_plain
from repro_torch.kernels.polyeval import polyeval, polyeval_plain
from repro_torch.kernels.ring_fold import ring_fold, ring_fold_plain
from repro_torch.kernels.rwkv6 import agreement as wkv_agreement
from repro_torch.kernels.rwkv6 import rwkv6, rwkv6_plain
from repro_torch.kernels.selective_scan import (
    selective_scan,
    selective_scan_plain,
)
from repro_torch.models import jamba as jb
from repro_torch.models import rwkv as rw
from repro_torch.models import transformer as tr
from repro_torch.models import whisper as wh
from repro_torch.mpc import P_DEFAULT, P_MERSENNE31, Field, MPCSpec, connect
from repro_torch.serve import Engine

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
                      "modmatmul": len(shapes), "polyeval": 0,
                      "flash_attention": 0, "flash_attention_bwd": 0,
                      "rwkv6": 0, "rwkv6_bwd": 0, "ring_fold": 0,
                      "selective_scan": 0, "selective_scan_bwd": 0}


# (W, M, K, N): the main path's product cut to 128, ragged edges in every
# dim, one row and column, a K past one 128-byte tile, and K past one s32
# run (8192) with ragged ends; then the persistent walk's edges: one tile
# (fewer units than SMs), an odd number of M-tiles for the 2-CTA cluster
# (960 = 15 x 64), unit counts no multiple of 132 / 2, W = 5 (the sharded
# backend) and W = 34 at the main width, ragged M and N together
TC_SHAPES = [(17, 128, 128, 128), (3, 33, 65, 17), (2, 1, 7, 1),
             (4, 64, 3000, 64), (2, 70, 130, 200), (1, 65, 9000, 129),
             (1, 64, 64, 64), (1, 960, 256, 192), (3, 960, 640, 1000),
             (7, 100, 300, 700), (5, 1024, 1024, 1024),
             (34, 1024, 1024, 1024), (5, 1000, 300, 1100)]


@pytest.mark.gpu
@pytest.mark.parametrize("p", PRIMES)
def test_gpu_modmatmul_tensor_core_equals_plain(cuda, p):
    """The tensor-core instance on every shape, chosen or not: equal to the
    plain version; the all-(p-1) corner at K = 3000, at K = 8256 and 8257
    (either side of the certified run) and at K = 20000 (three s32 runs)
    equal to the closed form."""
    g = torch.Generator(device=cuda)
    g.manual_seed(p % 997)
    for w, m, k, n in TC_SHAPES:
        a, b = _rand(g, p, (w, m, k)), _rand(g, p, (w, k, n))
        got = mm._launch(a, b, p=p, instance="tensor_core")
        assert torch.equal(got, modmatmul_plain(a, b, p=p)), (w, m, k, n)
    for k in (3000, 8256, 8257, 20000):
        a = torch.full((2, 64, k), p - 1, dtype=torch.int64, device=cuda)
        b = torch.full((2, k, 64), p - 1, dtype=torch.int64, device=cuda)
        got = mm._launch(a, b, p=p, instance="tensor_core")
        assert bool((got == (pow(p - 1, 2, p) * k) % p).all()), k


@pytest.mark.gpu
def test_gpu_modmatmul_chooser_routes_and_counts(cuda):
    """Full 64x64 tiles take the tensor cores, the tags shape (N = 1) the
    skinny instance, a small ragged product the CUDA cores; each launch
    counted under its instance."""
    p = P_DEFAULT
    g = torch.Generator(device=cuda)
    g.manual_seed(11)
    reset_launch_counts()
    a, b = _rand(g, p, (3, 128, 200)), _rand(g, p, (3, 200, 64))
    assert torch.equal(modmatmul_batched(a, b, p=p), modmatmul_plain(a, b, p=p))
    v, r = _rand(g, p, (17, 2**16)), _rand(g, p, (2**16, 1))
    assert torch.equal(modmatmul(v, r, p=p), modmatmul_plain(v, r, p=p))
    x, y = _rand(g, p, (33, 70)), _rand(g, p, (70, 45))
    assert torch.equal(modmatmul(x, y, p=p), modmatmul_plain(x, y, p=p))
    torch.cuda.synchronize()
    assert instance_counts()["modmatmul_batched"] == {
        "tensor_core": 1, "skinny": 0, "cuda_core": 0}
    assert instance_counts()["modmatmul"] == {"tensor_core": 0, "skinny": 1,
                                              "cuda_core": 1}
    with pytest.raises(ValueError, match="unknown modmatmul instance"):
        mm._launch(a, b, p=p, instance="bogus")


@pytest.mark.gpu
@pytest.mark.parametrize("p", PRIMES)
def test_gpu_polyeval_kernel_equals_plain(cuda, p):
    g = torch.Generator(device=cuda)
    g.manual_seed(p % 977)
    reset_launch_counts()
    # row groups of 1, 2 and 4 threads, several passes of rows (N > 64),
    # ragged tiles, odd C, one column
    shapes = [(17, 6, 4096), (17, 17, 4096), (17, 2, 999), (4, 6, 4096),
              (40, 70, 333), (1, 1, 5), (64, 9, 1025), (70, 3, 513),
              (33, 19, 1)]
    for n, k, c in shapes:
        v, t = _rand(g, p, (n, k)), _rand(g, p, (k, c))
        assert torch.equal(polyeval(v, t, p=p), polyeval_plain(v, t, p=p))
    torch.cuda.synchronize()
    assert launch_counts()["polyeval"] == len(shapes)


@pytest.mark.gpu
@pytest.mark.parametrize("p", PRIMES)
def test_gpu_polyeval_operand_forms_equal_plain(cuda, p):
    """The survivors' rows through a device index, two sources stacked,
    rows whose starts are not 16-byte aligned (odd C, a column slice),
    and every element p-1 at K = 19: all equal to the plain version."""
    g = torch.Generator(device=cuda)
    g.manual_seed(p % 991)
    reset_launch_counts()
    cases = []
    for c in (4096, 1001, 1):                  # odd C: rows alternate
        src = _rand(g, p, (17, c))
        idx = torch.tensor([0, 2, 3, 7, 11, 16], device=cuda)
        cases.append((_rand(g, p, (4, 6)), src, idx))
        cases.append((_rand(g, p, (17, 19)),
                      (_rand(g, p, (17, c)), _rand(g, p, (2, c))), None))
    big = _rand(g, p, (19, 1300))
    view = big[:, 1:1000]                      # every row 8 bytes off
    assert view.data_ptr() % 16 == 8
    cases.append((_rand(g, p, (17, 19)), (view[:17], view[17:]), None))
    cases.append((_rand(g, p, (17, 10)), view, torch.arange(
        18, 8, -1, device=cuda)))
    full = torch.full((19, 2051), p - 1, dtype=torch.int64, device=cuda)
    vfull = torch.full((17, 19), p - 1, dtype=torch.int64, device=cuda)
    cases.append((vfull, (full[:17], full[17:]), None))
    cases.append((vfull, full, torch.arange(19, device=cuda)))
    for vand, terms, idx in cases:
        got = polyeval(vand, terms, p=p, rows=idx)
        assert torch.equal(got, polyeval_plain(vand, terms, p=p, rows=idx))
    corner = (pow(p - 1, 2, p) * 19) % p
    assert bool((got == corner).all())
    torch.cuda.synchronize()
    assert launch_counts()["polyeval"] == len(cases)


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
                      "polyeval": 4 * blocks, "flash_attention": 0,
                      "flash_attention_bwd": 0, "rwkv6": 0, "rwkv6_bwd": 0,
                      "ring_fold": 0, "selective_scan": 0,
                      "selective_scan_bwd": 0}


# (B, T, S, Hq, Hkv, D, dtype, causal, q_offset)
FLASH_CASES = [
    (1, 512, 512, 32, 8, 64, torch.bfloat16, True, 0),     # serve prefill
    (1, 1000, 1000, 32, 8, 64, torch.bfloat16, True, 0),   # ragged T = S
    (1, 128, 2048, 32, 8, 64, torch.bfloat16, True, 1920),  # T != S
    (2, 300, 700, 32, 8, 64, torch.bfloat16, False, 0),    # non-causal
    (1, 300, 300, 8, 2, 128, torch.bfloat16, True, 0),     # D = 128
    (2, 77, 130, 4, 4, 32, torch.bfloat16, True, 53),      # D = 32, ragged
    (2, 96, 96, 4, 1, 32, torch.float32, True, 0),
    (1, 200, 77, 8, 2, 128, torch.float32, False, 0),
    (3, 37, 37, 6, 3, 32, torch.float32, True, 0),         # odd everything
    (1, 8, 8, 2, 1, 64, torch.float32, True, -3),          # rows see no key
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_gpu_flash_kernel_equals_plain(cuda, case):
    b, t, s, hq, hkv, d, dtype, causal, q_offset = case
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda)
    g.manual_seed(t + s + d)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    # q, k and v as views into one fused projection: strided, not copied
    fused = draw(b, t, hq + 2 * hkv, d) if t == s else None
    if fused is not None:
        q, k, v = fused.split([hq, hkv, hkv], dim=2)
        assert not q.is_contiguous()
    else:
        q, k, v = draw(b, t, hq, d), draw(b, s, hkv, d), draw(b, s, hkv, d)
    reset_launch_counts()
    plain0 = flash_attention_plain.calls
    got = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    served = "wgmma" if dtype == torch.bfloat16 else "cuda_core"
    assert instance_counts()["flash_attention"][served] == 1
    assert flash_attention_plain.calls == plain0
    want = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    assert got.dtype == dtype and got.shape == (b, t, hq, d)
    assert agreement(got, want)["ok"], agreement(got, want)
    if dtype == torch.bfloat16:    # the earlier instance on the same operands
        old = fa._launch(q, k, v, instance="mma_sync", causal=causal,
                         q_offset=q_offset)
        assert agreement(old, want)["ok"], agreement(old, want)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 64, 128])
def test_gpu_flash_bf16_unaligned_operands(cuda, d):
    """Operands whose rows are not 16-byte aligned take the kernel's
    element-wise loads; the result is the same."""
    g = torch.Generator(device=cuda)
    g.manual_seed(d)
    big = torch.randn((2, 150, 12, d + 1), generator=g, device=cuda)
    big = big.to(torch.bfloat16)
    q, k, v = big[:, :, :8, 1:], big[:, :, 8:10, 1:], big[:, :, 10:, 1:]
    reset_launch_counts()
    got = flash_attention(q, k, v)
    want = flash_attention_plain(q, k, v)
    assert agreement(got, want)["ok"], agreement(got, want)
    assert instance_counts()["flash_attention"]["mma_sync"] == 1


@pytest.mark.gpu
def test_gpu_flash_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((1, 4, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(x, x, x)
    y = torch.zeros((1, 4, 64, 2), device=cuda).transpose(2, 3)   # D strided
    with pytest.raises(ValueError, match="unit stride"):
        flash_attention(y, y, y)
    # the wgmma instance refuses rows that are not 16-byte aligned, and no
    # instance takes the other dtype or an unknown name
    big = torch.zeros((1, 8, 4, 65), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(_build.KernelLaunchError, match="wgmma"):
        fa._launch(big[..., 1:], big[..., 1:], big[..., 1:], instance="wgmma")
    z = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError, match="cuda_core"):
        fa._launch(z, z, z, instance="cuda_core")
    with pytest.raises(ValueError, match="unknown flash_attention instance"):
        fa._launch(z, z, z, instance="bogus")


def _reduced_on(device):
    cfg = reduced(get_config("llama3.2-1b"))
    return cfg, tr.init_params(cfg, 0, device="cpu").to(device)


@pytest.mark.gpu
def test_gpu_prefill_runs_the_kernel_and_matches_the_cpu(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _reduced_on(cuda)
    _, cpu_params = _reduced_on("cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 70)))
    reset_launch_counts()
    plain0 = flash_attention_plain.calls
    logits, cache = tr.prefill(cfg, params, toks.to(cuda))
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == cfg.n_layers
    # the reduced model is fp32: the CUDA-core instance (bf16 takes wgmma,
    # held at full width in chip_smoke.py)
    assert instance_counts()["flash_attention"]["cuda_core"] == cfg.n_layers
    assert flash_attention_plain.calls == plain0
    want, want_cache = tr.prefill(cfg, cpu_params, toks)
    torch.testing.assert_close(logits.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(cache.k.cpu(), want_cache.k, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_gpu_bf16_prefill_takes_the_wgmma_instance(cuda):
    """A bf16 model with llama3.2-1b's head dim: gqa_project's q, k, v are
    16-byte aligned, so every layer's attention runs in the wgmma
    instance."""
    cfg = dataclasses.replace(reduced(get_config("llama3.2-1b")),
                              head_dim=64, dtype="bfloat16")
    params = tr.init_params(cfg, 0, device="cpu").to(cuda)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab,
                                                              (2, 300)))
    reset_launch_counts()
    logits, _ = tr.prefill(cfg, params, toks.to(cuda))
    torch.cuda.synchronize()
    assert instance_counts()["flash_attention"] == {
        "wgmma": cfg.n_layers, "mma_sync": 0, "cuda_core": 0}
    assert bool(torch.isfinite(logits).all())


@pytest.mark.gpu
def test_gpu_paged_serving_equals_the_contiguous_loop(cuda):
    cfg, params = _reduced_on(cuda)
    eng = Engine(cfg, params, block_size=4)
    assert eng.device.type == "cuda"
    rng = np.random.default_rng(2)
    for t in (3, 4, 5, 9, 33):
        prompt = rng.integers(0, cfg.vocab, (2, t))
        got = eng.generate(prompt, 6)
        assert got.device.type == "cuda" and got.shape == (2, 6)
        assert torch.equal(got, eng._generate_legacy(prompt, 6))


# (B, T, H, dtype, w_mean, with state0, strided views)
RWKV_CASES = [
    (4, 256, 32, torch.bfloat16, -6.0, False, False),   # the served layout
    (1, 1000, 32, torch.bfloat16, 0.0, True, False),    # ragged T, strong decay
    (2, 37, 3, torch.float32, -6.0, True, True),        # ragged, strided
    (1, 1, 2, torch.float32, 0.0, False, False),        # one step
    (3, 64, 5, torch.float32, 1.5, False, True),        # one whole tile
    (1, 1000, 32, torch.bfloat16, -6.0, False, False),  # the served [1,1000]
    (1, 1, 1, torch.bfloat16, -6.0, True, False),       # T = 1, B*H = 1
    (1, 333, 1, torch.bfloat16, 0.0, True, False),      # B*H = 1, ragged T
    (2, 100, 40, torch.bfloat16, -6.0, False, False),   # 16-column slices
    (2, 77, 4, torch.float32, -6.0, True, "odd"),       # rows not 16-byte
    (1, 70, 3, torch.bfloat16, 0.0, False, "odd"),      # aligned: copied by
]                                                       # ordinary loads


def _wkv_operands(g, b, t, h, dtype, w_mean, strided):
    dev = g.device
    if strided:   # r, k, v, w as views into one fused [B, T, H, 4*64]
        # ("odd": one element more, so no row starts 16-byte aligned)
        extra = 1 if strided == "odd" else 0
        fused = torch.randn((b, t, h, 4 * 64 + extra), generator=g, device=dev)
        r, k, v, w = fused.to(dtype)[..., extra:].split(64, dim=-1)
        w = w + w_mean
        assert not r.is_contiguous()
        assert (r.data_ptr() % 16 != 0) == (strided == "odd")
    else:
        r, k, v, w = (torch.randn((b, t, h, 64), generator=g, device=dev)
                      for _ in range(4))
        r, k, v, w = (x.to(dtype) for x in (r, k, v, w + w_mean))
    u = torch.randn((h, 64), generator=g, device=dev)
    return r, k, v, w, u


@pytest.mark.gpu
@pytest.mark.parametrize("case", RWKV_CASES, ids=str)
def test_gpu_rwkv6_kernel_equals_plain(cuda, case):
    b, t, h, dtype, w_mean, with_state0, strided = case
    g = torch.Generator(device=cuda)
    g.manual_seed(b * 1000 + t)
    r, k, v, w, u = _wkv_operands(g, b, t, h, dtype, w_mean, strided)
    s0 = (torch.randn((b, h, 64, 64), generator=g, device=cuda)
          if with_state0 else None)
    reset_launch_counts()
    plain0 = rwkv6_plain.calls
    out, state = rwkv6(r, k, v, w, u, state0=s0)
    torch.cuda.synchronize()
    assert launch_counts()["rwkv6"] == 1
    assert rwkv6_plain.calls == plain0
    want_out, want_state = rwkv6_plain(r, k, v, w, u, state0=s0)
    assert out.dtype == state.dtype == torch.float32
    assert out.shape == (b, t, h, 64) and state.shape == (b, h, 64, 64)
    assert wkv_agreement(out, want_out)["ok"], wkv_agreement(out, want_out)
    assert wkv_agreement(state, want_state)["ok"], wkv_agreement(state, want_state)


@pytest.mark.gpu
def test_gpu_rwkv6_check_rejects_planted_faults(cuda):
    """The kernel passes; the bonus term dropped, or the last 64 steps
    dropped from the state, fail the same check."""
    g = torch.Generator(device=cuda)
    g.manual_seed(5)
    r, k, v, w, u = _wkv_operands(g, 2, 300, 4, torch.bfloat16, -6.0, False)
    out, state = rwkv6(r, k, v, w, u)
    want_out, want_state = rwkv6_plain(r, k, v, w, u)
    assert wkv_agreement(out, want_out)["ok"]
    no_bonus, _ = rwkv6_plain(r, k, v, w, torch.zeros_like(u))
    assert not wkv_agreement(no_bonus, want_out)["ok"]
    _, short = rwkv6_plain(r[:, :-64], k[:, :-64], v[:, :-64], w[:, :-64], u)
    assert not wkv_agreement(short, want_state)["ok"]


@pytest.mark.gpu
def test_gpu_rwkv6_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((1, 4, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="K = V = 64"):
        rwkv6(x, x, x, x, torch.zeros((2, 32), device=cuda))
    y = torch.zeros((1, 4, 64, 2), device=cuda).transpose(2, 3)   # D strided
    with pytest.raises(ValueError, match="unit stride"):
        rwkv6(y, y, y, y, torch.zeros((2, 64), device=cuda))


def _reduced_rwkv_on(device):
    cfg = reduced(get_config("rwkv6-1.6b"))
    return cfg, rw.init_params(cfg, 0, device="cpu").to(device)


@pytest.mark.gpu
def test_gpu_rwkv_prefill_runs_the_kernel_and_matches_the_cpu(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _reduced_rwkv_on(cuda)
    _, cpu_params = _reduced_rwkv_on("cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 70)))
    reset_launch_counts()
    plain0 = rwkv6_plain.calls
    logits, cache = rw.prefill(cfg, params, toks.to(cuda))
    torch.cuda.synchronize()
    assert launch_counts()["rwkv6"] == cfg.n_layers
    assert rwkv6_plain.calls == plain0
    want, want_cache = rw.prefill(cfg, cpu_params, toks)
    torch.testing.assert_close(logits.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(cache.wkv.cpu(), want_cache.wkv, atol=1e-4,
                               rtol=1e-4)
    eng = Engine(cfg, params)
    got = eng.generate(toks.to(cuda), 5)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), Engine(cfg, cpu_params, device="cpu")
                       .generate(toks, 5))


# ------------------------------------------------ the skinny instance
# (W, M, K, N): the tags' shape cut in K, a wave of 8 lanes, ragged and odd
# K (scalar loads), N of 2, 3 and 4, rows past one pass (M > 32), K = 1
SKINNY_SHAPES = [(1, 17, 2**16, 1), (8, 17, 2**14, 1), (1, 17, 300001, 1),
                 (3, 5, 7777, 2), (2, 9, 4096, 3), (1, 40, 2048, 4),
                 (1, 70, 4096, 1), (2, 1, 1, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("p", PRIMES)
def test_gpu_skinny_instance_equals_plain(cuda, p):
    """Every skinny shape equal to the plain version, chosen through the
    wrappers and forced through ``_launch``; the all-(p-1) corner at a K
    of many fold windows equal to the closed form; a view 8 bytes off
    16-byte alignment takes the scalar loads and stays exact."""
    g = torch.Generator(device=cuda)
    g.manual_seed(p % 983)
    reset_launch_counts()
    for w, m, k, n in SKINNY_SHAPES:
        a, b = _rand(g, p, (w, m, k)), _rand(g, p, (w, k, n))
        want = modmatmul_plain(a, b, p=p)
        assert mm.choose_instance(w, m, k, n) == "skinny"
        assert torch.equal(modmatmul_batched(a, b, p=p), want), (w, m, k, n)
        assert torch.equal(mm._launch(a, b, p=p, instance="skinny"), want)
    k = 3 * 2048 * 8 + 5
    a = torch.full((2, 17, k), p - 1, dtype=torch.int64, device=cuda)
    b = torch.full((2, k, 1), p - 1, dtype=torch.int64, device=cuda)
    assert bool((modmatmul_batched(a, b, p=p) == (pow(p - 1, 2, p) * k) % p)
                .all())
    base = _rand(g, p, (17, 4097))
    view, r = base[:, 1:], _rand(g, p, (4096, 1))
    assert view.data_ptr() % 16 == 8
    assert torch.equal(mm._launch(view.contiguous()[None], r[None], p=p,
                                  instance="skinny")[0],
                       modmatmul_plain(view, r, p=p))
    torch.cuda.synchronize()
    assert instance_counts()["modmatmul_batched"]["skinny"] == \
        len(SKINNY_SHAPES) + 1


# --------------------------------------- F1: a second card in one process
@pytest.mark.gpu
def test_gpu_kernels_launch_on_a_second_card(cuda):
    """polyeval and rwkv6 set their shared-memory size on each launch, so
    after a launch on cuda:0 they launch on cuda:1 too (decided here, not
    at collection: skips where the process sees one card)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards in one process")
    p = P_DEFAULT
    for index in (0, 1, 0):
        dev = torch.device("cuda", index)
        g = torch.Generator(device=dev)
        g.manual_seed(index)
        v, t = _rand(g, p, (17, 19)), _rand(g, p, (19, 4096))
        assert torch.equal(polyeval(v, t, p=p), polyeval_plain(v, t, p=p))
        r, k, vv, w, u = _wkv_operands(g, 1, 64, 32, torch.bfloat16, -6.0, False)
        out, state = rwkv6(r, k, vv, w, u)
        want_out, want_state = rwkv6_plain(r, k, vv, w, u)
        assert out.device == dev
        assert wkv_agreement(out, want_out)["ok"]
        assert wkv_agreement(state, want_state)["ok"]
        torch.cuda.synchronize(dev)


# ------------------------------------ the batched engine and verified paths
@pytest.mark.gpu
@pytest.mark.parametrize("p", PRIMES)
def test_gpu_batched_stages_equal_the_cpu(cuda, p):
    """A wave's vfront, vtags and vdecode on the card, one launch per stage
    whatever the number of lanes: each lane's I-points equal the
    single-request ``front`` from the same key on the card (the card's
    and the CPU's generators draw differently), the tags equal the CPU
    stage's on the same I-points, and every lane decodes exactly."""
    spec = MPCSpec(s=2, t=2, z=2, m=64, field=Field(p))
    plan = spec.plan()
    rng = np.random.default_rng(p % 89)
    for lanes in (1, 8):
        a = torch.from_numpy(rng.integers(0, p, (lanes, 64, 64)))
        b = torch.from_numpy(rng.integers(0, p, (lanes, 64, 64)))
        keys = list(range(lanes))
        reset_launch_counts()
        got = plan.batched("vfront", cuda)(a.to(cuda), b.to(cuda), keys)
        torch.cuda.synchronize()
        front = launch_counts()
        gam = torch.from_numpy(rng.integers(1, p, lanes))
        offs = torch.from_numpy(rng.integers(0, p, (lanes, 17)))
        rv = torch.from_numpy(rng.integers(0, p, (lanes, 32 * 32)))
        tags = plan.batched("vtags", cuda)(got, gam.to(cuda), offs.to(cuda),
                                           rv.to(cuda))
        idx, rows = plan.survivor_tables((0, 2, 3, 7, 11, 16), cuda)
        ys = plan.batched("vdecode", cuda)(got, idx, rows)
        some = plan.batched("vdecode", cuda)(
            got, idx, rows, torch.tensor([lanes - 1], device=cuda))
        torch.cuda.synchronize()
        counts = launch_counts()
        assert front["polyeval"] == 3 and front["modmatmul_batched"] == 1
        assert counts["polyeval"] == 5 and counts["modmatmul_batched"] == 2
        assert instance_counts()["modmatmul_batched"]["skinny"] == 1
        stages = plan.stages(cuda)
        for lane, key in enumerate(keys):
            gen = torch.Generator(device=cuda)
            gen.manual_seed(key)
            assert torch.equal(got[lane], stages.front(
                a[lane].to(cuda), b[lane].to(cuda), gen))
        assert torch.equal(tags.cpu(), plan.batched("vtags", "cpu")(
            got.cpu(), gam, offs, rv))
        for lane in range(lanes):
            exact = np.array((a[lane].numpy().T.astype(object)
                              @ b[lane].numpy().astype(object)) % p, np.int64)
            np.testing.assert_array_equal(ys[lane].cpu().numpy(), exact)
        assert torch.equal(some[0], ys[lanes - 1])


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["local", "batched"])
def test_gpu_verified_sessions_equal_the_cpu(cuda, backend):
    """Scripted corruption through a verified session on the card: exact,
    the same corrections, evictions and injector log as on the CPU."""
    from repro_torch.mpc import FaultInjector

    spec = MPCSpec(s=2, t=2, z=2, m=16, adversaries=2)
    sched = {r: [(3, "tamper"), (9, "flip")] for r in range(8)}
    sched[1] = [(5, "stale"), (6, "tag")]
    rng = np.random.default_rng(77)
    a = rng.integers(0, spec.field.p, (20, 40))
    b = rng.integers(0, spec.field.p, (40, 24))
    want = np.array((a.astype(object) @ b.astype(object)) % spec.field.p,
                    np.int64)
    runs = {}
    for dev in (cuda, "cpu"):
        inj = FaultInjector(seed=5, schedule=sched)
        sess = connect(spec, backend=backend, injector=inj, device=dev,
                       **({"max_batch": 4, "wave_scalars": None}
                          if backend == "batched" else {}))
        y = sess.matmul(a, b, encoded=True)
        np.testing.assert_array_equal(y.cpu().numpy(), want)
        runs[str(dev)] = (dict(sess.stats), set(sess._dead), list(inj.log))
    assert runs[str(cuda)] == runs["cpu"]


@pytest.mark.gpu
@pytest.mark.parametrize("pipelined", [True, False])
def test_gpu_remote_threads_equal_local(cuda, pipelined):
    """``backend="remote"`` in thread mode on the card (the default device)
    at m = 128, two blocks: integer-equal to the local backend and the
    exact product.  Per block, each of the 17 workers launches one W = 1
    ``modmatmul_batched`` (tensor cores at m/t = 64) and one K = 1
    ``polyeval`` (its G row); the dealer launches 4 ``polyeval`` (encode
    twice, the mask term, decode)."""
    from repro_torch.kernels.modmatmul import choose_instance

    spec = MPCSpec(s=2, t=2, z=2)
    n = spec.n_workers
    rng = np.random.default_rng(91)
    a = rng.integers(0, spec.field.p, (128, 256))
    b = rng.integers(0, spec.field.p, (256, 128))
    want = np.array((a.astype(object) @ b.astype(object)) % spec.field.p,
                    np.int64)
    rem = connect(spec, backend="remote", pipelined=pipelined)
    assert rem.device.type == "cuda" and rem.backend.device == rem.device
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        y = rem.matmul(a, b, encoded=True, m=128)
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        rem.backend.close()
    assert y.is_cuda
    np.testing.assert_array_equal(y.cpu().numpy(), want)
    loc = connect(spec).matmul(a, b, encoded=True, m=128)
    assert torch.equal(y, loc)
    blocks = rem.backend.stats["blocks"]
    assert blocks == 2
    assert counts["modmatmul_batched"] == n * blocks
    assert counts["polyeval"] == (n + 4) * blocks
    assert choose_instance(1, 64, 64, 64) == "tensor_core"


@pytest.mark.gpu
@pytest.mark.parametrize("p", PRIMES)
def test_gpu_worker_g_row_equals_plain_and_numpy(cuda, p):
    """A remote worker's G row on the card (the W = 1 product, then one
    K = 1 ``polyeval`` of the slot's G-mix column against vec H) equals the
    plain version and the reference's NumPy product."""
    from repro_torch.mpc.protocol import AGECMPCProtocol
    from repro_torch.transport.worker import g_row

    proto = AGECMPCProtocol(s=2, t=2, z=2, m=256, field=Field(p))
    plan = proto.plan
    rng = np.random.default_rng(p % 1000)
    f_a = rng.integers(0, p, (128, 128))
    f_b = rng.integers(0, p, (128, 128))
    h = np.array((f_a.astype(object) @ f_b.astype(object)) % p, np.int64)
    for slot in (0, plan.n_workers - 1):
        col = torch.from_numpy(plan.g_mix[slot].reshape(-1, 1).copy())
        reset_launch_counts()
        got = g_row(plan.stages(cuda), col.to(cuda),
                    torch.from_numpy(f_a).to(cuda),
                    torch.from_numpy(f_b).to(cuda), p)
        torch.cuda.synchronize()
        assert launch_counts()["polyeval"] == 1
        plain = polyeval_plain(col.to(cuda),
                               torch.from_numpy(h).to(cuda).reshape(1, -1),
                               p=p)
        assert torch.equal(got, plain)
        want = (plan.g_mix[slot][:, None].astype(object)
                * h.reshape(1, -1).astype(object)) % p
        np.testing.assert_array_equal(got.cpu().numpy(), want.astype(np.int64))


@pytest.mark.gpu
@pytest.mark.parametrize("p", PRIMES)
def test_gpu_worker_g_row_at_path_width(cuda, p):
    """A remote worker's G row at the width the lm_head's blocks give it
    (m = 2048: a ``[1024, 1024]`` share product, C = 2^20): the W = 1
    product in the tensor-core instance, then one K = 1 ``polyeval``,
    equal to the plain version and to the NumPy product (each factor is
    below 2^31, so int64 holds it exactly)."""
    from repro_torch.kernels import instance_counts
    from repro_torch.mpc.protocol import AGECMPCProtocol
    from repro_torch.transport.worker import g_row

    proto = AGECMPCProtocol(s=2, t=2, z=2, m=2048, field=Field(p))
    plan = proto.plan
    gen = torch.Generator(device=cuda)
    gen.manual_seed(p % 1000)
    f_a = torch.randint(0, p, (1024, 1024), generator=gen, device=cuda)
    f_b = torch.randint(0, p, (1024, 1024), generator=gen, device=cuda)
    h = modmatmul_plain(f_a, f_b, p=p).reshape(1, -1)
    slot = plan.n_workers - 1
    col = torch.from_numpy(plan.g_mix[slot].reshape(-1, 1).copy()).to(cuda)
    reset_launch_counts()
    got = g_row(plan.stages(cuda), col, f_a, f_b, p)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["modmatmul_batched"] == counts["polyeval"] == 1
    assert instance_counts()["modmatmul_batched"]["tensor_core"] == 1
    assert got.shape == (plan.n_workers, 1024 * 1024)
    assert torch.equal(got, polyeval_plain(col, h, p=p))
    want = (plan.g_mix[slot][:, None].astype(np.int64)
            * h.cpu().numpy()) % p
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.gpu
def test_gpu_timed_stages_record_one_sample_per_call(cuda):
    """``ProtocolStages.timed`` on the card: each call fenced and recorded
    once, results equal to the untimed stages."""
    from repro_torch.mpc.protocol import AGECMPCProtocol
    from repro_torch.sim import PhaseRecorder

    proto = AGECMPCProtocol(s=2, t=2, z=2, m=128)
    p = proto.field.p
    rec = PhaseRecorder()
    raw = proto.plan.stages(cuda)
    timed = raw.timed(rec, plan=proto.plan)
    assert timed.device == raw.device and raw.device.type == "cuda"
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.integers(0, p, (128, 128))).to(cuda)
    b = torch.from_numpy(rng.integers(0, p, (128, 128))).to(cuda)

    def gen(seed):
        g = torch.Generator(device=cuda)
        g.manual_seed(seed)
        return g

    f_a, f_b = timed.encode(a, b, gen(1))
    h = timed.worker_compute(f_a, f_b)
    i_pts = timed.exchange(h, gen(2))
    idx, rows = proto.plan.survivor_tables(tuple(range(6)), cuda)
    y = timed.decode(i_pts, idx, rows)
    y2 = timed.fused(a, b, gen(3))
    assert torch.equal(y, raw.fused(a, b, gen(3))) and torch.equal(y, y2)
    assert [s.phase for s in rec.samples] == [
        "encode", "worker_compute", "exchange", "decode", "fused"]
    assert all(s.device == -1 and s.us > 0 and s.scalars > 0
               for s in rec.samples)


# ------------------------------------------------------ the sharded runner
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("p", PRIMES)
def test_gpu_ring_fold_equals_plain(cuda, p, dtype):
    """Both payload types, an odd length, views 4 bytes off 16-byte
    alignment (the scalar path), and the all-(p-1) corner, where an int32
    sum would overflow for Mersenne-31."""
    g = torch.Generator(device=cuda)
    g.manual_seed(p % 1000)
    reset_launch_counts()
    cases = 0
    for n in (5 * 2**20, 1001, 3):
        a, b = (_rand(g, p, (n,)).to(dtype) for _ in range(2))
        assert torch.equal(ring_fold(a, b, p=p), ring_fold_plain(a, b, p=p))
        cases += 1
    buf = _rand(g, p, (2, 4097)).to(dtype)
    a, b = buf[0, 1:], buf[1, 1:]
    assert torch.equal(ring_fold(a, b, p=p), ring_fold_plain(a, b, p=p))
    x = torch.full((5, 1025), p - 1, dtype=dtype, device=cuda)
    out = ring_fold(x, x, p=p)
    assert out.dtype == dtype and bool((out == p - 2).all())
    torch.cuda.synchronize()
    assert launch_counts()["ring_fold"] == cases + 2



# ------------------------------------------- the overflow certificates' edges
@pytest.mark.gpu
@pytest.mark.parametrize("p", PRIMES)
def test_gpu_mod_p_kernels_at_the_certificates_edges(cuda, p):
    """Every mod-p kernel on all-(p-1) operands at the edge its overflow
    obligation certifies (``repro_torch.analysis.overflow``), equal to the
    closed form ``K (p-1)^2 mod p``: ``tensor_core`` at K = 2
    ``certified_k_run()`` + 1 (two full s32 runs and a ragged one);
    ``cuda_core`` at K = 2 ``certified_window(p)`` + 1 with one block a
    tile (each accumulator folds at the window twice) and with K split
    (the ``sum_splits`` pass); ``skinny`` and ``polyeval`` at the same K;
    ``ring_fold`` at a + b = 2 (p - 1), int32 and int64."""
    from repro_torch.analysis import overflow

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    k_win = 2 * overflow.certified_window(p) + 1
    k_run = 2 * overflow.certified_k_run() + 1

    def full(*shape, dtype=torch.int64):
        return torch.full(shape, p - 1, dtype=dtype, device=cuda)

    cases = [("tensor_core", (1, 64, k_run, 64)),
             ("cuda_core", (2, 768, k_win, 768)),
             ("cuda_core", (1, 64, k_win, 64)),
             ("skinny", (2, 17, k_win, 1))]
    assert mm.k_splits(2, 768, k_win, 768, sms)[0] == 1
    assert mm.k_splits(1, 64, k_win, 64, sms)[0] > 1 or p == P_MERSENNE31
    for instance, (w, m, k, n) in cases:
        got = mm._launch(full(w, m, k), full(w, k, n), p=p, instance=instance)
        assert bool((got == k * (p - 1) ** 2 % p).all()), (instance, k)
    got = polyeval(full(17, k_win), full(k_win, 1001), p=p)
    assert bool((got == k_win * (p - 1) ** 2 % p).all())
    for dtype in (torch.int32, torch.int64):
        x = full(5, 1025, dtype=dtype)
        assert bool((ring_fold(x, x, p=p) == p - 2).all())


# ---------------------------------------------------- the serving command line
@pytest.mark.gpu
@pytest.mark.parametrize("arch,kernel", [("llama3.2-1b", "flash_attention"),
                                         ("rwkv6-1.6b", "rwkv6")])
def test_gpu_launch_serve_runs_the_kernels_twice_alike(cuda, arch, kernel,
                                                       capsys):
    """``python -m repro_torch.launch.serve`` on the card (its default
    device) at a reduced config: the model's kernel launches, the tokens
    lie in the vocab, and a second run gives the same tokens."""
    from repro_torch.launch import serve as cli

    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "16", "--max-new", "4"]
    reset_launch_counts()
    first = cli.main(argv)
    torch.cuda.synchronize()
    launched = launch_counts()[kernel]
    second = cli.main(argv)
    assert launched > 0
    assert first.is_cuda and first.shape == (2, 4)
    assert int(first.max()) < reduced(get_config(arch)).vocab
    assert torch.equal(first, second)
    assert capsys.readouterr().out.count("[serve] generated (2, 4)") == 2

def _sharded_session(devices, p, **kw):
    from repro_torch.parallel import make_mesh

    mesh = make_mesh((len(devices),), ("model",), devices=devices)
    return connect(MPCSpec(s=2, t=2, z=2, field=Field(p)), backend="sharded",
                   mesh=mesh, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("wire,prg", [("int64", False), ("int32", True)])
@pytest.mark.parametrize("p", PRIMES)
def test_gpu_sharded_on_one_card_equals_local(cuda, p, wire, prg):
    """Four shards on cuda:0: Y equals the local backend's on the card and
    the exact product; per block 13 polyeval launches (3 per shard and the
    decode), 4 modmatmul_batched and, on the int32 wire, 12 ring_fold."""
    rng = np.random.default_rng(5)
    a, b = rng.integers(0, p, (9, 40)), rng.integers(0, p, (40, 24))
    want = np.array((a.astype(object) @ b.astype(object)) % p, np.int64)
    sess = _sharded_session(["cuda:0"] * 4, p, wire_dtype=wire, prg_masks=prg)
    assert sess.device == torch.device("cuda", 0)
    reset_launch_counts()
    got = sess.matmul(a, b, encoded=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    blocks = sess.stats["blocks"]
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    local = connect(MPCSpec(s=2, t=2, z=2, field=Field(p))).matmul(
        a, b, encoded=True)
    assert torch.equal(got, local)
    assert counts == {"modmatmul_batched": 4 * blocks, "modmatmul": 0,
                      "polyeval": 13 * blocks, "flash_attention": 0,
                      "flash_attention_bwd": 0, "rwkv6": 0, "rwkv6_bwd": 0,
                      "ring_fold": 12 * blocks if wire == "int32" else 0,
                      "selective_scan": 0, "selective_scan_bwd": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["int64", "int32"])
def test_gpu_sharded_on_two_cards(cuda, wire):
    """Shards on cuda:0 and cuda:1: every launch on its shard's device and
    stream, the chunks crossing by Tensor.to (decided here, not at
    collection: skips where the process sees one card)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards in one process")
    p = P_DEFAULT
    rng = np.random.default_rng(6)
    a, b = rng.integers(0, p, (64, 64)), rng.integers(0, p, (64, 64))
    want = np.array((a.astype(object) @ b.astype(object)) % p, np.int64)
    sess = _sharded_session(["cuda:0", "cuda:1"], p, wire_dtype=wire,
                            prg_masks=wire == "int32")
    got = sess.matmul(a, b, encoded=True)
    torch.cuda.synchronize(0)
    torch.cuda.synchronize(1)
    assert got.device == torch.device("cuda", 0)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.gpu
def test_gpu_flash_at_olmoe_prefill_shape(cuda):
    """olmoe-1b-7b's prefill attention: bf16 causal [1,2048,16,128] on the
    wgmma instance, within agreement of the plain version."""
    g = torch.Generator(device=cuda)
    g.manual_seed(128)
    q, k, v = (torch.randn((1, 2048, 16, 128), generator=g,
                           device=cuda).to(torch.bfloat16) for _ in range(3))
    assert fa.choose_instance(q, k, v) == "wgmma"
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert instance_counts()["flash_attention"]["wgmma"] == 1
    a = agreement(got, flash_attention_plain(q, k, v, causal=True))
    assert a["ok"], a


@pytest.mark.gpu
def test_gpu_moe_prefill_matches_the_cpu(cuda):
    """Reduced olmoe (fp32) on the card against the same weights on the
    CPU: prefill logits within 1e-4, the FFN's routing the same."""
    cfg = reduced(get_config("olmoe-1b-7b"))
    cpu = tr.init_params(cfg, 0, device="cpu")
    gpu = tr.Transformer(cpu.embed.to(cuda),
                         [tr.MoELayer({k: lp[k].to(cuda)
                                       for k in tr.MOE_LAYER_KEYS})
                          for lp in cpu.layers],
                         cpu.final_norm.to(cuda),
                         None if cpu.lm_head is None else cpu.lm_head.to(cuda))
    toks = torch.randint(0, cfg.vocab, (2, 37), generator=torch.Generator()
                         .manual_seed(3))
    want, _ = tr.prefill(cfg, cpu, toks)
    got, _ = tr.prefill(cfg, gpu, toks.to(cuda))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


# ----------------------------------------------------- the selective scan
# (B, T, Di, N, dtype, dt mean, strided): the served layout cut in T and Di;
# a ragged T on views cut from wider tensors (as the model's split of x_bc
# hands b_t and c_t over); Di not a multiple of the block's channels; one
# step; N of 8 and 32; strong decay
SCAN_CASES = [
    (2, 300, 256, 16, torch.bfloat16, -4.0, False),
    (1, 1000, 512, 16, torch.float32, -4.0, True),
    (3, 64, 100, 8, torch.float32, 0.0, False),
    (1, 1, 16, 32, torch.bfloat16, -4.0, True),
    (2, 129, 72, 32, torch.float32, 1.0, False),
    (1, 70, 40, 16, torch.bfloat16, 0.0, True),
]


def _scan_operands(g, b, t, di, n, dtype, dt_mean, strided):
    dev = g.device

    def draw(*shape):
        if strided:         # a view of every other column block of a wider one
            wide = torch.randn((*shape[:-1], 2 * shape[-1]), generator=g,
                               device=dev)
            return wide[..., :shape[-1]]
        return torch.randn(shape, generator=g, device=dev)

    u = draw(b, t, di)
    dt = torch.nn.functional.softplus(draw(b, t, di) + dt_mean)
    b_t, c_t = draw(b, t, n), draw(b, t, n)
    a = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(
        di, n).contiguous() * (1 + 0.1 * torch.rand((di, 1), generator=g,
                                                    device=dev))
    return tuple(x.to(dtype) for x in (u, dt)) + (a,) + tuple(
        x.to(dtype) for x in (b_t, c_t))


@pytest.mark.gpu
@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_gpu_selective_scan_equals_plain(cuda, case):
    b, t, di, n, dtype, dt_mean, strided = case
    g = torch.Generator(device=cuda)
    g.manual_seed(b * 1000 + t + di)
    ops = _scan_operands(g, b, t, di, n, dtype, dt_mean, strided)
    reset_launch_counts()
    plain0 = selective_scan_plain.calls
    y, state = selective_scan(*ops, return_state=True)
    y_only = selective_scan(*ops)
    torch.cuda.synchronize()
    assert launch_counts()["selective_scan"] == 2
    assert selective_scan_plain.calls == plain0
    want_y, want_state = selective_scan_plain(*ops, return_state=True)
    assert y.dtype == state.dtype == torch.float32
    assert y.shape == (b, t, di) and state.shape == (b, di, n)
    assert torch.equal(y, y_only)
    assert wkv_agreement(y, want_y)["ok"], wkv_agreement(y, want_y)
    assert wkv_agreement(state, want_state)["ok"], wkv_agreement(state,
                                                                 want_state)


# (B, T, Di, N, dtype): the served shapes cut in Di, a ragged T, Di not a
# multiple of the tma instance's 32 channels, and N of 8 and 32
SCAN_INSTANCE_CASES = [
    (1, 2048, 512, 16, torch.bfloat16),
    (4, 512, 256, 16, torch.bfloat16),
    (1, 1000, 256, 16, torch.float32),
    (2, 130, 72, 8, torch.bfloat16),
    (1, 70, 40, 32, torch.float32),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SCAN_INSTANCE_CASES, ids=str)
def test_gpu_selective_scan_instances_agree(cuda, case):
    """Both instances on the same operands, each within ``agreement`` of
    the plain version on y and the final state; the chooser takes tma."""
    b, t, di, n, dtype = case
    g = torch.Generator(device=cuda)
    g.manual_seed(b * 7 + t + di + n)
    ops = _scan_operands(g, b, t, di, n, dtype, -4.0, False)
    from repro_torch.kernels import selective_scan as ss

    assert ss.choose_instance(ops[0], ops[1], ops[3], ops[4]) == "tma"
    want_y, want_h = selective_scan_plain(*ops, return_state=True)
    for instance in ss.INSTANCES:
        y, h = ss._launch(*ops, instance=instance, return_state=True)
        torch.cuda.synchronize()
        assert wkv_agreement(y, want_y)["ok"], (instance, wkv_agreement(y, want_y))
        assert wkv_agreement(h, want_h)["ok"], (instance, wkv_agreement(h, want_h))


@pytest.mark.gpu
def test_gpu_selective_scan_check_rejects_planted_faults(cuda):
    """The kernel passes; a dropped decay (a = 0), or b_t one step late,
    fail the same check."""
    g = torch.Generator(device=cuda)
    g.manual_seed(6)
    ops = _scan_operands(g, 2, 400, 256, 16, torch.bfloat16, -4.0, False)
    u, dt, a, b_t, c_t = ops
    y, state = selective_scan(*ops, return_state=True)
    want_y, want_state = selective_scan_plain(*ops, return_state=True)
    assert wkv_agreement(y, want_y)["ok"] and wkv_agreement(state,
                                                            want_state)["ok"]
    no_decay = selective_scan_plain(u, dt, torch.zeros_like(a), b_t, c_t,
                                    return_state=True)
    late = selective_scan_plain(u, dt, a, torch.roll(b_t, 1, dims=1), c_t,
                                return_state=True)
    for bad_y, bad_state in (no_decay, late):
        assert not wkv_agreement(bad_y, want_y)["ok"]
        assert not wkv_agreement(bad_state, want_state)["ok"]


@pytest.mark.gpu
def test_gpu_selective_scan_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((1, 4, 16), device=cuda)
    bc = torch.zeros((1, 4, 4), device=cuda)
    with pytest.raises(ValueError, match="N in"):
        selective_scan(x, x, torch.zeros((16, 4), device=cuda), bc, bc)
    y = torch.zeros((1, 16, 4), device=cuda).transpose(1, 2)    # Di strided
    b8 = torch.zeros((1, 4, 8), device=cuda)
    with pytest.raises(ValueError, match="unit stride"):
        selective_scan(y, y, torch.zeros((16, 8), device=cuda), b8, b8)


# ------------------------------------------- the hybrid and encdec families
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_jamba_prefill_runs_the_kernels_and_matches_the_cpu(cuda, dtype):
    """Reduced jamba (8 layers, N 8) on the card: 1 flash and 7 scan
    launches a prefill, no plain call; fp32 logits within 1e-4 of the CPU's
    and greedy tokens equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced(get_config("jamba-v0.1-52b")), dtype=dtype)
    cpu = jb.init_params(cfg, 0, device="cpu")
    gpu = jb.init_params(cfg, 0, device="cpu").to(cuda)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab,
                                                              (2, 70)))
    reset_launch_counts()
    plain0 = flash_attention_plain.calls + selective_scan_plain.calls
    logits, cache = jb.prefill(cfg, gpu, toks.to(cuda))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["flash_attention"] == 1 and counts["selective_scan"] == 7
    assert sum(counts.values()) == 8
    assert flash_attention_plain.calls + selective_scan_plain.calls == plain0
    if dtype == "float32":
        want, want_cache = jb.prefill(cfg, cpu, toks)
        torch.testing.assert_close(logits.cpu(), want, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(cache.ssm[0].cpu(), want_cache.ssm[0],
                                   atol=1e-4, rtol=1e-4)
        got = Engine(cfg, gpu).generate(toks.to(cuda), 4)
        assert torch.equal(got.cpu(), Engine(cfg, cpu, device="cpu")
                           .generate(toks, 4))


@pytest.mark.gpu
def test_gpu_whisper_prefill_runs_the_kernels_and_matches_the_cpu(cuda):
    """Reduced whisper (2 + 2 layers): 6 flash launches a prefill (encoder
    self, decoder self and cross), none in decode; logits within 1e-4 of
    the CPU's and greedy tokens equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("whisper-small"))
    cpu = wh.init_params(cfg, 0, device="cpu")
    gpu = wh.init_params(cfg, 0, device="cpu").to(cuda)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9)))
    frames = torch.from_numpy(rng.standard_normal((2, 150, cfg.d_model))
                              .astype(np.float32))
    reset_launch_counts()
    plain0 = flash_attention_plain.calls
    logits, _ = wh.prefill(cfg, gpu, toks.to(cuda), embeds=frames.to(cuda))
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 6
    assert flash_attention_plain.calls == plain0
    want, _ = wh.prefill(cfg, cpu, toks, embeds=frames)
    torch.testing.assert_close(logits.cpu(), want, atol=1e-4, rtol=1e-4)
    got = Engine(cfg, gpu).generate(toks.to(cuda), 5, embeds=frames.to(cuda))
    assert launch_counts()["flash_attention"] == 12
    assert torch.equal(got.cpu(), Engine(cfg, cpu, device="cpu")
                       .generate(toks, 5, embeds=frames))


# ------------------------------------------------ training: flash backward
# (B, T, S, Hq, Hkv, D, dtype, causal, q_offset): every head dim and dtype,
# GQA and not, T != S, q_offset, ragged tiles and rows that see no key
BWD_CASES = [
    (2, 256, 256, 32, 8, 64, torch.bfloat16, True, 0),     # llama's heads
    (1, 300, 300, 8, 2, 128, torch.bfloat16, True, 0),     # D = 128
    (1, 200, 200, 16, 16, 128, torch.bfloat16, True, 0),   # olmoe: no GQA
    (2, 77, 130, 4, 4, 32, torch.bfloat16, True, 53),      # D = 32, ragged
    (2, 100, 150, 12, 12, 64, torch.bfloat16, False, 0),   # whisper cross
    (1, 64, 64, 2, 1, 64, torch.bfloat16, True, -20),      # rows see no key
    (2, 96, 96, 4, 1, 32, torch.float32, True, 0),
    (1, 200, 77, 8, 2, 128, torch.float32, False, 0),
    (1, 130, 130, 4, 2, 64, torch.float32, True, 0),
    (1, 50, 50, 2, 1, 64, torch.float32, True, -10),       # rows see no key
]


def _bwd_operands(cuda, case, seed):
    b, t, s, hq, hkv, d, dtype = case[:7]
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    return (draw(b, t, hq, d), draw(b, s, hkv, d), draw(b, s, hkv, d),
            draw(b, t, hq, d))


@pytest.mark.gpu
@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_gpu_flash_bwd_kernel_equals_plain(cuda, case):
    """The backward kernel against its plain version within
    ``grad_agreement``'s limits, from the forward kernel's own lse (which
    must equal the plain version's, +inf where a row sees no key)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    causal, q_offset = case[7], case[8]
    q, k, v, do = _bwd_operands(cuda, case, sum(case[:6]))
    inst = fa.choose_instance(q, k, v)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), device=cuda)
    o = fa._launch(q, k, v, instance=inst, causal=causal, q_offset=q_offset,
                   lse=lse)
    _, lse_ref = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                       return_lse=True)
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_ref))
    seen = torch.isfinite(lse_ref)
    torch.testing.assert_close(lse[seen], lse_ref[seen], atol=1e-5, rtol=1e-6)
    reset_launch_counts()
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                 q_offset=q_offset)
    torch.cuda.synchronize()
    # the routed instance: wgmma for bf16 at D 64 and 128 (these operands
    # are fresh, so aligned), mma_sync at D = 32, cuda_core for fp32
    instance = ("cuda_core" if q.dtype == torch.float32 else
                "wgmma" if q.shape[-1] in (64, 128) else "mma_sync")
    assert fa.choose_bwd_instance(q, k, v) == instance
    assert launch_counts()["flash_attention_bwd"] == 1
    assert instance_counts()["flash_attention_bwd"][instance] == 1
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                        q_offset=q_offset)
    for x, g in zip((q, k, v), got, strict=True):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert torch.isfinite(g).all()
    a = fa.grad_agreement(got, want)
    assert a["ok"], a
    if q_offset < 0:                          # rows that see no key
        assert not got[0][:, :-q_offset].any()
    # no atomics: the same bits every run
    again = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                   q_offset=q_offset)
    assert all(torch.equal(x, y) for x, y in zip(got, again, strict=True))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gpu_flash_bwd_check_rejects_planted_faults(cuda, dtype):
    """D omitted, the scale dropped from dK and the GQA sum over one head
    each fail ``grad_agreement`` against the plain version; the kernel
    passes it."""
    case = (1, 256, 256, 8, 2, 64, dtype, True, 0)
    q, k, v, do = _bwd_operands(cuda, case, 11)
    o, lse = flash_attention_plain(q, k, v, return_lse=True)
    ref = fa.flash_attention_bwd_plain(q, k, v, o, do, lse)
    assert fa.grad_agreement(fa.flash_attention_bwd(q, k, v, o, do, lse),
                             ref)["ok"]
    no_delta = fa.flash_attention_bwd_plain(q, k, v, torch.zeros_like(o), do,
                                            lse)
    _, dk1, dv1 = fa.flash_attention_bwd_plain(
        q, k.repeat_interleave(4, 2), v.repeat_interleave(4, 2), o, do, lse)
    faults = {"D omitted": no_delta,
              "scale dropped from dK": (ref[0], ref[1] * 8.0, ref[2]),
              "GQA sum over one head": (ref[0], dk1[:, :, ::4], dv1[:, :, ::4])}
    for name, bad in faults.items():
        assert not fa.grad_agreement(bad, ref)["ok"], name


@pytest.mark.gpu
def test_gpu_flash_bwd_copies_unaligned_operands(cuda):
    """bf16 rows that are not 16-byte aligned are copied before the
    backward (it loads whole 16-byte rows); the gradients are the same."""
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    big = torch.randn((1, 150, 12, 65), generator=g, device=cuda)
    big = big.to(torch.bfloat16)
    q, k, v = big[:, :, :8, 1:], big[:, :, 8:10, 1:], big[:, :, 10:, 1:]
    do = torch.randn((1, 150, 8, 64), generator=g, device=cuda).to(torch.bfloat16)
    o, lse = flash_attention_plain(q, k, v, return_lse=True)
    assert fa.choose_bwd_instance(q, k, v) == "mma_sync"
    got = fa.flash_attention_bwd(q, k, v, o, do, lse)
    # the same instance on contiguous copies (the chooser would take wgmma)
    want = fa._bwd_launch(*(x.contiguous() for x in (q, k, v, o, do)), lse,
                          instance="mma_sync", causal=True)
    assert all(torch.equal(x, y) for x, y in zip(got, want, strict=True))


# (B, T, S, Hq, Hkv, D, causal, q_offset): whisper's ragged T = 1500 and its
# cross shape T != S, llama's GQA, D = 128, a negative q_offset whose rows
# see no key, a positive one, and one q tile
WGMMA_BWD_CASES = [
    (1, 1500, 1500, 2, 2, 64, False, 0),
    (2, 448, 1500, 4, 4, 64, False, 0),
    (1, 448, 448, 4, 4, 64, True, 0),
    (1, 512, 512, 16, 4, 64, True, 0),
    (1, 300, 300, 8, 2, 128, True, 0),
    (1, 200, 200, 4, 4, 128, False, 0),
    (1, 256, 256, 4, 2, 64, True, -70),
    (2, 77, 130, 4, 4, 128, True, 53),
    (1, 100, 100, 2, 1, 64, True, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WGMMA_BWD_CASES, ids=str)
def test_gpu_flash_bwd_wgmma_and_mma_sync_equal_plain(cuda, case):
    """The wgmma and the mma_sync backward on the same bf16 operands, each
    within ``grad_agreement`` of the plain version; rows that see no key get
    zero dq from both."""
    b, t, s, hq, hkv, d, causal, q_offset = case
    q, k, v, do = _bwd_operands(cuda, (b, t, s, hq, hkv, d, torch.bfloat16),
                                sum(case[:6]) + 7)
    kw = dict(causal=causal, q_offset=q_offset)
    lse = torch.empty((b, hq, t), device=cuda)
    o = fa._launch(q, k, v, instance="wgmma", lse=lse, **kw)
    assert fa.choose_bwd_instance(q, k, v) == "wgmma"
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    for instance in ("wgmma", "mma_sync"):
        got = fa._bwd_launch(q, k, v, o, do, lse, instance=instance, **kw)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(g).all()) for g in got), instance
        a = fa.grad_agreement(got, want)
        assert a["ok"], (instance, a)
        if q_offset < 0:
            assert not got[0][:, :-q_offset].any(), instance


@pytest.mark.gpu
def test_gpu_serve_forward_writes_no_lse(cuda):
    """Without autograd the forward passes no lse buffer (the serve path);
    under autograd it writes one and gives the same output bits."""
    q, k, v, _ = _bwd_operands(cuda, (1, 256, 256, 8, 2, 64, torch.bfloat16),
                               5)
    reset_launch_counts()
    with torch.no_grad():
        served = flash_attention(q, k, v)
    assert fa.flash_attention.lse_launches == 0
    assert launch_counts()["flash_attention"] == 1
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    trained = flash_attention(qs, ks, vs)
    assert fa.flash_attention.lse_launches == 1
    assert torch.equal(served, trained.detach())
    grads = torch.autograd.grad(trained.float().sum(), (qs, ks, vs))
    assert launch_counts()["flash_attention_bwd"] == 1
    assert all(torch.isfinite(x).all() for x in grads)


# ------------------------------------- the recurrences' backward kernels
# (B, T, H, dtype, w mean, state0 and dstate, strided): rwkv6-1.6b's training
# microbatch cut in T and H, T a multiple of neither tile (16, 32), one
# step, fast decay (w ~ N(0, 1)), strided views as the model's heads are,
# rows that are not 16-byte aligned
RWKV_BWD_CASES = [
    (2, 256, 4, torch.bfloat16, -6.0, False, False),
    (2, 300, 3, torch.float32, -6.0, True, False),
    (1, 77, 2, torch.float32, 0.0, True, True),
    (1, 1, 2, torch.float32, 0.0, False, False),
    (3, 50, 5, torch.bfloat16, 0.0, True, "odd"),
    (1, 1000, 32, torch.bfloat16, -6.0, False, False),
]


def _wkv_grad_ref(r, k, v, w, u, s0, dout, dstate):
    """torch.autograd.grad of the plain forward on the same operands:
    (dr, dk, dv, dw, du, dstate0 or None)."""
    ops = [x.detach().clone().requires_grad_() for x in (r, k, v, w, u)]
    if s0 is not None:
        ops.append(s0.detach().clone().requires_grad_())
    out, state = rwkv6_plain(*ops[:5], state0=ops[5] if s0 is not None else None)
    loss = (out * dout).sum()
    if dstate is not None:
        loss = loss + (state * dstate).sum()
    # allow_unused: at T = 1 with no final-state gradient w reaches only
    # the unused final state (its gradient is 0)
    grads = torch.autograd.grad(loss, ops, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(ops, grads, strict=True)]
    return tuple(grads) + ((None,) if s0 is None else ())


@pytest.mark.gpu
@pytest.mark.parametrize("case", RWKV_BWD_CASES, ids=str)
def test_gpu_rwkv6_bwd_kernel_equals_autograd_of_plain(cuda, case):
    """dr, dk, dv, dw, du and dstate0 within ``rwkv6.grad_agreement`` of
    autograd of the plain forward, from the routed instance (``chunked`` for
    bf16, ``sweep`` for fp32) and, for bf16, from ``sweep`` too, the two
    instances within the same limits of each other (for fp32, ``chunked``
    within bf16's relative Frobenius limit); one launch, no plain
    call; the same bits twice; under autograd ``rwkv6`` runs the kernels
    both ways."""
    from repro_torch.kernels import rwkv6 as wk

    b, t, h, dtype, w_mean, states, strided = case
    g = torch.Generator(device=cuda)
    g.manual_seed(b * 100 + t + h)
    r, k, v, w, u = _wkv_operands(g, b, t, h, dtype, w_mean, strided)
    s0, ds = ((torch.randn((b, h, 64, 64), generator=g, device=cuda)
               for _ in range(2)) if states else (None, None))
    dout = torch.randn((b, t, h, 64), generator=g, device=cuda)
    routed = wk.choose_bwd_instance(r, k, v, w)
    assert routed == ("chunked" if dtype == torch.bfloat16 else "sweep")
    reset_launch_counts()
    plain0 = wk.rwkv6_bwd_plain.calls
    got = wk.rwkv6_bwd(r, k, v, w, u, dout, state0=s0, dstate=ds)
    torch.cuda.synchronize()
    assert launch_counts()["rwkv6_bwd"] == 1 and wk.rwkv6_bwd_plain.calls == plain0
    assert instance_counts()["rwkv6_bwd"][routed] == 1
    assert all(x.dtype == dtype for x in got[:4]) and got[4].dtype == u.dtype
    assert (got[5] is None) == (s0 is None)
    want = _wkv_grad_ref(r, k, v, w, u, s0, dout, ds)
    a = wk.grad_agreement(got, want)
    assert a["ok"], a
    again = wk.rwkv6_bwd(r, k, v, w, u, dout, state0=s0, dstate=ds)
    assert all(x is None or torch.equal(x, y) for x, y in zip(got, again,
                                                              strict=True))
    if routed == "chunked":
        sweep = wk._bwd_launch(r, k, v, w, u, dout, state0=s0, dstate=ds,
                               instance="sweep")
        assert wk.grad_agreement(sweep, want)["ok"]
        assert wk.grad_agreement(got, sweep)["ok"]
    else:
        # chunked on fp32 operands (never routed: its TF32 products miss
        # fp32's 1e-5) still lies within bf16's 2^-7 in relative Frobenius
        tf32 = wk.grad_agreement(wk._bwd_launch(
            r, k, v, w, u, dout, state0=s0, dstate=ds, instance="chunked"), want)
        assert all(tf32[n]["rel_frob"] <= 2.0 ** -7 for n in wk.GRAD_NAMES
                   if n in tf32), tf32
    ops = [x.detach().clone().requires_grad_() for x in (r, k, v, w, u)]
    reset_launch_counts()
    out, state = rwkv6(*ops, state0=s0)
    loss = (out * dout).sum() + (0 if ds is None else (state * ds).sum())
    grads = torch.autograd.grad(loss, ops)
    assert launch_counts()["rwkv6"] == 1 and launch_counts()["rwkv6_bwd"] == 1
    assert wk.grad_agreement(list(grads) + [None], list(want[:5]) + [None])["ok"]


@pytest.mark.gpu
def test_gpu_rwkv6_bwd_check_rejects_planted_faults(cuda, monkeypatch):
    """The kernel passes; dw's sign flipped on the last tile, du with one
    head dropped and the reverse sweep starting one step late fail the
    same check."""
    from repro_torch.kernels import rwkv6 as wk

    g = torch.Generator(device=cuda)
    g.manual_seed(8)
    ops = _wkv_operands(g, 2, 300, 4, torch.bfloat16, -6.0, False)
    dout = torch.randn((2, 300, 4, 64), generator=g, device=cuda)
    want = _wkv_grad_ref(*ops, None, dout, None)
    got = wk.rwkv6_bwd(*ops, dout)
    assert wk.grad_agreement(got, want)["ok"]
    dw = got[3].clone()
    dw[:, -wk.BWD_TILE:] *= -1
    du = got[4].clone()
    du[0] = 0
    late = dout.clone()
    late[:, -1] = 0
    dr_late = wk.rwkv6_bwd_plain(*ops, late)
    faults = {"dw sign flipped on the last tile": got[:3] + (dw,) + got[4:],
              "du with one head dropped": got[:4] + (du, None),
              "the reverse sweep one step late": (got[0],) + dr_late[1:4]
              + got[4:]}
    # the chunked instance's arithmetic with a fault planted (its plain
    # version): each chunk handed the start state of the chunk before it,
    # and the sums of log-decay before and after each step of a sub-chunk
    # swapped (every gate referenced to the sub-chunk's wrong end)
    assert wk.grad_agreement(wk.rwkv6_bwd_chunked_plain(*ops, dout), want)["ok"]
    scan, sums = wk._chunk_scan, wk._gate_sums

    def shifted(tot, x, init, *, reverse=False):
        states, last = scan(tot, x, init, reverse=reverse)
        return (states if reverse else states[:1] + states[:-1]), last

    for fault, name, fn in (("chunk_state", "_chunk_scan", shifted),
                            ("gate", "_gate_sums", lambda lq: sums(lq)[::-1])):
        with monkeypatch.context() as m:
            m.setattr(wk, name, fn)
            faults[fault] = wk.rwkv6_bwd_chunked_plain(*ops, dout)
    for name, bad in faults.items():
        assert not wk.grad_agreement(bad, want)["ok"], name


# (B, T, Di, N, dtype, dt mean, with dstate, strided): jamba's training
# microbatch cut in Di (the served layout: views of wider tensors), a ragged
# T, Di not a multiple of 32, N of 8 and 32, fp32, a large dt
SCAN_BWD_CASES = [
    (1, 2048, 256, 16, torch.bfloat16, -4.0, False, True),
    (2, 300, 72, 16, torch.float32, -4.0, True, False),
    (1, 77, 40, 8, torch.bfloat16, 0.0, True, True),
    (2, 33, 64, 32, torch.float32, 1.0, False, False),
    (1, 1, 16, 16, torch.float32, -4.0, True, False),
]


def _scan_grad_ref(u, dt, a, b_t, c_t, dy, dstate):
    """torch.autograd.grad of the plain forward on the same operands:
    (du, ddt, da, db, dc)."""
    ops = [x.detach().clone().requires_grad_() for x in (u, dt, a, b_t, c_t)]
    y, state = selective_scan_plain(*ops, return_state=True)
    loss = (y * dy).sum()
    if dstate is not None:
        loss = loss + (state * dstate).sum()
    return torch.autograd.grad(loss, ops)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SCAN_BWD_CASES, ids=str)
def test_gpu_selective_scan_bwd_kernel_equals_autograd_of_plain(cuda, case):
    """du, ddt, da, db and dc within ``selective_scan.grad_agreement`` of
    autograd of the plain forward, from the checkpoints of either forward
    instance; one launch; the same bits twice; the serve forward writes no
    checkpoint and its y equals the checkpointing launch's."""
    from repro_torch.kernels import selective_scan as ss

    b, t, di, n, dtype, dt_mean, with_ds, strided = case
    g = torch.Generator(device=cuda)
    g.manual_seed(b * 10 + t + di + n)
    ops = _scan_operands(g, b, t, di, n, dtype, dt_mean, strided)
    dy = torch.randn((b, t, di), generator=g, device=cuda)
    ds = torch.randn((b, di, n), generator=g, device=cuda) if with_ds else None
    want = _scan_grad_ref(*ops, dy, ds)
    routed = ss.choose_bwd_instance(ops[0], ops[1], ops[3], ops[4])
    assert routed == ("tma" if dtype == torch.bfloat16 else "sweep")
    for instance in ss.INSTANCES:
        y, _, hck = ss._launch(*ops, instance=instance, return_state=True,
                               checkpoints=True)
        assert hck.shape == (b, -(-t // 32), di, n)
        assert torch.equal(y, ss._launch(*ops, instance=instance))
        reset_launch_counts()
        plain0 = ss.selective_scan_bwd_plain.calls
        got = ss.selective_scan_bwd(*ops, dy, dstate=ds, checkpoints=hck)
        torch.cuda.synchronize()
        assert launch_counts()["selective_scan_bwd"] == 1
        assert instance_counts()["selective_scan_bwd"][routed] == 1
        assert ss.selective_scan_bwd_plain.calls == plain0
        assert [x.dtype for x in got] == [dtype, dtype, torch.float32, dtype,
                                          dtype]
        a = ss.grad_agreement(got, want)
        assert a["ok"], (instance, a)
        again = ss.selective_scan_bwd(*ops, dy, dstate=ds, checkpoints=hck)
        assert all(torch.equal(x, y) for x, y in zip(got, again, strict=True))
        # each backward instance, the same bits twice, the two within the
        # limits of each other
        each = {}
        for bwd in ss.BWD_INSTANCES:
            each[bwd] = ss._bwd_launch(*ops, dy, dstate=ds, checkpoints=hck,
                                       instance=bwd)
            assert ss.grad_agreement(each[bwd], want)["ok"], (instance, bwd)
            twice = ss._bwd_launch(*ops, dy, dstate=ds, checkpoints=hck,
                                   instance=bwd)
            assert all(torch.equal(x, y)
                       for x, y in zip(each[bwd], twice, strict=True))
        assert ss.grad_agreement(each["tma"], each["sweep"])["ok"]


@pytest.mark.gpu
def test_gpu_selective_scan_bwd_check_rejects_planted_faults(cuda,
                                                            monkeypatch):
    """The kernel passes; h_{t-1} read from the wrong tile (checkpoints one
    stretch off) and db without one block's partial fail the same check."""
    from repro_torch.kernels import selective_scan as ss

    g = torch.Generator(device=cuda)
    g.manual_seed(9)
    ops = _scan_operands(g, 1, 400, 96, 16, torch.bfloat16, -4.0, True)
    dy = torch.randn((1, 400, 96), generator=g, device=cuda)
    want = _scan_grad_ref(*ops, dy, None)
    _, _, hck = ss._launch(*ops, instance="tma", return_state=True,
                           checkpoints=True)
    got = ss.selective_scan_bwd(*ops, dy, checkpoints=hck)
    assert ss.grad_agreement(got, want)["ok"]
    wrong_tile = ss.selective_scan_bwd(*ops, dy,
                                       checkpoints=hck.roll(1, dims=1).contiguous())
    u, dt, a, b_t, c_t = ops
    first = ss.selective_scan_bwd_plain(u[..., :32], dt[..., :32], a[:32], b_t,
                                        c_t, dy[..., :32])
    db = (got[3].float() - first[3].float()).to(got[3].dtype)
    # G's chain taking e_t in place of e_{t+1}: the kept decay one step off
    monkeypatch.setattr(ss, "_next_decay", lambda e: e)
    e_shift = ss.selective_scan_bwd_plain(*ops, dy)
    for name, bad in {"h_{t-1} from the wrong tile": wrong_tile,
                      "db without one block": got[:3] + (db, got[4]),
                      "e_t one step off in G's chain": e_shift}.items():
        assert not ss.grad_agreement(bad, want)["ok"], name


@pytest.mark.gpu
def test_gpu_rwkv6_and_selective_scan_refuse_under_grad(cuda):
    """The name is kept from when neither recurrence kernel had a backward
    (ROADMAP ground rule 7).  Under autograd on the card both now run:
    their forward kernels once, their backward kernels once, no plain
    version; and rwkv's and jamba's loss_fn train through them."""
    from repro_torch.kernels import rwkv6 as wk
    from repro_torch.kernels import selective_scan as ss

    r = torch.randn((1, 8, 2, 64), device=cuda, requires_grad=True)
    u = torch.zeros((2, 64), device=cuda)
    plain0 = (rwkv6_plain.calls, wk.rwkv6_bwd_plain.calls,
              selective_scan_plain.calls, ss.selective_scan_bwd_plain.calls)
    reset_launch_counts()
    out, _ = rwkv6(r, r, r, r, u)
    out.sum().backward()
    assert launch_counts()["rwkv6"] == 1 and launch_counts()["rwkv6_bwd"] == 1
    assert bool(torch.isfinite(r.grad).all())
    x = torch.randn((1, 8, 16), device=cuda, requires_grad=True)
    bc = torch.randn((1, 8, 16), device=cuda)
    a = -torch.ones((16, 16), device=cuda)
    selective_scan(x, x, a, bc, bc).sum().backward()
    assert (launch_counts()["selective_scan"] == 1
            and launch_counts()["selective_scan_bwd"] == 1)
    assert bool(torch.isfinite(x.grad).all())
    for arch, model, kernels in (("rwkv6-1.6b", rw, ("rwkv6", "rwkv6_bwd")),
                                 ("jamba-v0.1-52b", jb, ("selective_scan",
                                                         "selective_scan_bwd"))):
        cfg = dataclasses.replace(reduced(get_config(arch)), remat=False)
        params = model.init_params(cfg, 0, device=cuda).requires_grad_(True)
        tok = torch.zeros((1, 16), dtype=torch.long, device=cuda)
        reset_launch_counts()
        loss = model.loss_fn(cfg, params, tok, tok)
        grads = torch.autograd.grad(loss, list(params.parameters()),
                                    allow_unused=True)
        counts = launch_counts()
        layers = (cfg.n_layers if arch.startswith("rwkv") else
                  sum(not jb.is_attn_layer(cfg, l) for l in range(cfg.n_layers)))
        assert all(counts[name] == layers for name in kernels), (arch, counts)
        assert all(bool(torch.isfinite(x).all()) for x in grads if x is not None)
    assert plain0 == (rwkv6_plain.calls, wk.rwkv6_bwd_plain.calls,
                      selective_scan_plain.calls,
                      ss.selective_scan_bwd_plain.calls)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_gpu_recurrent_train_step_matches_the_cpu(cuda, arch):
    """Reduced rwkv6-1.6b and jamba in fp32 (remat on) on the card against
    the CPU: every gradient leaf within 1e-5 relative Frobenius, and one
    train step in 2 microbatches (the recurrence kernels forward twice and
    backward once a layer and microbatch): loss, gnorm and the updated
    weights (as one vector: Adam's first step moves an element by
    ``lr g / (|g| + eps)``, which the last bits of a gradient near 0
    decide; on jamba's zero-initialised ``conv_b`` the CPU's own fp32 step
    lies farther than 1e-5 from an fp64 one) within 1e-5."""
    from repro_torch.models.api import get_model
    from repro_torch.train.step import (
        TrainConfig,
        make_optimizer,
        make_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced(get_config(arch)), remat=True)
    model = get_model(cfg)
    tc = TrainConfig(warmup=0, seq_chunk=32, microbatches=2)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))
             for k in ("tokens", "targets")}
    out = {}
    for dev in ("cpu", cuda):
        params = model.init_params(cfg, 0, device="cpu").to(dev).requires_grad_(True)
        on = {k: v.to(dev) for k, v in batch.items()}
        named = dict(params.named_parameters())
        grads = torch.autograd.grad(
            model.loss_fn(cfg, params, on["tokens"], on["targets"], seq_chunk=32),
            list(named.values()), allow_unused=True)
        grads = {n: (torch.zeros_like(w) if g is None else g).detach().cpu()
                 for (n, w), g in zip(named.items(), grads, strict=True)}
        opt_state = make_optimizer(tc).init(params)
        reset_launch_counts()
        params, _, m = make_train_step(cfg, tc)(params, opt_state, on)
        out[str(dev)] = (m, grads, torch.cat([p.detach().cpu().reshape(-1) for p
                                              in params.parameters()]),
                         launch_counts())
    (mc, gc, wc, _), (mg, gg, wg, counts) = out["cpu"], out[str(cuda)]
    fwd, bwd = (("rwkv6", "rwkv6_bwd") if arch.startswith("rwkv")
                else ("selective_scan", "selective_scan_bwd"))
    layers = (cfg.n_layers if arch.startswith("rwkv") else
              sum(not jb.is_attn_layer(cfg, l) for l in range(cfg.n_layers)))
    assert counts[fwd] == 2 * 2 * layers and counts[bwd] == 2 * layers, counts
    for name, want in gc.items():
        assert float((gg[name] - want).norm()) <= 1e-5 * float(want.norm()), name
    for key in ("loss", "gnorm", "lr"):
        assert float(mg[key]) == pytest.approx(float(mc[key]), rel=1e-5)
    assert float((wg - wc).norm()) <= 1e-5 * float(wc.norm())


@pytest.mark.gpu
def test_gpu_train_step_matches_the_cpu(cuda):
    """Reduced llama3.2-1b in fp32: one train step on the card (flash
    forward and backward kernels, 2 and 2 launches, remat off) against
    the same step on the CPU: loss, gnorm and the updated weights."""
    from repro_torch.models.convert import to_jax_tree
    from repro_torch.train.step import (
        TrainConfig,
        make_optimizer,
        make_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("llama3.2-1b"))
    tc = TrainConfig(warmup=0, seq_chunk=32)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))
             for k in ("tokens", "targets")}
    out = {}
    for dev in ("cpu", cuda):
        params = tr.init_params(cfg, 0, device="cpu").to(dev).requires_grad_(True)
        opt_state = make_optimizer(tc).init(params)
        reset_launch_counts()
        params, _, m = make_train_step(cfg, tc)(
            params, opt_state, {k: v.to(dev) for k, v in batch.items()})
        out[str(dev)] = (m, to_jax_tree(cfg, dict(params.named_parameters())),
                         launch_counts())
    (mc, pc, _), (mg, pg, counts) = out["cpu"], out[str(cuda)]
    assert counts["flash_attention"] == 2 and counts["flash_attention_bwd"] == 2
    for key in ("loss", "gnorm", "lr"):
        assert float(mg[key]) == pytest.approx(float(mc[key]), rel=1e-5)
    # per weight, 1e-5 in relative Frobenius norm: an element whose
    # gradient is near 0 moves by lr g / (|g| + eps), which the last bits of
    # g decide
    leaves = [(pg["embed"], pc["embed"]), (pg["final_norm"], pc["final_norm"])]
    leaves += [(pg["layers"][n], pc["layers"][n]) for n in pc["layers"]]
    for got, want in leaves:
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


# ------------------------------------------------- several ranks on the card
def _rank_tc(microbatches=1, lr=1e-2):
    from repro_torch.train.step import TrainConfig

    return TrainConfig(peak_lr=lr, warmup=0, seq_chunk=32,
                       microbatches=microbatches)


def _harness():
    """``tools/multicard_train.py``: the multi-rank harness that
    ``chip_smoke.py`` and the CPU tests share."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import multicard_train

    return multicard_train


@pytest.mark.gpu
def test_gpu_one_nccl_rank_equals_the_one_card_trainer(cuda, tmp_path):
    """Reduced llama3.2-1b in fp32, 3 steps: one rank of NCCL on a
    ``data = 1`` process mesh (every gradient and the loss all-gathered,
    a real NCCL launch each) gives the one-card trainer's losses and
    weights bit for bit."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import process_mesh
    from repro_torch.launch.train import init_ranks, train_loop
    from repro_torch.parallel import fsdp

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("llama3.2-1b"))
    kw = dict(steps=3, global_batch=4, seq_len=32, ckpt_dir=None, device=cuda)
    p1, _, l1 = train_loop(cfg, _rank_tc(), **kw)
    init_ranks(0, 1, device="cuda", backend=None,
               init_method=f"file://{tmp_path / 'rendezvous'}")
    try:
        assert dist.get_backend() == "nccl"
        fsdp.reset_stats()
        p2, _, l2 = train_loop(cfg, _rank_tc(), mesh=process_mesh(
            (1,), ("data",), device="cuda"), **kw)
        calls = dict(fsdp.STATS["calls"])
    finally:
        dist.destroy_process_group()
    assert l1 == l2
    n = sum(1 for _ in p1.parameters())
    assert calls == {"all_gather": 3 * (n + 1)}
    for a, b in zip(p1.parameters(), p2.parameters(), strict=True):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_gpu_two_ranks_on_one_card_equal_microbatches(cuda):
    """Two gloo ranks on the one card (NCCL refuses two ranks on one
    device), FSDP over ``data = 2``: the losses and every weight of one
    rank with 2 microbatches on the whole batch, within 1e-6 relative."""
    mc = _harness()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("llama3.2-1b"))
    job = dict(cfg=cfg, tc=_rank_tc(), device="cuda", backend="gloo",
               steps=3, batch=4, seq=32, repeat=False)
    got = mc.spawn(**job, shape=(2,), axes=("data",))
    assert got["backend"] == "gloo" and len(got["split"]) > 0
    ref = mc.one_rank(cfg, _rank_tc(2), device=cuda, steps=3, batch=4,
                      seq=32, repeat=False)
    cmp = mc.compare(got, ref)
    assert cmp["loss_diff"] <= 1e-6 and cmp["weight_diff"] <= 1e-6, cmp


@pytest.mark.gpu
def test_gpu_compress_pod_on_the_card(cuda):
    """Two gloo ranks on the one card over ``pod = 2``: the trainer's own
    reductions on CUDA tensors keep ``compressed_psum``'s guarantees at
    every step (residuals fed back from the state, exact; every element
    within ``scale / 2`` of the mean), and training with ``compress_pod``
    on a repeated batch lowers the loss."""
    mc = _harness()
    cfg = reduced(get_config("llama3.2-1b"))
    got = mc.spawn(cfg=cfg, tc=_rank_tc(lr=1e-3), device="cuda",
                   backend="gloo", steps=3, batch=4, seq=32, shape=(2,),
                   axes=("pod",), compress=True)
    assert got["report"]["ok"], got["report"]
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.gpu
def test_gpu_meta_branches_launch_nothing(cuda):
    """With a card present, every wrapper on ``meta`` tensors returns
    shapes and launches nothing: every counter stays 0."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.rwkv6 import rwkv6_bwd
    from repro_torch.kernels.selective_scan import selective_scan_bwd

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    reset_launch_counts()
    q, k = meta(1, 128, 4, 64), meta(1, 128, 2, 64)
    o = flash_attention(q, k, k)
    flash_attention_bwd(q, k, k, o, o, meta(1, 4, 128, dtype=torch.float32))
    r = meta(1, 64, 2, 64)
    rwkv6(r, r, r, r, meta(2, 64, dtype=torch.float32))
    rwkv6_bwd(r, r, r, r, meta(2, 64, dtype=torch.float32),
              meta(1, 64, 2, 64, dtype=torch.float32))
    u, bt, a = meta(1, 64, 32), meta(1, 64, 16), meta(32, 16, dtype=torch.float32)
    selective_scan(u, u, a, bt, bt)
    selective_scan_bwd(u, u, a, bt, bt, meta(1, 64, 32, dtype=torch.float32))
    i64 = torch.int64
    modmatmul_batched(meta(2, 64, 8, dtype=i64), meta(2, 8, 64, dtype=i64),
                      p=2**31 - 1)
    modmatmul(meta(64, 8, dtype=i64), meta(8, 64, dtype=i64), p=2**31 - 1)
    polyeval(meta(4, 3, dtype=i64), meta(3, 16, dtype=i64), p=2**31 - 1)
    ring_fold(meta(8, dtype=torch.int32), meta(8, dtype=torch.int32),
              p=2**31 - 1)
    torch.cuda.synchronize()
    assert all(n == 0 for n in launch_counts().values()), launch_counts()


# ----------------------------------------- the choosers, on the CPU (no card)
def _views(dtype, b, t, h, d, offset=0, width=None):
    """A [b, t, h, d] view of a flat CPU tensor starting ``offset`` elements
    in, with rows ``width`` elements apart (nothing launches)."""
    width = width or h * d
    flat = torch.zeros(offset + b * t * width, dtype=dtype)
    return flat[offset:].view(b, t, width)[..., :h * d].view(b, t, h, d)


@pytest.mark.parametrize("d,want", [(32, "mma_sync"), (64, "wgmma"),
                                    (128, "wgmma")])
def test_flash_bwd_chooser_routes_by_head_dim(d, want):
    q = _views(torch.bfloat16, 2, 40, 8, d)
    k = _views(torch.bfloat16, 2, 40, 2, d)
    assert fa.choose_bwd_instance(q, k, k) == want
    # views of one fused projection, as the models hand q, k and v over
    fused = _views(torch.bfloat16, 1, 40, 12, d)
    assert fa.choose_bwd_instance(*fused.split([8, 2, 2], dim=2)) == want


@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_chooser_takes_mma_sync_for_unaligned_bf16(d):
    shifted = _views(torch.bfloat16, 1, 40, 4, d, offset=1)   # base off 16 B
    ok = _views(torch.bfloat16, 1, 40, 4, d)
    assert fa.choose_bwd_instance(shifted, ok, ok) == "mma_sync"
    assert fa.choose_bwd_instance(ok, ok, shifted) == "mma_sync"
    odd = _views(torch.bfloat16, 1, 40, 4, d, width=4 * d + 4)  # row stride
    assert fa.choose_bwd_instance(ok, odd, ok) == "mma_sync"
    cut = _views(torch.bfloat16, 1, 40, 4, d + 1)[..., 1:]    # 2-byte offset
    assert fa.choose_bwd_instance(cut, ok, ok) == "mma_sync"


@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_bwd_chooser_takes_cuda_cores_for_fp32(d):
    x = _views(torch.float32, 1, 8, 4, d)
    assert fa.choose_bwd_instance(x, x, x) == "cuda_core"


def test_selective_scan_bwd_chooser_routes_by_alignment():
    from repro_torch.kernels.selective_scan import choose_bwd_instance

    for dtype in (torch.float32, torch.bfloat16):
        xz = torch.zeros((1, 50, 512), dtype=dtype)
        u = xz[..., :256]                        # the model's view of in_proj
        bc = torch.zeros((1, 50, 32), dtype=dtype)
        b_t, c_t = bc.chunk(2, dim=-1)
        want = "tma" if dtype == torch.bfloat16 else "sweep"
        assert choose_bwd_instance(u, u, b_t, c_t) == want
        off = torch.zeros(50 * 256 + 1, dtype=dtype)[1:].view(1, 50, 256)
        assert choose_bwd_instance(off, u, b_t, c_t) == "sweep"
        # dy [B, T, Di] in fp32: rows of whole 16-byte units only
        odd = torch.zeros((1, 50, 72), dtype=dtype)[..., :70]
        assert choose_bwd_instance(odd, odd, b_t, c_t) == "sweep"


def test_selective_scan_chooser_routes_by_alignment():
    from repro_torch.kernels.selective_scan import choose_instance

    for dtype in (torch.float32, torch.bfloat16):
        u = torch.zeros((2, 50, 256), dtype=dtype)
        bc = torch.zeros((2, 50, 32), dtype=dtype)
        b_t, c_t = bc.chunk(2, dim=-1)           # the model's split of x_bc
        assert choose_instance(u, u, b_t, c_t) == "tma"
        off = torch.zeros(2 * 50 * 256 + 1, dtype=dtype)[1:].view(2, 50, 256)
        assert choose_instance(off, u, b_t, c_t) == "simple"
        odd = torch.zeros((2, 50, 259), dtype=dtype)[..., :256]  # row stride
        assert choose_instance(u, odd, b_t, c_t) == "simple"
        b5 = torch.zeros((2, 50, 21), dtype=dtype)[..., 5:]      # 5-element base
        assert choose_instance(u, u, b5, c_t) == "simple"
