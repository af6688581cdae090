"""The attention and scan kernels at AI21-Jamba2-3B's training shapes on
the card, held against their plain versions.

One microbatch row of the ``jamba2-3b.train_2x8192`` cell: causal
attention ``[1, 8192, 20, 128]`` over one kv head (a 20:1 group at D 128)
and the selective scan ``[1, 8192, 5120, 16]``, forward and backward, all
in bf16 on the operands' fresh (aligned) layout, so the ``wgmma`` and
``tma`` instances serve them.  The limits are the kernels' own:
``flash_attention.agreement`` and ``grad_agreement``,
``selective_scan.agreement`` and ``grad_agreement``.  The plain versions
materialize ``[1, 20, 8192, 8192]`` and ``[1, 8192, 5120, 16]`` fp32
tensors, some 30 GB at once.

Every test needs a CUDA card: it carries the ``gpu`` marker and skips
itself where there is none.  The file imports neither JAX nor ``repro``::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_long.py
"""
import pytest
import torch

from repro_torch.kernels import (
    instance_counts,
    launch_counts,
    reset_launch_counts,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import selective_scan as ss

T, HQ, HKV, D = 8192, 20, 1, 128
DI, N = 5120, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _draw(g, *shape):
    return torch.randn(shape, generator=g, device=g.device).to(torch.bfloat16)


@pytest.mark.gpu
def test_gpu_flash_forward_and_backward_at_jamba2_shapes(cuda):
    """The forward (with its lse) and the backward at ``[1, 8192, 20/1,
    128]`` on ``wgmma``, each within its agreement of the plain version."""
    g = torch.Generator(device=cuda)
    g.manual_seed(8192)
    q, k, v, do = (_draw(g, 1, T, HQ, D), _draw(g, 1, T, HKV, D),
                   _draw(g, 1, T, HKV, D), _draw(g, 1, T, HQ, D))
    assert fa.choose_instance(q, k, v) == "wgmma"
    assert fa.choose_bwd_instance(q, k, v) == "wgmma"
    reset_launch_counts()
    lse = torch.empty((1, HQ, T), device=cuda)
    o = fa._launch(q, k, v, instance="wgmma", causal=True, q_offset=0, lse=lse)
    served = fa.flash_attention(q, k, v, causal=True)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(o, served)
    assert launch_counts()["flash_attention"] == 1
    assert instance_counts()["flash_attention"]["wgmma"] == 1
    assert instance_counts()["flash_attention_bwd"]["wgmma"] == 1
    want, lse_ref = fa.flash_attention_plain(q, k, v, causal=True,
                                             return_lse=True)
    a = fa.agreement(o, want)
    assert a["ok"], a
    del want
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=1e-6)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=True)
    for x, gx in zip((q, k, v), got, strict=True):
        assert gx.shape == x.shape and gx.dtype == x.dtype
    a = fa.grad_agreement(got, want)
    assert a["ok"], a


@pytest.mark.gpu
def test_gpu_selective_scan_forward_and_backward_at_jamba2_shapes(cuda):
    """The forward (with its checkpoints) and the backward at ``[1, 8192,
    5120, 16]`` on ``tma``, each within its agreement of the plain
    version; dt from a Mamba-like bias, B and C as the inner norms leave
    them."""
    g = torch.Generator(device=cuda)
    g.manual_seed(5120)
    u = _draw(g, 1, T, DI)
    dt = torch.nn.functional.softplus(
        torch.randn((1, T, DI), generator=g, device=cuda) - 4.0
    ).to(torch.bfloat16)
    b_t, c_t = _draw(g, 1, T, N), _draw(g, 1, T, N)
    a = -torch.arange(1, N + 1, dtype=torch.float32, device=cuda).expand(
        DI, N).contiguous()
    dy = torch.randn((1, T, DI), generator=g, device=cuda)
    ops = (u, dt, a, b_t, c_t)
    assert ss.choose_instance(u, dt, b_t, c_t) == "tma"
    assert ss.choose_bwd_instance(u, dt, b_t, c_t) == "tma"
    reset_launch_counts()
    y, state, hck = ss._forward(*ops, return_state=True, checkpoints=True)
    got = ss.selective_scan_bwd(*ops, dy, checkpoints=hck)
    torch.cuda.synchronize()
    assert instance_counts()["selective_scan"]["tma"] == 1
    assert instance_counts()["selective_scan_bwd"]["tma"] == 1
    want_y, want_state = ss.selective_scan_plain(*ops, return_state=True)
    for got_x, want_x in ((y, want_y), (state, want_state)):
        agree = ss.agreement(got_x, want_x)
        assert agree["ok"], agree
    del want_y, want_state
    want = ss.selective_scan_bwd_plain(*ops, dy)
    assert [x.dtype for x in got] == [torch.bfloat16] * 2 + [
        torch.float32] + [torch.bfloat16] * 2
    agree = ss.grad_agreement(got, want)
    assert agree["ok"], agree
