"""The frozen yardstick against figures worked out by hand, and the per-layer
metrics' arithmetic at tiny shapes."""
from __future__ import annotations

import pytest

from portbench.harness import readers, work
from portbench.harness.outcome import LayerContext, nearest_rank
from portbench.harness.trace import Trace

MS = 1e-3


def test_one_tensor_core_launch_bound_on_sixteen_limb_products():
    # [17 x 1024^3] mod p, 4 limbs, 16 products: 2 * 17 * 2^30 * 16
    # = 5.84e11 int8 operations at 1979 TOP/s = 0.2952 ms (PERF.md)
    nbytes, ops = work.modmatmul_work(17, 1024, 1024, 1024, limb_products=16)
    assert nbytes == 4 * 17 * 3 * 1024 ** 2
    assert ops == 2 * 17 * 1024 ** 3 * 16
    assert work.bound_s(nbytes, ops, work.INT8_OPS_PER_S) / MS == \
        pytest.approx(0.2952, abs=5e-5)


def test_block_bound_on_karatsuba_count():
    # 9 products: 3.286e11 operations = 0.1660 ms, above 2.14e8 bytes of
    # int32 residues at 3.35 TB/s = 0.0638 ms
    assert work.LIMB_PRODUCTS == 9
    got = work.modmatmul_block_bound_s(2, 2, 2, 17, 2048) / MS
    assert got == pytest.approx(2 * 17 * 1024 ** 3 * 9 / 1979e12 / MS)
    assert got == pytest.approx(0.1660, abs=5e-5)


def test_residues_count_the_four_bytes_p_needs():
    # p = 2^26 - 5 < 2^31: an int32 holds every residue
    assert work.ELEMENT_BYTES == 4
    assert (2 ** 26 - 5) < 2 ** (8 * work.ELEMENT_BYTES - 1)


def test_polyeval_block_bound_is_its_bytes():
    # encode A and B: 17x6 @ 6x2^20; exchange: 17x19 @ 19x2^20; decode
    # 4x6 @ 6x2^20: 4 ((23 + 23 + 36 + 10) 2^20 + 551) bytes of int32
    # residues (the tables 17x6, 17x6, 17x19, 4x6 hold the 551) = 0.1152 ms,
    # half the 0.2304 of the int64 count
    got = work.polyeval_block_bound_s(2, 2, 2, 17, 2048) / MS
    assert got == pytest.approx(4 * (92 * 2 ** 20 + 551) / 3.35e12 / MS)
    assert got == pytest.approx(0.1152, abs=5e-5)
    shapes = work.block_shapes(2, 2, 2, 17, 2048)
    assert shapes["worker_compute"] == (17, 1024, 1024, 1024)
    assert shapes["tables"] == [(17, 6, 2 ** 20), (17, 6, 2 ** 20),
                                (17, 19, 2 ** 20), (4, 6, 2 ** 20)]


def test_eq15_at_a_square_block_is_the_papers():
    m, s, t, z, n = 2048, 2, 2, 2, 17
    want = m ** 3 / (s * t * t) + m ** 2 + n * (t * t + z - 1) * m ** 2 / (t * t)
    assert work.computation_per_worker(m, m, m, s, t, z, n) == want


def test_private_call_ops_of_the_head():
    # 17 workers x eq. (15) at [2048, 4096] x [4096, 65536], 18 int8
    # operations a multiply-add: 2.19e13, 11.1 ms at 1979 TOP/s
    ops = work.private_call_ops(2048, 4096, 65536, 2, 2, 2, 17)
    per_worker = (2048 * 4096 * 65536 / 8 + 2048 * 65536
                  + 17 * 5 * 2048 * 65536 / 4)
    assert ops == pytest.approx(17 * per_worker * 18)
    assert ops / work.INT8_OPS_PER_S / MS == pytest.approx(11.08, abs=0.01)


def test_wkv_bounds_at_the_training_shape():
    # [2, 2048, 32, 64] in bf16: 101.7e6 bytes = 0.0304 ms; the backward's
    # 167.8e6 bytes = 0.0501 ms; both above their flops at bf16's peak
    nbytes, flops = work.wkv_work(2, 2048, 32, 2)
    assert work.bound_s(nbytes, flops, work.peak_flops(2)) / MS == \
        pytest.approx(0.0304, abs=5e-5)
    nbytes, flops = work.wkv_bwd_work(2, 2048, 32, 2)
    assert work.bound_s(nbytes, flops, work.peak_flops(2)) / MS == \
        pytest.approx(0.0501, abs=5e-5)
    assert work.peak_flops(4) == work.TF32_FLOPS_PER_S


def test_rwkv6_step_flops():
    # 1.447 B matmul weights at full width; 6 x that x 8192 tokens plus the
    # WKV's 17 K V a token, head and layer
    params = work.rwkv6_matmul_params(2048, 7168, 65536, 24, 32)
    assert params == pytest.approx(1.447e9, rel=1e-3)
    flops = work.rwkv6_step_flops(2048, 7168, 65536, 24, 32, 8192)
    assert flops == 6 * params * 8192 + 17 * 64 * 64 * 32 * 24 * 8192


def _ctx(**kw):
    base = dict(config={"mpc": {"s": 2, "t": 2, "z": 2, "n_workers": 17}},
                traffic={}, items=2, window_s=1.0, trace=None, counters={})
    base.update(kw)
    return LayerContext(**base)


def test_head_fill_at_tiny_shapes(checkout):
    from portbench.harness.cells import load_module

    fill = load_module(checkout, "metrics", "head_fill_pct")
    # two calls of [8, 96] x [96, 200] at m = 128: 1 x 1 x 2 blocks a call
    ctx = _ctx(counters={"shape": (8, 96, 200), "blocks": 4,
                         "block_side": 128})
    assert fill.read(ctx) == pytest.approx(100 * 2 * 8 * 96 * 200
                                           / (4 * 128 ** 3))
    assert readers.mpc_blocks(ctx) == (4, 128)
    assert fill.read(_ctx(counters={"shape": (8, 96, 200)})) is None
    assert fill.read(_ctx(counters={"shape": (8, 96, 200), "blocks": 4,
                                    "block_side": None})) is None


def test_block_side_accounts_for_every_block():
    from portbench.kinds.private_matmul import block_side

    mpc = {"s": 2, "t": 2}
    # the head: [2048, 4096] x [4096, 65536] at m 2048 is 1 x 2 x 32 blocks
    assert block_side(mpc, 2048, 4096, 65536, 64 * 3, 3) == 2048
    assert block_side(mpc, 2048, 4096, 65536, 63 * 3, 3) is None
    assert block_side(mpc, 2048, 4096, 65536, 0, 0) is None


def test_mfu_and_roofline_arithmetic(checkout):
    from portbench.harness.cells import load_module

    mfu = load_module(checkout, "metrics", "head_mfu_pct")
    ctx = _ctx(counters={"shape": (64, 64, 64)}, rest_items=10, rest_s=0.5)
    ops = work.private_call_ops(64, 64, 64, 2, 2, 2, 17)
    assert mfu.read(ctx) == pytest.approx(100 * 10 * ops / 1979e12 / 0.5)
    assert mfu.read(_ctx(counters={"shape": (64, 64, 64)})) is None
    # a kernel busy 2 ms of a 10 ms window against a 1 ms bound: 50 %
    tr = Trace((0, 10_000_000), [(1_000_000, 3_000_000, "void polyeval_kernel<9>(x)"),
                                  (2_000_000, 4_000_000, "other")], [])
    ctx = _ctx(trace=tr, items=2, rest_items=4, rest_s=0.006)
    assert readers.roofline_pct(ctx, r"\bpolyeval_kernel\b", 1e-3) == \
        pytest.approx(50.0)
    assert readers.roofline_pct(ctx, r"\bmissing\b", 1e-3) is None
    # 3 ms busy in a 10 ms window: 70 % idle, from the trace alone
    assert tr.busy_s == pytest.approx(3e-3)
    assert readers.idle_pct(ctx) == pytest.approx(70.0)
    assert readers.idle_pct(_ctx(trace=tr, rest_items=40,
                                 rest_s=1.0)) == pytest.approx(70.0)
    assert readers.idle_pct(_ctx()) is None


def test_trace_gaps_name_the_host_op():
    tr = Trace((0, 100), [(10, 20, "void k<1>(int)"), (60, 70, "k2")],
               [(0, 100, "portbench.window"), (20, 60, "aten::copy_"),
                (30, 50, "cudaMalloc")])
    assert tr.top_ops() == [["k", 1e-8], ["k2", 1e-8]]
    gaps = tr.idle_gaps(3)
    assert gaps[0] == ["cudaMalloc", 4e-8]
    assert gaps[1] == ["(no host op)", pytest.approx(3e-8)]
    tr.host.append((90, 95, "aten::mm"))
    assert tr.idle_gaps(2)[1] == ["before aten::mm", pytest.approx(3e-8)]


def test_nearest_rank():
    xs = [float(i) for i in range(1, 101)]
    assert nearest_rank(xs, 0.95) == 95.0
    assert nearest_rank([3.0], 0.95) == 3.0
