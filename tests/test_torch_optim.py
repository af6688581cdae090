"""The port's optimizer and schedules against the JAX package's.

``wsd`` and ``cosine`` equal JAX's (fp32, within 1e-6 relative: both take
a float32 power) over a grid of steps through warmup, plateau, decay and
past the end; ``global_norm``; one and three ``AdamW.update`` s with
clipping on and off and fp32 and bf16 state, within 1e-6 relative of
JAX's on the weights, the moments and the norm (bf16 state: the moments
are bf16 in both, so they may differ by one bf16 rounding, 2^-8
relative); the reference's own checks (a quadratic descends, the clip
reports the unclipped norm) on the port; the step counter stays on the
weights' device."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as j_adamw
from repro.optim import schedule as j_schedule
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import schedule as t_schedule

STEPS = [0, 1, 2, 5, 9, 10, 11, 50, 109, 110, 111, 115, 119, 120, 121, 500]


@pytest.mark.parametrize("floor", [0.0, 3e-5])
def test_wsd_equals_jax(floor):
    kw = dict(peak_lr=3e-4, warmup=10, stable=100, decay=10, floor=floor)
    for step in STEPS:
        want = float(j_schedule.wsd(step, **kw))
        got = t_schedule.wsd(step, **kw)
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == pytest.approx(want, rel=1e-6, abs=0), step


def test_wsd_reads_a_device_step_counter():
    step = torch.tensor(7, dtype=torch.int32)
    got = t_schedule.wsd(step, peak_lr=1e-3, warmup=10, stable=5, decay=5)
    assert got.device == step.device
    assert float(got) == pytest.approx(7e-4, rel=1e-6)


@pytest.mark.parametrize("warmup", [0, 10])
def test_cosine_equals_jax(warmup):
    kw = dict(peak_lr=1e-3, warmup=warmup, total=200, floor_ratio=0.1)
    for step in STEPS:
        want = float(j_schedule.cosine(step, **kw))
        assert float(t_schedule.cosine(step, **kw)) == pytest.approx(
            want, rel=1e-6, abs=1e-12), step


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((7, 5))).astype(np.float32),
            "b": (scale * rng.standard_normal(5)).astype(np.float32),
            "e": (scale * rng.standard_normal((3, 4, 2))).astype(np.float32)}


def test_global_norm_equals_jax():
    tree = _tree(0)
    want = float(j_adamw.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = t_adamw.global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    assert float(got) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_adamw_updates_equal_jax(n_steps, clip, state_dtype):
    kw = dict(weight_decay=0.1, clip_norm=clip, state_dtype=state_dtype)
    jopt, topt = j_adamw.AdamW(**kw), t_adamw.AdamW(**kw)
    p0 = _tree(1)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(n_steps):
        g = _tree(10 + i, scale=3.0)            # gnorm ~ 20: the clip acts
        lr = 1e-2 * (i + 1)
        jp, js, jn = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 js, jp, jnp.float32(lr))
        tp, ts, tn = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                                 ts, tp, torch.tensor(lr))
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    assert int(ts.step) == int(js.step) == n_steps
    mom = 2.0 ** -8 if state_dtype == "bfloat16" else 1e-6
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-7)
        for t_m, j_m in ((ts.mu[k], js.mu[k]), (ts.nu[k], js.nu[k])):
            assert t_m.dtype == getattr(torch, state_dtype)
            np.testing.assert_allclose(t_m.float().numpy(),
                                       np.asarray(j_m, np.float32), rtol=mom,
                                       atol=1e-12)


def test_adamw_bf16_weights_upcast_as_jax():
    """bf16 weights and gradients: the update runs in fp32 and the weights
    are rounded back once, as the reference's."""
    p0 = {"w": _tree(2)["w"]}
    g = {"w": _tree(3)["w"]}
    jopt, topt = j_adamw.AdamW(), t_adamw.AdamW()
    jp = {"w": jnp.asarray(p0["w"], jnp.bfloat16)}
    tp = {"w": torch.from_numpy(p0["w"]).to(torch.bfloat16)}
    jp, _, _ = jopt.update({"w": jnp.asarray(g["w"], jnp.bfloat16)},
                           jopt.init(jp), jp, 1e-2)
    tp, _, _ = topt.update({"w": torch.from_numpy(g["w"]).to(torch.bfloat16)},
                           topt.init(tp), tp, 1e-2)
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["w"].float().numpy(),
                                  np.asarray(jp["w"], np.float32))


def test_adamw_descends_quadratic():
    opt = t_adamw.AdamW(weight_decay=0.0, clip_norm=None)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"x": 2 * params["x"]}  # d/dx x²
        params, state, _ = opt.update(grads, state, params, lr=0.05)
    assert float(params["x"].abs().max()) < 0.5


def test_adamw_clipping_reports_the_unclipped_norm():
    opt = t_adamw.AdamW(clip_norm=1.0, weight_decay=0.0)
    params = {"x": torch.zeros(3)}
    state = opt.init(params)
    _, _, gnorm = opt.update({"x": torch.full((3,), 100.0)}, state, params, 1e-3)
    assert float(gnorm) == pytest.approx(np.sqrt(3) * 100, rel=1e-5)


def test_adamw_takes_a_module_and_a_gradient_list():
    lin = torch.nn.Linear(3, 2)
    opt = t_adamw.AdamW()
    state = opt.init(lin)
    assert set(state.mu) == {"weight", "bias"}
    before = lin.weight.detach().clone()
    opt.update([torch.ones(2, 3), torch.ones(2)], state, lin, 0.1)
    assert not torch.equal(before, lin.weight)
    assert state.step.device == lin.weight.device

