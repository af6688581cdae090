"""Plain reference of rwkv6 training: weights from the seed, the loss, its
gradients and the AdamW steps, in float32 with TF32 off.

The architecture is the repository's RWKV-6 (arXiv:2404.05892, as the JAX
package defines it): per block a time mix (token shift with static
mixes, r, k, v, g projections, a low-rank data-dependent decay
``w = w_base + tanh(x dw_a) dw_b``, the WKV-6 recurrence with bonus u, an
RMS norm over the whole width and the gate, the output projection) and a
channel mix (token shift, squared-ReLU FFN, sigmoid receptance), each
behind an RMS norm with a residual; then a final RMS norm and an untied
head, and the mean next-token cross entropy.  Departures from the paper,
which the repository makes too: the token-shift mixes of r, k, v, g are
static, and the WKV output is normed over the width, not per head.

The WKV-6 recurrence (``S_t = diag(exp(-exp(w_t))) S_{t-1} + k_t^T v_t``,
``out_t = r_t (S_{t-1} + diag(u) k_t^T v_t)``) is evaluated in chunks of
``CHUNK`` steps: inside a chunk every pair of steps with its exact decay
``exp(L_{t-1} - L_s)`` (never above 1), across chunks the state, so that
autograd is fast and nothing overflows.

Weights are drawn here, on the device, from the seed: one draw per kind of
leaf for all layers at once, in fp32, scaled by ``fan_in ** -0.5`` (norms
at 1, token-shift mixes at 0.5, decay base -6, u ~ N(0, 1)) and cast to
the configuration's dtype.  The benchmark hands the same tensors to the
program.

``warm_step`` follows one step on from a state the program reached (its
weights and AdamW moments), the one way to hold a step deep in the run
against a reference without re-running every step before it.

``precision="fp8"`` is the control: every matrix product takes its
operands rounded to float8 (e4m3 forward, e5m2 for the gradients in the
backward, each with one scale a tensor), as an fp8 training recipe would;
the rest stays float32.

This module imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.harness import traffic as gen

HEAD = 64
CHUNK = 16
LAYER_KEYS = ("tm_norm", "cm_norm", "mu_r", "mu_k", "mu_v", "mu_w", "mu_g",
              "w_r", "w_k", "w_v", "w_g", "w_o", "w_base", "dw_a", "dw_b",
              "u_bonus", "wkv_norm", "cm_mu", "cm_wk", "cm_wr", "cm_wv")


def _dims(cfg: dict):
    d, ff, vocab, n = (cfg["d_model"], cfg["d_ff"], cfg["vocab"],
                       cfg["n_layers"])
    return d, ff, vocab, n, d // HEAD, max(32, d // 64)


def _kinds(cfg: dict) -> List[Tuple[str, tuple, object]]:
    """Every kind of leaf: ``(name, shape, init, per_layer)``, where init is
    a constant or ``("normal", scale)`` and a per-layer kind has ``shape``
    in every layer."""
    d, ff, vocab, n, h, lora = _dims(cfg)
    return [
        ("embed", (vocab, d), ("normal", d ** -0.5), False),
        ("w_r", (d, d), ("normal", d ** -0.5), True),
        ("w_k", (d, d), ("normal", d ** -0.5), True),
        ("w_v", (d, d), ("normal", d ** -0.5), True),
        ("w_g", (d, d), ("normal", d ** -0.5), True),
        ("w_o", (d, d), ("normal", d ** -0.5), True),
        ("dw_a", (d, lora), ("normal", d ** -0.5), True),
        ("dw_b", (lora, d), ("normal", lora ** -0.5), True),
        ("u_bonus", (h, HEAD), ("normal", 1.0), True),
        ("cm_wk", (d, ff), ("normal", d ** -0.5), True),
        ("cm_wr", (d, d), ("normal", d ** -0.5), True),
        ("cm_wv", (ff, d), ("normal", ff ** -0.5), True),
        ("lm_head", (d, vocab), ("normal", d ** -0.5), False),
        ("tm_norm", (d,), 1.0, True), ("cm_norm", (d,), 1.0, True),
        ("wkv_norm", (d,), 1.0, True), ("mu_r", (d,), 0.5, True),
        ("mu_k", (d,), 0.5, True), ("mu_v", (d,), 0.5, True),
        ("mu_w", (d,), 0.5, True), ("mu_g", (d,), 0.5, True),
        ("cm_mu", (d,), 0.5, True), ("w_base", (d,), -6.0, True),
        ("final_norm", (d,), 1.0, False),
    ]


def initial_groups(cfg: dict, seed: int,
                   device) -> Iterator[Tuple[str, bool, torch.Tensor]]:
    """``(kind, per_layer, tensor)`` for every kind of leaf, one at a time:
    ``[n_layers, *shape]`` for per-layer kinds."""
    dt = getattr(torch, cfg["dtype"])
    n = cfg["n_layers"]
    for i, (name, shape, init, per_layer) in enumerate(_kinds(cfg)):
        full = ((n,) if per_layer else ()) + shape
        if isinstance(init, tuple):
            x = gen.normal(full, seed, "weights", i, device, std=init[1],
                           dtype=dt)
        else:
            x = torch.full(full, init, dtype=dt, device=device)
        yield name, per_layer, x


def initial_weights(cfg: dict, seed: int, device) -> dict:
    """The initial weights: ``embed``, ``final_norm``, ``lm_head`` and
    ``layers``, a list of ``{key: tensor}``."""
    out: dict = {"layers": [{} for _ in range(cfg["n_layers"])]}
    for name, per_layer, x in initial_groups(cfg, seed, device):
        if per_layer:
            for layer, xl in zip(out["layers"], x.unbind(0), strict=True):
                layer[name] = xl.clone()
        else:
            out[name] = x
    return out


def flat(weights: dict) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` named as the program's ``named_parameters``."""
    out = {"embed": weights["embed"]}
    for i, layer in enumerate(weights["layers"]):
        for key in LAYER_KEYS:
            out[f"layers.{i}.{key}"] = layer[key]
    out["final_norm"] = weights["final_norm"]
    out["lm_head"] = weights["lm_head"]
    return out


# ------------------------------------------------------------ matmuls --
def _fake_quant(x: torch.Tensor, dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        qx = _fake_quant(x, torch.float8_e4m3fn)
        qw = _fake_quant(w, torch.float8_e4m3fn)
        ctx.save_for_backward(qx, qw)
        return qx @ qw

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        qg = _fake_quant(g, torch.float8_e5m2)
        gx = qg @ qw.transpose(-1, -2)
        gw = qx.reshape(-1, qx.shape[-1]).transpose(0, 1) @ qg.reshape(
            -1, qg.shape[-1])
        return gx, gw


def _matmul(precision: str):
    if precision == "float32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"unknown precision {precision!r}")


# --------------------------------------------------------------- model --
def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _shift(x):
    return F.pad(x, (0, 0, 1, -1))


def wkv(r, k, v, w, u):
    """The WKV-6 output ``[B, T, H, V]`` from a zero state, in chunks."""
    b, t, h, kk = r.shape
    c = min(CHUNK, t)
    if t % c:
        raise ValueError(f"T = {t} is not a multiple of the chunk {c}")
    n = t // c

    def chunks(x):                   # [B, T, H, K] -> [B, H, N, C, K]
        return x.reshape(b, n, c, h, x.shape[-1]).permute(0, 3, 1, 2, 4)

    r, k, v, logd = chunks(r), chunks(k), chunks(v), chunks(-torch.exp(w))
    lc = torch.cumsum(logd, dim=3)                 # L_t, inclusive
    lx = lc - logd                                 # L_{t-1} within chunk
    below = torch.ones(c, c, dtype=torch.bool, device=r.device).tril(-1)
    diff = lx[:, :, :, :, None, :] - lc[:, :, :, None, :, :]
    gate = torch.exp(diff.masked_fill(~below[:, :, None], -math.inf))
    att = torch.einsum("bhntk,bhntsk,bhnsk->bhnts", r, gate, k)
    out = att @ v
    bonus = (r * u[None, :, None, None, :] * k).sum(-1, keepdim=True)
    out = out + bonus * v
    rq = r * torch.exp(lx)                         # query against S at start
    kq = k * torch.exp(lc[:, :, :, -1:] - lc)      # key decayed to chunk end
    state = torch.zeros(b, h, kk, v.shape[-1], dtype=r.dtype, device=r.device)
    inter = []
    for i in range(n):
        inter.append(rq[:, :, i] @ state)
        state = (state * torch.exp(lc[:, :, i, -1])[..., None]
                 + kq[:, :, i].transpose(-1, -2) @ v[:, :, i])
    out = out + torch.stack(inter, dim=2)
    return out.permute(0, 2, 3, 1, 4).reshape(b, t, h, v.shape[-1])


def _layer(x, p, eps, mm):
    b, t, d = x.shape
    h = d // HEAD
    hx = rms_norm(x, p["tm_norm"], eps)
    xx = _shift(hx)

    def mix(mu):
        return hx + (xx - hx) * mu

    r = mm(mix(p["mu_r"]), p["w_r"]).reshape(b, t, h, HEAD)
    k = mm(mix(p["mu_k"]), p["w_k"]).reshape(b, t, h, HEAD)
    v = mm(mix(p["mu_v"]), p["w_v"]).reshape(b, t, h, HEAD)
    g = F.silu(mm(mix(p["mu_g"]), p["w_g"]))
    w = p["w_base"] + mm(torch.tanh(mm(mix(p["mu_w"]), p["dw_a"])), p["dw_b"])
    o = wkv(r, k, v, w.reshape(b, t, h, HEAD), p["u_bonus"]).reshape(b, t, d)
    x = x + mm(rms_norm(o, p["wkv_norm"], eps) * g, p["w_o"])
    hc = rms_norm(x, p["cm_norm"], eps)
    xk = hc + (_shift(hc) - hc) * p["cm_mu"]
    kc = torch.square(torch.relu(mm(xk, p["cm_wk"])))
    rc = torch.sigmoid(mm(hc, p["cm_wr"]))
    return x + rc * mm(kc, p["cm_wv"])


def loss_fn(params: Dict[str, torch.Tensor], cfg: dict, tokens, targets, *,
            precision: str = "float32", seq_chunk: int = 512):
    """Mean next-token cross entropy; each layer and each chunk of the
    logits is recomputed in the backward pass."""
    mm = _matmul(precision)
    eps = cfg["norm_eps"]
    x = params["embed"][tokens]
    for i in range(cfg["n_layers"]):
        p = {key: params[f"layers.{i}.{key}"] for key in LAYER_KEYS}
        x = checkpoint(_layer, x, p, eps, mm, use_reentrant=False)
    x = rms_norm(x, params["final_norm"], eps)

    def piece(hx, tx):
        lg = mm(hx, params["lm_head"])
        return (torch.logsumexp(lg, -1)
                - lg.gather(-1, tx[..., None])[..., 0]).sum()

    t = x.shape[1]
    total = sum(checkpoint(piece, x[:, c0:c0 + seq_chunk],
                           targets[:, c0:c0 + seq_chunk], use_reentrant=False)
                for c0 in range(0, t, seq_chunk))
    return total / targets.numel()


# -------------------------------------------------------------- AdamW --
def wsd(step: int, tc: dict) -> float:
    """The warmup-stable-decay rate at 0-based ``step``."""
    peak, warm, stable, decay = (tc["peak_lr"], tc["warmup"], tc["stable"],
                                 tc["decay"])
    if step < warm:
        return peak * step / max(warm, 1)
    if step < warm + stable:
        return peak
    frac = min(max((step - warm - stable) / max(decay, 1), 0.0), 1.0)
    return peak * 0.1 ** frac


class _Adamw:
    """The configuration's AdamW over float32 leaves, one leaf at a time:
    each update returns the new weight (rounded through the stored dtype),
    moments and the clipped gradient's norm, and changes nothing it is
    given."""

    def __init__(self, cfg: dict):
        tc, adam = cfg["train"], cfg["adamw"]
        self.tc = tc
        self.b1, self.b2, self.eps = adam["b1"], adam["b2"], adam["eps"]
        self.wd = tc["weight_decay"]
        self.store = getattr(torch, cfg["dtype"])

    def gradients(self, params: dict, cfg: dict, batch: dict,
                  precision: str):
        """The loss and the clipped gradients, leaf by leaf."""
        loss = loss_fn(params, cfg, batch["tokens"], batch["targets"],
                       precision=precision, seq_chunk=self.tc["seq_chunk"])
        grads = torch.autograd.grad(loss, list(params.values()))
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
        scale = torch.clamp(self.tc["clip_norm"] / (gnorm + 1e-9), max=1.0)
        for g in grads:
            g.mul_(scale)
        return float(loss.detach()), grads

    @torch.no_grad()
    def update(self, p, g, mu, nu, step: int):
        """``(p, mu, nu)`` after 0-based ``step`` on leaf ``p``."""
        b1, b2 = self.b1, self.b2
        lr = wsd(step, self.tc)
        b1c, b2c = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + self.eps) + self.wd * p
        return (p - lr * delta).to(self.store).float(), mu, nu


class _NoTf32:
    def __enter__(self):
        self.was = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.was


def train(cfg: dict, seed: int, device, batches, *, steps: int = 3,
          precision: str = "float32") -> dict:
    """The first ``steps`` steps from the seed's weights on ``batches(i)``:
    each step's loss, each leaf's norm of the first clipped gradient, and
    each leaf's norm of its change after the steps.  Weights are held in
    the configuration's dtype between steps, as the configuration states;
    the arithmetic is float32."""
    opt = _Adamw(cfg)
    with _NoTf32():
        start = flat(initial_weights(cfg, seed, device))
        params = {k: v.to(torch.float32, copy=True).requires_grad_(True)
                  for k, v in start.items()}
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
        losses, first = [], {}
        for step in range(steps):
            loss, grads = opt.gradients(params, cfg, batches(step), precision)
            losses.append(loss)
            with torch.no_grad():
                for (name, p), g in zip(params.items(), grads, strict=True):
                    if step == 0:
                        first[name] = float(g.norm())
                    new, mu[name], nu[name] = opt.update(p, g, mu[name],
                                                         nu[name], step)
                    p.copy_(new)
            del grads
        change = {k: float((params[k].detach() - start[k].float()).norm())
                  for k in params}
        return {"losses": losses, "grad_norms": first, "change_norms": change}


def warm_step(cfg: dict, before: dict, batch: dict, *,
              precision: str = "float32") -> dict:
    """One step from a state the program reached, in float32: ``before``
    holds its weights (``params``), AdamW moments (``mu``, ``nu``), by the
    program's leaf names, and the 0-based ``step``; it is read, never
    changed.  The step's loss, each leaf's norm of the clipped gradient
    and of its change."""
    opt = _Adamw(cfg)
    step = before["step"]
    with _NoTf32():
        params = {k: v.to(torch.float32, copy=True).requires_grad_(True)
                  for k, v in before["params"].items()}
        loss, grads = opt.gradients(params, cfg, batch, precision)
        grad, change = {}, {}
        with torch.no_grad():
            for (name, p), g in zip(params.items(), grads, strict=True):
                grad[name] = float(g.norm())
                new, _, _ = opt.update(p, g, before["mu"][name].float(),
                                       before["nu"][name].float(), step)
                change[name] = float((new - p).norm())
        return {"losses": [loss], "grad_norms": grad, "change_norms": change}
