"""Plain reference of AI21-Jamba2-3B training: weights from the seed, the
loss, its gradients and the AdamW steps, in float32 with TF32 off.

The architecture is Hugging Face's ``JambaForCausalLM`` at the
configuration's keys (``model_type: jamba``): token embeddings, then per
layer ``x + mixer(rms_norm(x))`` and ``x + mlp(rms_norm(x))``, a final RMS
norm and the head tied to the embedding, and the mean next-token cross
entropy.  Layer ``l`` mixes by attention where ``l % attn_layer_period ==
attn_layer_offset`` and by Mamba elsewhere; every MLP is dense SwiGLU
(``num_experts`` 1).

* attention: q from ``num_attention_heads`` heads, k and v from
  ``num_key_value_heads`` heads shared by their group, head size
  ``hidden_size / num_attention_heads``, no positional encoding, causal
  softmax at ``1 / sqrt(head size)``, then the output projection;
* Mamba (``JambaMambaMixer``): ``in_proj`` to x and the gate z
  (``expand x hidden`` each), a depthwise causal conv of width
  ``mamba_d_conv`` with its bias and SiLU on x, ``x_proj`` to Δ
  (``mamba_dt_rank``), B and C (``mamba_d_state`` each), Jamba's RMS norms
  of Δ, B and C, ``softplus(Δ dt_proj + dt_bias)``, the selective scan
  ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t h_t + D x_t``
  with ``A = -exp(A_log)``, the gate ``y silu(z)`` and ``out_proj``; no
  projection has a bias (``mamba_proj_bias`` false).

The scan runs in chunks of ``CHUNK`` steps with an associative scan
inside each chunk (``lax.associative_scan``'s odd-even recursion) and the
state carried across chunks, as the JAX package computes it; it is
written here.

Departures from the published model: the weights are drawn here, not
loaded (the configuration's ``assumed`` says how); Jamba's RMS norm
rounds to the input's dtype before its weight, here everything is
float32; the attention's dropout is absent (0 in the configuration).

To fit one card at the published sizes beside its float32 weights,
gradients and moments (12 bytes a parameter, 36.3 GB, plus 12.1 GB of
gradients), the loss is computed one row at a time with each layer, each
chunk of the scan, each block of 1024 attention queries and each chunk of
the logits recomputed in the backward pass; the rows' gradients add up in
place.

Weights are drawn here, on the device, from the seed: one draw per kind
of leaf for all layers that have it, in fp32, cast to the configuration's
dtype.  The benchmark hands the same tensors to the program.

``warm_step`` follows one step on from a state the program reached (its
weights and AdamW moments, which may live in host memory), the one way to
hold a step deep in the run against a reference without re-running every
step before it.

``precision="fp8"`` is the control: every matrix product with a weight
takes its operands rounded to float8 (e4m3 forward, e5m2 for the gradients
in the backward, each with one scale a tensor), as an fp8 training recipe
would; the rest stays float32.

This module imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.harness import traffic as gen
from portbench.references.rwkv6 import _matmul, _NoTf32, wsd

CHUNK = 256          # the scan's chunk
Q_BLOCK = 1024       # attention queries a recomputed block


def is_attention(cfg: dict, layer: int) -> bool:
    return layer % cfg["attn_layer_period"] == cfg["attn_layer_offset"]


def _dims(cfg: dict):
    d = cfg["hidden_size"]
    di = cfg["mamba_expand"] * d
    hd = d // cfg["num_attention_heads"]
    return d, di, hd


def _kinds(cfg: dict) -> List[Tuple[str, tuple, object, str]]:
    """Every kind of leaf: ``(name, shape, init, where)``: init is a
    constant, ``"normal"`` (N(0, initializer_range^2)), ``"a_log"``
    (log(1..N) in every channel) or ``"dt_bias"`` (Mamba's draw); where
    is ``"model"``, ``"layer"``, ``"mamba"`` or ``"attention"``."""
    d, di, hd = _dims(cfg)
    n, r, k = cfg["mamba_d_state"], cfg["mamba_dt_rank"], cfg["mamba_d_conv"]
    kv = cfg["num_key_value_heads"] * hd
    ff, vocab = cfg["intermediate_size"], cfg["vocab_size"]
    return [
        ("embed", (vocab, d), "normal", "model"),
        ("w1", (d, ff), "normal", "layer"),
        ("w3", (d, ff), "normal", "layer"),
        ("w2", (ff, d), "normal", "layer"),
        ("mamba.in_proj", (d, 2 * di), "normal", "mamba"),
        ("mamba.conv_w", (k, di), "normal", "mamba"),
        ("mamba.x_proj", (di, r + 2 * n), "normal", "mamba"),
        ("mamba.dt_proj", (r, di), "normal", "mamba"),
        ("mamba.out_proj", (di, d), "normal", "mamba"),
        ("mamba.dt_bias", (di,), "dt_bias", "mamba"),
        ("w_q", (d, d), "normal", "attention"),
        ("w_k", (d, kv), "normal", "attention"),
        ("w_v", (d, kv), "normal", "attention"),
        ("w_o", (d, d), "normal", "attention"),
        ("mamba.conv_b", (di,), 0.0, "mamba"),
        ("mamba.a_log", (di, n), "a_log", "mamba"),
        ("mamba.d_skip", (di,), 1.0, "mamba"),
        ("mamba.dt_norm", (r,), 1.0, "mamba"),
        ("mamba.b_norm", (n,), 1.0, "mamba"),
        ("mamba.c_norm", (n,), 1.0, "mamba"),
        ("pre_norm", (d,), 1.0, "layer"),
        ("ffn_norm", (d,), 1.0, "layer"),
        ("final_norm", (d,), 1.0, "model"),
    ]


def _layers(cfg: dict, where: str) -> List[int]:
    every = range(cfg["num_hidden_layers"])
    if where == "layer":
        return list(every)
    want = where == "attention"
    return [l for l in every if is_attention(cfg, l) == want]


def initial_groups(cfg: dict, seed: int,
                   device) -> Iterator[Tuple[List[str], torch.Tensor]]:
    """``(names, tensor)`` for every kind of leaf, one kind at a time:
    the program's names of the leaves of that kind and the leaves stacked
    ``[len(names), *shape]``."""
    dt = getattr(torch, cfg["dtype"])
    std = cfg["initializer_range"]
    for i, (name, shape, init, where) in enumerate(_kinds(cfg)):
        if where == "model":
            names = [name]
        else:
            names = [f"layers.{l}.{name}" for l in _layers(cfg, where)]
        full = (len(names),) + shape
        if init == "normal":
            x = gen.normal(full, seed, "weights", i, device, std=std, dtype=dt)
        elif init == "dt_bias":
            # Mamba's: Δ log-uniform in [1e-3, 1e-1], its inverse softplus
            g = gen.generator(seed, "weights", i, device)
            u = torch.rand(full, generator=g, device=device)
            step = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                             + math.log(1e-3)).clamp(min=1e-4)
            x = (step + torch.log(-torch.expm1(-step))).to(dt)
        elif init == "a_log":
            a = torch.log(torch.arange(1, shape[1] + 1, dtype=torch.float32,
                                       device=device))
            x = a.expand(full).to(dt).contiguous()
        else:
            x = torch.full(full, init, dtype=dt, device=device)
        yield names, x


def initial_weights(cfg: dict, seed: int, device) -> dict:
    """The initial weights as the program's Jamba tree: ``embed``,
    ``final_norm`` and ``layers``, a list of ``{key: tensor}`` with a Mamba
    layer's block under ``"mamba"``."""
    out: dict = {"layers": [{} for _ in range(cfg["num_hidden_layers"])]}
    for names, x in initial_groups(cfg, seed, device):
        for name, xl in zip(names, x.unbind(0), strict=True):
            parts = name.split(".")
            if parts[0] != "layers":
                out[name] = xl.clone()
                continue
            node = out["layers"][int(parts[1])]
            for key in parts[2:-1]:
                node = node.setdefault(key, {})
            node[parts[-1]] = xl.clone()
    return out


def flat(weights: dict) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` named as the program's ``named_parameters``."""
    out = {"embed": weights["embed"], "final_norm": weights["final_norm"]}
    for i, layer in enumerate(weights["layers"]):
        for key, x in layer.items():
            if isinstance(x, dict):
                for sub, y in x.items():
                    out[f"layers.{i}.{key}.{sub}"] = y
            else:
                out[f"layers.{i}.{key}"] = x
    return out


# --------------------------------------------------------------- model --
def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def associative_scan(decay, inc):
    """Inclusive scan along dim 1 of the pairs ``(decay, inc)`` under
    ``(d1, x1) then (d2, x2) = (d1 d2, x2 + d2 x1)``, by the odd-even
    recursion of ``lax.associative_scan``: neighbours combined in pairs,
    the pairs scanned, the even positions filled in from them.  Returns
    the states (the scanned ``inc``)."""
    steps = decay.shape[1]
    if steps == 1:
        return inc
    even = steps - steps % 2
    d2 = decay[:, :even].unflatten(1, (even // 2, 2))
    x2 = inc[:, :even].unflatten(1, (even // 2, 2))
    odd = associative_scan(d2[:, :, 0] * d2[:, :, 1],
                           x2[:, :, 1] + d2[:, :, 1] * x2[:, :, 0])
    before = torch.cat([torch.zeros_like(odd[:, :1]), odd[:, :-1]], 1)
    states = torch.stack([x2[:, :, 0] + d2[:, :, 0] * before, odd],
                         2).flatten(1, 2)
    if steps > even:
        states = torch.cat([states, inc[:, -1:] + decay[:, -1:]
                            * states[:, -1:]], 1)
    return states


def _scan_chunk(h, u, dt, a, b, c):
    """One chunk of the selective scan from state ``h [1, Di, N]``: y
    ``[1, C, Di]`` and the state after it."""
    decay = torch.exp(dt[..., None] * a)                     # [1,C,Di,N]
    inc = (dt * u)[..., None] * b[:, :, None, :]
    inc = torch.cat([inc[:, :1] + decay[:, :1] * h[:, None], inc[:, 1:]], 1)
    states = associative_scan(decay, inc)
    return torch.einsum("bcdn,bcn->bcd", states, c), states[:, -1]


def selective_scan(u, dt, a, b, c):
    """y ``[1, T, Di]`` from a zero state, ``CHUNK`` steps at a time, each
    chunk recomputed in the backward pass."""
    h = u.new_zeros((u.shape[0], u.shape[2], a.shape[1]))
    ys = []
    for c0 in range(0, u.shape[1], CHUNK):
        sl = slice(c0, c0 + CHUNK)
        y, h = checkpoint(_scan_chunk, h, u[:, sl], dt[:, sl], a, b[:, sl],
                          c[:, sl], use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, 1)


def _mamba(cfg, h, p, mm):
    eps, n, r = cfg["rms_norm_eps"], cfg["mamba_d_state"], cfg["mamba_dt_rank"]
    xi, z = mm(h, p["in_proj"]).chunk(2, -1)
    k, t = cfg["mamba_d_conv"], h.shape[1]
    conv = F.conv1d(xi.transpose(1, 2), p["conv_w"].t()[:, None, :],
                    p["conv_b"], padding=k - 1, groups=xi.shape[-1])
    xi = F.silu(conv[..., :t].transpose(1, 2))
    delta, b, c = mm(xi, p["x_proj"]).split([r, n, n], -1)
    delta = rms_norm(delta, p["dt_norm"], eps)
    b, c = rms_norm(b, p["b_norm"], eps), rms_norm(c, p["c_norm"], eps)
    dt = F.softplus(mm(delta, p["dt_proj"]) + p["dt_bias"])
    y = selective_scan(xi, dt, -torch.exp(p["a_log"]), b, c)
    y = (y + xi * p["d_skip"]) * F.silu(z)
    return mm(y, p["out_proj"])


def _attend(q, k, v, q0):
    """Softmax attention of the queries at ``q0 ..`` over the keys before
    them and at them: q ``[1, Tq, H, D]``, k, v ``[1, S, H, D]``."""
    tq, s = q.shape[1], k.shape[1]
    logits = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(q.shape[-1])
    seen = (q0 + torch.arange(tq, device=q.device)[:, None]
            >= torch.arange(s, device=q.device)[None, :])
    probs = torch.softmax(logits.masked_fill(~seen, -math.inf), -1)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _attention(cfg, h, p, mm):
    bsz, t, d = h.shape
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // heads
    q = mm(h, p["w_q"]).reshape(bsz, t, heads, hd)
    k = mm(h, p["w_k"]).reshape(bsz, t, kv, hd)
    v = mm(h, p["w_v"]).reshape(bsz, t, kv, hd)
    k, v = (x.repeat_interleave(heads // kv, dim=2) for x in (k, v))
    out = [checkpoint(_attend, q[:, q0:q0 + Q_BLOCK], k[:, :q0 + Q_BLOCK],
                      v[:, :q0 + Q_BLOCK], q0, use_reentrant=False)
           for q0 in range(0, t, Q_BLOCK)]
    return mm(torch.cat(out, 1).reshape(bsz, t, d), p["w_o"])


def _layer(x, p, cfg, attention, mm):
    eps = cfg["rms_norm_eps"]
    h = rms_norm(x, p["pre_norm"], eps)
    x = x + (_attention if attention else _mamba)(cfg, h, p, mm)
    h = rms_norm(x, p["ffn_norm"], eps)
    return x + mm(F.silu(mm(h, p["w1"])) * mm(h, p["w3"]), p["w2"])


def row_loss(params: Dict[str, torch.Tensor], cfg: dict, tokens, targets,
             *, precision: str = "float32", seq_chunk: int = 512):
    """Mean next-token cross entropy of one row (``tokens``, ``targets``
    ``[1, T]``); each layer and each chunk of the logits is recomputed in
    the backward pass."""
    mm = _matmul(precision)
    x = params["embed"][tokens]
    for l in range(cfg["num_hidden_layers"]):
        prefix = f"layers.{l}."
        p = {k[len(prefix):].removeprefix("mamba."): v
             for k, v in params.items() if k.startswith(prefix)}
        x = checkpoint(_layer, x, p, cfg, is_attention(cfg, l), mm,
                       use_reentrant=False)
    x = rms_norm(x, params["final_norm"], cfg["rms_norm_eps"])

    def piece(hx, tx):
        lg = mm(hx, params["embed"].t())
        return (torch.logsumexp(lg, -1)
                - lg.gather(-1, tx[..., None])[..., 0]).sum()

    t = x.shape[1]
    total = sum(checkpoint(piece, x[:, c0:c0 + seq_chunk],
                           targets[:, c0:c0 + seq_chunk], use_reentrant=False)
                for c0 in range(0, t, seq_chunk))
    return total / targets.numel()


# -------------------------------------------------------------- AdamW --
class _Adamw:
    """The configuration's AdamW over float32 leaves, one leaf at a time:
    each update returns the new weight (rounded through the stored dtype)
    and moments, and changes nothing it is given."""

    def __init__(self, cfg: dict):
        tc, adam = cfg["train"], cfg["adamw"]
        self.tc = tc
        self.b1, self.b2, self.eps = adam["b1"], adam["b2"], adam["eps"]
        self.wd = tc["weight_decay"]
        self.store = getattr(torch, cfg["dtype"])

    def gradients(self, params: dict, cfg: dict, batch: dict,
                  precision: str) -> float:
        """The batch's mean loss; the clipped gradients are left in each
        leaf's ``.grad``, summed over the rows one row at a time."""
        for p in params.values():
            p.grad = None
        rows = batch["tokens"].shape[0]
        loss = 0.0
        for i in range(rows):
            part = row_loss(params, cfg, batch["tokens"][i:i + 1],
                            batch["targets"][i:i + 1], precision=precision,
                            seq_chunk=self.tc["seq_chunk"]) / rows
            part.backward()
            loss += float(part.detach())
        grads = [p.grad for p in params.values()]
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
        scale = torch.clamp(self.tc["clip_norm"] / (gnorm + 1e-9), max=1.0)
        for g in grads:
            g.mul_(scale)
        return loss

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


def _leaves(named: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device=device, dtype=torch.float32, copy=True)
            .requires_grad_(True) for k, v in named.items()}


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
        params = _leaves(start, device)
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
        losses, first = [], {}
        for step in range(steps):
            losses.append(opt.gradients(params, cfg, batches(step), precision))
            with torch.no_grad():
                for name, p in params.items():
                    g = p.grad
                    if step == 0:
                        first[name] = float(g.norm())
                    new, mu[name], nu[name] = opt.update(p, g, mu[name],
                                                         nu[name], step)
                    p.copy_(new)
                    p.grad = None
        change = {k: float((params[k].detach() - start[k].float()).norm())
                  for k in params}
        return {"losses": losses, "grad_norms": first, "change_norms": change}


def warm_step(cfg: dict, before: dict, batch: dict, *,
              precision: str = "float32") -> dict:
    """One step from a state the program reached, in float32: ``before``
    holds its weights (``params``), AdamW moments (``mu``, ``nu``), by the
    program's leaf names, on any device, and the 0-based ``step``; it is
    read, never changed.  The step's loss, each leaf's norm of the clipped
    gradient and of its change."""
    opt = _Adamw(cfg)
    step = before["step"]
    device = batch["tokens"].device
    with _NoTf32():
        params = _leaves(before["params"], device)
        loss = opt.gradients(params, cfg, batch, precision)
        grad, change = {}, {}
        with torch.no_grad():
            for name, p in params.items():
                g = p.grad
                grad[name] = float(g.norm())
                new, _, _ = opt.update(
                    p, g, before["mu"][name].to(device, torch.float32),
                    before["nu"][name].to(device, torch.float32), step)
                change[name] = float((new - p).norm())
                p.grad = None
        return {"losses": [loss], "grad_norms": grad, "change_norms": change}
