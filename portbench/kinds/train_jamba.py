"""Training steps of a Jamba hybrid on fresh token batches through the
program's train step.

The ``train`` kind's procedure (``kinds/train.py``: set-up drives the
first ``check_steps`` steps, the window, one warm step after it, then the
plain reference over both), for a Jamba model built from the
configuration's Hugging Face keys through ``make_train_step``; its
numbers are compared as there (:func:`compare`, :func:`compare_warm`,
:func:`checks`).  Two differences: the warm step's saved state (bf16
weights and fp32 moments) is kept in host memory, since beside the
program's it does not fit on one card; and a ``--trace 1`` run traces
with the program's spans on (``harness/spans.traced``), so the per-layer
metrics can read device time by span (``LayerContext.spans``).

Traffic parameters (``"kind": "train_jamba"``): those of ``train``.
Configuration keys: the model's (``num_hidden_layers``, ``hidden_size``,
``num_attention_heads``, ``num_key_value_heads``, ``intermediate_size``,
``vocab_size``, ``attn_layer_period``, ``attn_layer_offset``,
``mamba_d_state``, ``mamba_d_conv``, ``mamba_expand``, ``mamba_dt_rank``,
``rms_norm_eps``, ``tie_word_embeddings``, and the forms the program
takes: ``num_experts`` 1, ``hidden_act`` silu, ``mamba_conv_bias`` true,
``mamba_proj_bias`` false), ``dtype``, ``remat``, ``train``, ``adamw`` and
``limits``.
"""
from __future__ import annotations

import sys
import time

import torch

from portbench.harness import device as hw
from portbench.harness import spans as span_trace
from portbench.harness import traffic as gen
from portbench.harness.outcome import LayerContext, Outcome, Run
from portbench.kinds.train import (
    Trainer as _Trainer,
    checks,
    compare,
    compare_warm,
    report_unmoved,
)

__all__ = ["Trainer", "checks", "compare", "compare_warm", "model_config",
           "run"]


def model_config(cfg: dict):
    """The program's ``JambaConfig`` for the configuration's keys; raises
    where the configuration asks for a form the program does not build (or
    the program has no published Jamba)."""
    from repro_torch.models.jamba import JambaConfig
    from repro_torch.models.ssm import MambaConfig

    forms = {"num_experts": 1, "hidden_act": "silu", "mamba_conv_bias": True,
             "mamba_proj_bias": False}
    wrong = {k: cfg[k] for k, v in forms.items() if cfg[k] != v}
    if wrong:
        raise ValueError(f"the program builds Jamba with {forms}; the "
                         f"configuration states {wrong}")
    return JambaConfig(
        name=cfg["name"], family="hybrid", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], attn_every=cfg["attn_layer_period"],
        attn_offset=cfg["attn_layer_offset"], attn_rope=False,
        ssm=MambaConfig(d_state=cfg["mamba_d_state"],
                        d_conv=cfg["mamba_d_conv"], expand=cfg["mamba_expand"],
                        dt_rank=cfg["mamba_dt_rank"]),
        norm_eps=cfg["rms_norm_eps"], dtype=cfg["dtype"], remat=cfg["remat"],
        tie_embeddings=cfg["tie_word_embeddings"], subquadratic=True)


def _program(mc, cfg: dict, weights: dict):
    from repro_torch.models import jamba
    from repro_torch.train.step import (
        TrainConfig,
        make_optimizer,
        make_train_step,
    )

    tc = TrainConfig(**cfg["train"])
    opt = make_optimizer(tc)
    for key, value in cfg["adamw"].items():
        if getattr(opt, key) != value:
            raise ValueError(f"the program's AdamW has {key} = "
                             f"{getattr(opt, key)}; the configuration states "
                             f"{value}")
    params = jamba.build(mc, weights)
    params.requires_grad_(True)
    return params, opt.init(params), make_train_step(mc, tc)


class Trainer(_Trainer):
    """The ``train`` kind's trainer over the program's Jamba."""

    def __init__(self, cell, seed: int, device):
        cfg, tr = cell.config, cell.traffic
        mc = model_config(cfg)           # refuse before drawing anything
        self.cell, self.seed, self.device = cell, seed, device
        self.ref = cell.reference()
        self.data = gen.SyntheticTokens(vocab=cfg["vocab_size"],
                                        seq_len=tr["seq_len"],
                                        global_batch=tr["global_batch"],
                                        seed=seed)
        self.params, self.opt, self.step_fn = _program(
            mc, cfg, self.ref.initial_weights(cfg, seed, device))
        self.before = None

    def first_steps(self) -> dict:
        """As the ``train`` kind's, each leaf's change read against the
        reference's draws by the program's names."""
        cfg = self.cell.config
        b1 = cfg["adamw"]["b1"]
        losses, first = [], {}
        for i in range(self.cell.traffic["check_steps"]):
            losses.append(self.step(i))
            if i == 0:
                first = {n: float(m.norm()) / (1 - b1)
                         for n, m in self.opt.mu.items()}
        named = dict(self.params.named_parameters())
        change = {}
        with torch.no_grad():
            for names, x in self.ref.initial_groups(cfg, self.seed,
                                                    self.device):
                for name, x0 in zip(names, x.unbind(0), strict=True):
                    change[name] = float(
                        (named[name].float() - x0.float()).norm())
        return {"losses": losses, "grad_norms": first, "change_norms": change}

    def warm_step(self, i: int) -> dict:
        """As the ``train`` kind's, with the state before the step kept in
        host memory."""
        b1 = self.cell.config["adamw"]["b1"]
        host = torch.device("cpu")
        with torch.no_grad():
            self.before = {
                "params": {n: p.detach().to(host, copy=True)
                           for n, p in self.params.named_parameters()},
                "mu": {n: m.to(host, copy=True) for n, m in self.opt.mu.items()},
                "nu": {n: v.to(host, copy=True) for n, v in self.opt.nu.items()},
                "step": i}
        loss = self.step(i)
        old = self.before
        with torch.no_grad():
            grad = {n: float((m.float() - b1 * old["mu"][n].to(m.device)
                              .float()).norm()) / (1 - b1)
                    for n, m in self.opt.mu.items()}
            change = {n: float((p.float() - old["params"][n].to(p.device)
                                .float()).norm())
                      for n, p in self.params.named_parameters()}
        return {"losses": [loss], "grad_norms": grad, "change_norms": change}


def run(cell, run: Run) -> Outcome:
    tr = cell.traffic
    rows, seq = tr["global_batch"], tr["seq_len"]
    marks = [("imports", time.perf_counter())]
    trainer = Trainer(cell, run.seed, run.device)
    marks.append(("weights and program", time.perf_counter()))
    prog = trainer.first_steps()
    marks.append(("checked steps", time.perf_counter()))

    from repro_torch.kernels import launch_counts

    n0 = tr["check_steps"]
    hw.settle()
    t_window = time.perf_counter()
    setup_s = t_window - run.t_start
    hw.report_setup(run.t_start, marks + [("settle", t_window)])
    i = n0
    with span_trace.traced(run.trace) as rec:
        before = launch_counts()
        t0 = time.perf_counter()
        for _ in range(tr["trace_steps"] if run.trace else 0):
            trainer.step(i)
            i += 1
        traced_s = time.perf_counter() - t0
        after = launch_counts()
    t_rest = time.perf_counter()
    ends = []
    while time.perf_counter() - t_window < run.seconds:
        trainer.step(i)
        i += 1
        ends.append(time.perf_counter())
    t_end = time.perf_counter()
    starts = ([t_rest] + ends)[:len(ends)]     # no step may follow a trace
    hw.report_times("step", [b - a for a, b in zip(starts, ends, strict=True)])
    window_s = t_end - t_window
    steps = i - n0
    device = hw.describe(run.device, cell.chips)
    warm = trainer.warm_step(i)
    layers = None
    if run.trace:
        traced_n = tr["trace_steps"]
        layers = LayerContext(
            config=cell.config, traffic=tr, items=traced_n, window_s=traced_s,
            trace=rec.trace, rest_items=steps - traced_n, rest_s=t_end - t_rest,
            counters={"launches": {n: after[n] - before[n] for n in after},
                      "shape": (rows, seq)})
        layers.spans = span_trace.attribution(rec)
    trainer.free()
    t_ref = time.perf_counter()
    want_warm = trainer.warm_reference()
    trainer.drop_before()
    want = trainer.reference()
    print(f"portbench: the reference took {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    report_unmoved("first steps", prog, want)
    report_unmoved(f"warm step {i}", warm, want_warm)
    got = {**compare(prog, want), **compare_warm(warm, want_warm)}
    e2e = {"train_tokens_per_s": steps * rows * seq / window_s,
           "setup_s": setup_s}
    return Outcome(attempted=steps, failed=0, end_to_end=e2e,
                   checks=checks(cell, got), device=device, layers=layers)
