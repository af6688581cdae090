"""Training steps on fresh token batches through the program's train step.

Set-up builds one training step with its model and optimizer state from
weights the reference draws from the seed, and drives it through its
first ``check_steps`` steps with the window's own call and feed; the same
objects then run the window.  The first steps' readings (each loss, each
leaf's first gradient as AdamW got it, read back from its first moment,
and each leaf's change over the steps) are held against the plain
reference once the window has closed.  So is one warm step: once the
window has closed (and the memory peak is read), the same objects run the
step the window would have run next, on the state the window left, and
its readings (the loss, each leaf's gradient as AdamW got it, from its
first moment before and after, and each leaf's change) are held against
the reference's step from the same state, so that a step that goes wrong
only once the run is warm cannot pass.

Traffic parameters (``"kind": "train"``): ``global_batch``, ``seq_len``,
``check_steps``, ``trace_steps`` (the steps at the window's start that a
``--trace 1`` run profiles).  Configuration keys: the model's sizes
(``n_layers``, ``d_model``, ``d_ff``, ``vocab``, ``dtype``, ``norm_eps``,
``remat``), ``train`` (the program's ``TrainConfig``), ``adamw`` (the
optimizer's constants, checked against the program's) and ``limits``.
"""
from __future__ import annotations

import gc
import statistics
import sys
import time

import torch

from portbench.harness import device as hw
from portbench.harness import traffic as gen
from portbench.harness.outcome import Check, LayerContext, Outcome, Run
from portbench.harness.trace import traced

# a leaf whose reference gradient is below this share of the median leaf's
# moves under AdamW by round-off alone: it is left out of the change
STILL_LEAF = 1e-3


def _program(cfg: dict, weights: dict):
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.rwkv import RWKV, Layer
    from repro_torch.train.step import TrainConfig, make_optimizer, make_train_step

    mc = ModelConfig(name=cfg["name"], family="ssm", n_layers=cfg["n_layers"],
                     d_model=cfg["d_model"], n_heads=0, n_kv_heads=0,
                     d_ff=cfg["d_ff"], vocab=cfg["vocab"], dtype=cfg["dtype"],
                     remat=cfg["remat"], norm_eps=cfg["norm_eps"],
                     subquadratic=True)
    tc = TrainConfig(**cfg["train"])
    opt = make_optimizer(tc)
    for key, value in cfg["adamw"].items():
        if getattr(opt, key) != value:
            raise ValueError(f"the program's AdamW has {key} = "
                             f"{getattr(opt, key)}; the configuration states "
                             f"{value}")
    params = RWKV(weights["embed"], [Layer(lw) for lw in weights["layers"]],
                  weights["final_norm"], weights["lm_head"])
    params.requires_grad_(True)
    return params, opt.init(params), make_train_step(mc, tc)


def _gaps(got: dict, want: dict, names) -> list:
    """Each leaf's gap between two norms, against the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    names = list(names)
    med = statistics.median(want[n] for n in names)
    return [abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in names]


def compare(prog: dict, ref: dict) -> dict:
    """The numbers a run can compare: the worst step's loss gap, relative
    to the reference's loss; the worst leaf's gap in the first gradient's
    norm, and the median leaf's; the worst leaf's gap in the change's norm
    (leaves with a still reference gradient left out), and the median gap
    over the leaves the reference changed (bf16 storage leaves some
    unmoved on both sides).
    The configuration's ``limits`` say which are compared."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in
                   zip(prog["losses"], ref["losses"], strict=True))
    g, c = ref["grad_norms"], ref["change_norms"]
    med = statistics.median(g.values())
    moving = [n for n in g if g[n] >= STILL_LEAF * med]
    changed = [n for n in moving if c[n] > 0]
    grad = _gaps(prog["grad_norms"], g, g)
    return {"loss_gap": loss_gap,
            "grad_gap": max(grad),
            "grad_gap_median": statistics.median(grad),
            "change_gap": max(_gaps(prog["change_norms"], c, moving)),
            "change_gap_median": statistics.median(
                _gaps(prog["change_norms"], c, changed))}


class Trainer:
    """The program's training step, its weights (drawn by the reference
    from the seed) and optimizer state, and the feed: one object from
    set-up to the window's end."""

    def __init__(self, cell, seed: int, device):
        cfg, tr = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        self.ref = cell.reference()
        self.data = gen.SyntheticTokens(vocab=cfg["vocab"],
                                        seq_len=tr["seq_len"],
                                        global_batch=tr["global_batch"],
                                        seed=seed)
        self.params, self.opt, self.step_fn = _program(
            cfg, self.ref.initial_weights(cfg, seed, device))
        self.before = None

    def batch(self, i: int) -> dict:
        return self.data.batch(i, self.device)

    def step(self, i: int) -> float:
        self.params, self.opt, metrics = self.step_fn(self.params, self.opt,
                                                      self.batch(i))
        return float(metrics["loss"])      # the step ends at the loss's sync

    def first_steps(self) -> dict:
        """Steps ``0 .. check_steps - 1`` through the window's own call and
        feed, and their readings: each loss, each leaf's first gradient as
        AdamW got it (its first moment over ``1 - b1``), each leaf's change
        from the seed's weights."""
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
            for kind, per_layer, x in self.ref.initial_groups(cfg, self.seed,
                                                              self.device):
                for li, x0 in enumerate(x.unbind(0) if per_layer else [x]):
                    name = f"layers.{li}.{kind}" if per_layer else kind
                    change[name] = float(
                        (named[name].float() - x0.float()).norm())
        return {"losses": losses, "grad_norms": first, "change_norms": change}

    def warm_step(self, i: int) -> dict:
        """Step ``i`` through the window's own call and feed, on the state
        the steps before it left, and its readings: the loss, each leaf's
        gradient as AdamW got it (from its first moment before and after the
        step), each leaf's change.  The state before the step is kept for
        the reference (``before``)."""
        b1 = self.cell.config["adamw"]["b1"]
        with torch.no_grad():
            self.before = {
                "params": {n: p.detach().clone()
                           for n, p in self.params.named_parameters()},
                "mu": {n: m.clone() for n, m in self.opt.mu.items()},
                "nu": {n: v.clone() for n, v in self.opt.nu.items()},
                "step": i}
        loss = self.step(i)
        old = self.before
        with torch.no_grad():
            grad = {n: float((m.float() - b1 * old["mu"][n].float()).norm())
                    / (1 - b1) for n, m in self.opt.mu.items()}
            change = {n: float((p.float() - old["params"][n].float()).norm())
                      for n, p in self.params.named_parameters()}
        return {"losses": [loss], "grad_norms": grad, "change_norms": change}

    def free(self) -> None:
        """Drop the program's state (the warm step's ``before`` stays for
        the reference until :meth:`drop_before`)."""
        del self.params, self.opt, self.step_fn
        self._empty()

    def drop_before(self) -> None:
        self.before = None
        self._empty()

    def _empty(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def warm_reference(self, *, precision: str = "float32", rows=None) -> dict:
        """The plain reference's readings over the warm step, from the state
        the program had before it (``rows``: a slice of the batch)."""
        b = self.batch(self.before["step"])
        if rows is not None:
            b = {k: v[rows] for k, v in b.items()}
        return self.ref.warm_step(self.cell.config, self.before, b,
                                  precision=precision)

    def reference(self, *, precision: str = "float32", rows=None) -> dict:
        """The plain reference's readings over the same first steps
        (``rows``, a slice of each batch, plants the half-batch fault)."""
        def batches(s):
            b = self.batch(s)
            return b if rows is None else {k: v[rows] for k, v in b.items()}

        return self.ref.train(self.cell.config, self.seed, self.device,
                              batches, steps=self.cell.traffic["check_steps"],
                              precision=precision)


def compare_warm(prog: dict, ref: dict) -> dict:
    """:func:`compare` over the warm step, each name prefixed ``warm_``."""
    return {f"warm_{k}": v for k, v in compare(prog, ref).items()}


def checks(cell, got: dict) -> list:
    """The numbers the configuration's ``limits`` name, each beside its
    limit (``got``: :func:`compare` and :func:`compare_warm` merged)."""
    return [Check(name, got[name], limit)
            for name, limit in cell.config["limits"].items()]


def report_unmoved(what: str, prog: dict, want: dict) -> None:
    unmoved = [n for n, c in prog["change_norms"].items()
               if c == 0 and want["change_norms"][n] > 0]
    if unmoved:
        print(f"portbench: {what}: {len(unmoved)} leaves the reference "
              f"moves are unmoved, first {unmoved[:3]}", file=sys.stderr)


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
    with traced(run.trace) as rec:
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
    hw.report_times("step", [b - a for a, b in zip([t_rest] + ends[:-1],
                                                  ends, strict=True)])
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
