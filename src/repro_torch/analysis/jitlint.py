"""Device-stream lint: AST rules for hazards on the card's hot paths.

Port of ``repro/analysis/jitlint.py`` with its rules retargeted from
``jax.jit`` to torch on CUDA.  The port's serve and MPC loops are fast
because they queue kernels on the current stream and let the host run
ahead; the hazards that silently break that leave no test failure, just
stalls: a device→host copy that waits for the stream to drain, and a
fresh allocation shape every iteration, which churns the caching
allocator and cannot be captured in a CUDA graph.  Each rule flags the
*pattern*; intentional sites carry ``# analysis: allow(<rule>): reason``
(:mod:`.report`), so the port needs no baseline file.

Rules
-----
``host-sync``        ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
                     ``torch.cuda.synchronize()``, ``np.asarray`` /
                     ``np.array``: each waits for the stream (or copies a
                     device tensor to the host) before the host goes on.
``shape-loop``       torch constructors (``torch.zeros``/``ones``/
                     ``full``/``empty``/``arange``/…) whose shape depends
                     on the loop variable: a new block size every
                     iteration for the caching allocator, and a shape no
                     CUDA graph can replay.  A call that fills ``out=``
                     allocates nothing and is not flagged.
``no-bare-assert``   bare ``assert`` in ``src/``: stripped under
                     ``python -O``; raise a structured exception from
                     :mod:`repro_torch.mpc.errors` instead.

Left out on purpose: the reference's ``static-argnums`` and
``donated-reuse`` police ``jax.jit``'s positional static indices and
donated buffers, which have no torch meaning (a torch call has neither),
and its ``traced-branch`` tests parameters of jit-compiled functions, of
which the port has none.  The port never calls ``torch.compile``, so a
graph-break rule would lint nothing.
"""
from __future__ import annotations

import ast
import os
from typing import Iterable, List, Optional, Sequence, Set

from .report import Finding, is_suppressed, read_source

RULES = ("host-sync", "shape-loop", "no-bare-assert")

#: tensor methods that copy to the host or wait for the stream
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_NP_SYNC_FUNCS = {"asarray", "array"}
_ALLOC_FUNCS = {"zeros", "ones", "full", "empty", "arange", "eye",
                "linspace", "rand", "randn", "randint", "empty_strided"}


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` as a string, or None for non-name chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class _FileLint(ast.NodeVisitor):
    def __init__(self, path: str, lines: Sequence[str],
                 rules: Sequence[str]):
        self.path = path
        self.lines = lines
        self.rules = set(rules)
        self.findings: List[Finding] = []
        self._loop_vars: List[Set[str]] = []

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        if rule not in self.rules:
            return
        line = getattr(node, "lineno", 1)
        if is_suppressed(rule, self.lines, line):
            return
        snippet = self.lines[line - 1] if line <= len(self.lines) else ""
        self.findings.append(Finding(rule=rule, file=self.path, line=line,
                                     message=message,
                                     snippet=snippet.strip()))

    # --------------------------------------------------------------- calls
    def visit_Call(self, node: ast.Call) -> None:
        fn = _dotted(node.func)
        method = (node.func.attr if isinstance(node.func, ast.Attribute)
                  else None)
        bare = not node.args and not node.keywords
        if fn is not None and fn.rpartition(".")[0] in ("np", "numpy") \
                and fn.rpartition(".")[2] in _NP_SYNC_FUNCS:
            self._emit("host-sync", node,
                       f"{fn}(...) materializes its operand on the host "
                       f"(a device tensor waits for the stream)")
        elif fn == "torch.cuda.synchronize":
            self._emit("host-sync", node,
                       "torch.cuda.synchronize() stalls the host until "
                       "the card drains")
        elif method in _SYNC_METHODS and bare:
            self._emit("host-sync", node,
                       f".{method}() copies a tensor to the host and "
                       f"waits for the stream")
        fills = any(kw.arg == "out" for kw in node.keywords)
        if (self._loop_vars and fn is not None and not fills
                and fn.rpartition(".")[0] == "torch"
                and fn.rpartition(".")[2] in _ALLOC_FUNCS):
            live = set().union(*self._loop_vars)
            used: Set[str] = set()
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                used |= _names_in(arg)
            hits = sorted(live & used)
            if hits:
                self._emit("shape-loop", node,
                           f"allocation shape depends on loop "
                           f"variable(s) {hits}: a new block size each "
                           f"iteration, and no CUDA graph can replay it")
        self.generic_visit(node)

    # --------------------------------------------------------------- loops
    def visit_For(self, node: ast.For) -> None:
        self._loop_vars.append(_names_in(node.target))
        self.generic_visit(node)
        self._loop_vars.pop()

    def visit_While(self, node: ast.While) -> None:
        self._loop_vars.append(set())
        self.generic_visit(node)
        self._loop_vars.pop()

    # --------------------------------------------------------------- misc
    def visit_Assert(self, node: ast.Assert) -> None:
        self._emit("no-bare-assert", node,
                   "bare assert is stripped under python -O; raise a "
                   "structured exception (repro_torch.mpc.errors)")
        self.generic_visit(node)


def lint_file(path: str, rules: Sequence[str] = RULES) -> List[Finding]:
    """All unsuppressed findings for one file (empty for non-Python or
    unparsable files)."""
    src = read_source(path)
    if src is None:
        return []
    text, lines = src
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return []
    lint = _FileLint(path, lines, rules)
    lint.visit(tree)
    lint.findings.sort(key=lambda f: (f.line, f.rule))
    return lint.findings


def lint_paths(paths: Sequence[str],
               rules: Sequence[str] = RULES) -> List[Finding]:
    findings: List[Finding] = []
    for root in paths:
        if os.path.isfile(root):
            files: Iterable[str] = [root]
        else:
            files = sorted(
                os.path.join(dp, f)
                for dp, _, fs in os.walk(root) for f in fs
                if f.endswith(".py"))
        for f in files:
            findings.extend(lint_file(f, rules))
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings
