"""Findings, suppressions and the committed baseline (DESIGN.md §12).

A **finding** is one (rule, file, line, message) the analyzers produced.
Two escape hatches keep the CI gate adoptable without a flag day:

* an inline ``# analysis: allow(<rule>)`` comment — on the offending line
  or the line directly above — suppresses a site permanently, with an
  optional reason after a colon (``# analysis: allow(host-sync): token
  feedback needs the host``).  Suppressed sites never reach the report.
* ``analysis-baseline.json`` — the audited legacy debt.  Baseline entries
  are **fingerprints** (rule + file + normalized line text, hashed) with
  duplicate counts, so pure line-number drift does not resurrect them;
  editing a baselined line invalidates its fingerprint and the finding
  comes back.  ``--write-baseline`` regenerates the file; the CI gate
  fails only on findings *not* covered by it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

_ALLOW_RE = re.compile(r"#\s*analysis:\s*allow\(([\w*,\s-]+)\)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer hit, anchored to a source line."""

    rule: str
    file: str
    line: int                     # 1-indexed
    message: str
    snippet: str = ""             # the stripped source line (fingerprint key)

    def fingerprint(self) -> str:
        """Line-number-free identity: rule + file + normalized line text.

        Whitespace runs collapse so re-indenting a line does not churn the
        baseline; any semantic edit to the line changes the hash.
        """
        norm = " ".join(self.snippet.split())
        raw = f"{self.rule}|{self.file}|{norm}".encode()
        return hashlib.sha256(raw).hexdigest()[:16]

    def render(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"


def allowed_rules(lines: Sequence[str], lineno: int) -> frozenset:
    """Rules suppressed at 1-indexed ``lineno`` (same line or line above).

    ``allow(*)`` suppresses every rule at the site.
    """
    rules: set = set()
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines):
            m = _ALLOW_RE.search(lines[ln - 1])
            if m:
                rules.update(r.strip() for r in m.group(1).split(","))
    return frozenset(rules)


def is_suppressed(rule: str, lines: Sequence[str], lineno: int) -> bool:
    allowed = allowed_rules(lines, lineno)
    return "*" in allowed or rule in allowed


# ------------------------------------------------------------------ baseline
def _counts(findings: Sequence[Finding]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for f in findings:
        fp = f.fingerprint()
        out[fp] = out.get(fp, 0) + 1
    return out


def load_baseline(path: str) -> Dict[str, int]:
    """``{fingerprint: count}`` from a baseline file (empty when absent)."""
    try:
        with open(path) as fh:
            data = json.load(fh)
    except OSError:
        return {}
    if not isinstance(data, dict):
        raise ValueError(f"baseline {path!r} must be a JSON object")
    fps = data.get("fingerprints", {})
    return {str(k): int(v) for k, v in fps.items()}


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    """Persist the current findings as the accepted debt (sorted, stable)."""
    counts = _counts(findings)
    doc = {
        "comment": "audited legacy findings; regenerate with "
                   "`python -m repro.analysis --write-baseline`",
        "version": 1,
        "total": sum(counts.values()),
        "fingerprints": {k: counts[k] for k in sorted(counts)},
    }
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=False)
        fh.write("\n")


def diff_baseline(findings: Sequence[Finding],
                  baseline: Dict[str, int]) -> List[Finding]:
    """Findings NOT covered by the baseline (per-fingerprint counts).

    A fingerprint appearing ``k`` times with baseline budget ``b`` leaks
    ``max(0, k − b)`` findings — duplicates beyond the audited count are
    new debt and fail the gate.
    """
    budget = dict(baseline)
    fresh: List[Finding] = []
    for f in findings:
        fp = f.fingerprint()
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
        else:
            fresh.append(f)
    return fresh


def summarize(findings: Sequence[Finding]) -> str:
    by_rule: Dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    parts = [f"{r}={n}" for r, n in sorted(by_rule.items())]
    return ", ".join(parts) if parts else "none"


def read_source(path: str) -> Optional[Tuple[str, List[str]]]:
    """(text, lines) of a source file, or None when unreadable."""
    try:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
    except (OSError, UnicodeDecodeError):
        return None
    return text, text.split("\n")
