"""Structured findings and suppressions of the port's static suite (a copy
of ``repro.analysis.findings``; the port keeps its own).

Every layer of :mod:`repro_torch.analysis` (the AST lint and the kernel
contract checker) reports the same record: a repo-relative ``file:line``,
a stable rule id and a one-line message. Suppression is per line and per
rule::

    x = float(m["lr"])  # repro: ignore[host-sync]
    x = foo()           # repro: ignore[host-sync,rng-implicit]

A suppression comment silences ONLY the named rules on that physical line:
there is no file- or block-level escape hatch, so every accepted violation
stays visible at the line that carries it.
"""
from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass
from typing import Dict, Iterable, List, Set

_SUPPRESS_RE = re.compile(r"#\s*repro:\s*ignore\[([\w\-,\s]+)\]")


@dataclass(frozen=True)
class Finding:
    path: str        # repo-relative file
    line: int        # 1-based; 0 when the finding is file-scoped
    rule: str        # stable rule id, e.g. "host-sync"
    message: str

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.message}"


def suppressions(source: str) -> Dict[int, Set[str]]:
    """Map 1-based line number -> set of rule ids suppressed on that line."""
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def filter_suppressed(findings: Iterable[Finding],
                      source_by_path: Dict[str, str]) -> List[Finding]:
    """Drop findings whose line carries a matching suppression comment."""
    out: List[Finding] = []
    for f in findings:
        src = source_by_path.get(f.path)
        if src is not None and f.rule in suppressions(src).get(f.line, ()):
            continue
        out.append(f)
    return out


def render(findings: Iterable[Finding]) -> str:
    fs = sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    if not fs:
        return "clean: 0 findings"
    lines = [f.format() for f in fs]
    lines.append(f"{len(fs)} finding(s)")
    return "\n".join(lines)


def to_json(findings: Iterable[Finding]) -> str:
    return json.dumps([asdict(f) for f in findings], indent=2,
                      sort_keys=True)
