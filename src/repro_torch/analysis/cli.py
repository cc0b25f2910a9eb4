"""``python -m repro_torch.analysis``: run the port's static suite, exit 1
on any finding.

With no layer flag both layers run: the AST lint over ``src/repro_torch/``
and the kernel contract checker. ``--json`` prints the findings as JSON.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

from repro_torch.analysis.findings import Finding, render, to_json


def run_suite(*, lint: bool = True, contracts: bool = True) -> List[Finding]:
    findings: List[Finding] = []
    if lint:
        from repro_torch.analysis.lint import run_repo_lint
        findings += run_repo_lint()
    if contracts:
        from repro_torch.analysis.kernel_contracts import (
            run_kernel_contracts)
        findings += run_kernel_contracts()
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static suite: AST lint and kernel "
                    "contracts")
    ap.add_argument("--lint", action="store_true",
                    help="AST lint rules over src/repro_torch/")
    ap.add_argument("--contracts", action="store_true",
                    help="CUDA kernel contract checker")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON instead of text")
    args = ap.parse_args(argv)
    both = not (args.lint or args.contracts)
    findings = run_suite(lint=args.lint or both,
                         contracts=args.contracts or both)
    print(to_json(findings) if args.json else render(findings))
    return 1 if findings else 0
