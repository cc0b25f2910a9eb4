"""The port's static suite: an AST lint of ``src/repro_torch/`` and the
kernel contract checker (the counterpart of ``repro.analysis``).

Run it::

    PYTHONPATH=src python -m repro_torch.analysis              # both
    PYTHONPATH=src python -m repro_torch.analysis --lint       # one layer
    PYTHONPATH=src python -m repro_torch.analysis --contracts --json

Exit status 1 when any finding survives suppression
(``# repro: ignore[rule-id]``). ``tests/test_torch_analysis.py`` holds the
tree to a clean run.
"""
from repro_torch.analysis.findings import (Finding, filter_suppressed,
                                           render, suppressions, to_json)

__all__ = ["Finding", "filter_suppressed", "render", "suppressions",
           "to_json"]
