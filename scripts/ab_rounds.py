"""Run a timing script's worker once for each tree of the port in turn, in
the order A B B A (two rounds), A B B A A B B A (four), ..., each in a
process of its own (two trees' ``repro_torch`` cannot share one), so that
two commits compare on one card in one call. Used by
``scripts/lm_step_times.py`` and ``scripts/norm_times.py``; the card's name
and power limit come from ``chip_smoke.smi_line``."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Sequence

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import smi_line  # noqa: E402,F401


def run_rounds(script: str, trees: Sequence[str], rounds: int,
               worker_args: Sequence[str] = (), timeout: int = 900
               ) -> Dict[str, List[dict]]:
    """``python3 script --worker *worker_args tree`` for each tree, round
    after round, the order reversed every other round; each worker prints
    one JSON line last, which is echoed. Returns {tree: [its lines]}; a
    worker that fails ends the run."""
    runs = {t: [] for t in trees}
    for r in range(rounds):
        for tree in (trees if r % 2 == 0 else trees[::-1]):
            out = subprocess.run(
                [sys.executable, script, "--worker", *worker_args, tree],
                capture_output=True, text=True, cwd=ROOT, timeout=timeout)
            if out.returncode != 0:
                sys.stderr.write(out.stderr[-4000:])
                raise SystemExit(f"{tree}: exit {out.returncode}")
            line = out.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs[tree].append(json.loads(line))
    return runs
