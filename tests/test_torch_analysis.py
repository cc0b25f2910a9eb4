"""The port's static suite (``repro_torch.analysis``): each lint rule fires
on a small bad snippet and is silenced by its suppression; the tree lints
clean; the kernel contracts hold on the tree and catch a head width taken
out of the kernels' sets (on a copy of the set), a wrapper without a row
and a row whose plain version is gone; the CLI's exit codes. Nothing here
imports jax."""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import cli, kernel_contracts as KC, lint
from repro_torch.analysis.findings import (Finding, filter_suppressed,
                                           render, suppressions, to_json)
from repro_torch.kernels import flash_attention as FA

ROOT = Path(__file__).resolve().parents[1]
HOT = "src/repro_torch/serving/engine.py"
COLD = "src/repro_torch/models/layers.py"

# rule: (bad snippet, path it is linted as)
BAD = {
    "host-sync": ("def step(m):\n"
                  "    a = float(m['loss'])\n"
                  "    b = m['lr'].tolist()\n"
                  "    return a, b, m['x'].item()\n", HOT),
    "obs-contract": ("def run(x, obs=object()):\n"
                     "    obs.span('NoDots')\n"
                     "    obs.observe('no_slash', 1.0)\n", COLD),
    "axis-name-literal": ("def f(x, mesh):\n"
                          "    return C.psum(x, ('data',), mesh)\n", COLD),
    "rng-implicit": ("def f(x, g):\n"
                     "    y = torch.randn(3, device=x.device)\n"
                     "    x.normal_()\n"
                     "    return y, torch.randint(0, 4, (2,), generator=g)\n",
                     COLD),
}


@pytest.mark.parametrize("rule", sorted(BAD))
def test_rule_fires_and_its_suppression_silences_it(rule):
    src, path = BAD[rule]
    found = lint.lint_source(src, path, rules=[rule])
    assert found and {f.rule for f in found} == {rule}
    lines = src.splitlines()
    for f in found:
        lines[f.line - 1] += f"  # repro: ignore[{rule}]"
    assert lint.lint_source("\n".join(lines) + "\n", path,
                            rules=[rule]) == []


def test_rules_stay_quiet_on_the_port_idiom():
    good = ("def step(m, keys, g):\n"
            "    vals = torch.stack([m[k] for k in keys]).tolist()\n"
            "    z = torch.randn(3, generator=g)\n"
            "    return C.psum(z, (DATA_AXIS,), None), float(vals[0])\n")
    assert lint.lint_source(good, HOT) == []
    # the hot-path rule reads only the hot paths
    assert lint.lint_source(BAD["host-sync"][0], COLD,
                            rules=["host-sync"]) == []
    assert set(lint.CATALOG) == set(lint.RULES)


def test_host_sync_counts_each_fan_out_site():
    found = lint.lint_source(BAD["host-sync"][0], HOT, rules=["host-sync"])
    assert sorted(f.line for f in found) == [3, 4]    # b's fan-out, .item()


def test_suppressions_parse_several_rules():
    src = "x = 1  # repro: ignore[host-sync, rng-implicit]\n"
    assert suppressions(src) == {1: {"host-sync", "rng-implicit"}}
    f = Finding("a.py", 1, "obs-contract", "m")
    assert filter_suppressed([f], {"a.py": src}) == [f]
    assert render([]) == "clean: 0 findings"
    assert '"rule": "obs-contract"' in to_json([f])


def test_repo_lint_is_clean():
    assert lint.run_repo_lint() == []


def test_kernel_contracts_are_clean_on_the_tree():
    wrappers = {(w.module, w.name) for w in KC.collect_wrappers()}
    assert ("flash_attention", "flash_attention_rope_backward") in wrappers
    assert ("gbn", "forward_with") in wrappers
    assert not any(n.startswith("_") for _, n in wrappers)
    assert KC.run_kernel_contracts() == []


def test_a_width_taken_out_of_the_sets_is_a_finding():
    dims = tuple(d for d in FA.HEAD_DIMS if d != 120)
    found = KC.check_head_widths(head_dims=dims)
    assert found and all(f.rule == "kernel-tile" for f in found)
    assert any("h2o-danube-3-4b: head_dim=120" in f.message for f in found)
    assert not any("kimi" in f.message for f in found)
    found = KC.check_head_widths(decode_head_dims=(32, 64, 120, 128, 256))
    assert {f.message.split(":")[0] for f in found} == {"kimi-k2-1t-a32b"}


def test_contract_table_catches_a_missing_row_and_a_gone_oracle(tmp_path):
    doc = KC.KERNELS_DOC.read_text()
    lines = [ln for ln in doc.splitlines()
             if not ln.startswith("| `swiglu.swiglu` ")]
    (tmp_path / "no_row.md").write_text("\n".join(lines) + "\n")
    found = KC.check_contract_table(doc_path=tmp_path / "no_row.md")
    assert [(f.rule, "swiglu.swiglu" in f.message) for f in found] == [
        ("kernel-doc", True)]
    (tmp_path / "gone.md").write_text(
        doc.replace("`ref.swiglu_ref`", "`ref.swiglu_gone`"))
    found = KC.check_contract_table(doc_path=tmp_path / "gone.md")
    assert {f.rule for f in found} == {"kernel-oracle"}


def test_chip_smoke_must_call_every_wrapper(tmp_path):
    script = tmp_path / "chip_smoke.py"
    script.write_text("from repro_torch.kernels import swiglu as SW\n"
                      "SW.swiglu(x, wg, wu)\n")
    found = KC.check_chip_smoke(script=script)
    names = {f.message.split("`")[1] for f in found}
    assert "swiglu.swiglu" not in names
    assert "flash_attention.flash_attention_fwd" in names


def test_cli_exit_codes(tmp_path):
    assert cli.main(["--lint"]) == 0
    assert cli.main(["--contracts", "--json"]) == 0
    # a seeded finding: a copy of the port with one bad module
    port = tmp_path / "src" / "repro_torch"
    shutil.copytree(ROOT / "src" / "repro_torch", port,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    (port / "serving" / "seeded.py").write_text(
        "import torch\n\n\ndef f():\n    return torch.rand(2)\n")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--lint", "--json"],
        cwd=tmp_path, env={"PYTHONPATH": str(tmp_path / "src"),
                           "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 1, run.stderr
    assert '"rule": "rng-implicit"' in run.stdout
    assert "src/repro_torch/serving/seeded.py" in run.stdout
