"""The port's AST lint: the reference's rules (``repro.analysis.lint``)
for the port's idiom, over ``src/repro_torch/``.

- ``host-sync``: hot-path code (the trainer, the serving engine,
  ``kernels/``) never calls ``.item()``, and does not fan one result out
  into per-element host syncs (``float(m["lr"])``, ``float(m["loss"])``,
  ``m["acc"].tolist()``, ``m["x"].cpu()``: each waits for the device on
  its own). Fetch once (``torch.stack([...]).tolist()``) and read the host
  copy.
- ``obs-contract``: a copy of the reference's rule. A function taking
  ``obs=`` defaults it to ``None``, span names are ``<subsystem>.<signal>``
  and metric names ``<subsystem>/<signal>``.
- ``axis-name-literal``: the collectives of
  :mod:`repro_torch.launch.collectives` take their axes from the
  ``launch.mesh`` constants (``POD_AXIS``, ``DATA_AXIS``, ``MODEL_AXIS``),
  never from string literals.
- ``rng-implicit``: the counterpart of the reference's ``prng-reuse``. The
  port draws from explicit ``torch.Generator``s, so a random draw
  (``torch.randn``, ``rand``, ``randint``, ``randperm``, ``normal``,
  ``bernoulli``, ``multinomial``, ..., or a tensor's in-place
  ``normal_``, ``uniform_``, ``bernoulli_``, ...) without ``generator=``
  reads the global stream and is flagged.

The reference's ``shard-map-import`` is JAX's own (``shard_map`` through
its version shim) and has no counterpart here.

Rules are pure AST passes: nothing of the linted code is imported, so a
broken module still lints. Findings are suppressed per line with
``# repro: ignore[rule-id]`` (:mod:`repro_torch.analysis.findings`).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

from repro_torch.analysis.findings import Finding, filter_suppressed

REPO_ROOT = Path(__file__).resolve().parents[3]
PORT_ROOT = REPO_ROOT / "src" / "repro_torch"


@dataclass(frozen=True)
class LintConfig:
    """Paths are matched as substrings of the repo-relative posix path."""
    # modules whose loops interleave with device work (rule host-sync)
    hot_paths: Sequence[str] = ("train/trainer.py", "serving/engine.py",
                                "kernels/")


DEFAULT_CONFIG = LintConfig()


def _matches(relpath: str, patterns: Sequence[str]) -> bool:
    return any(p in relpath for p in patterns)


# ---------------------------------------------------------------------------
# rule: host-sync
# ---------------------------------------------------------------------------

# methods that bring a tensor to the host: a fan-out of them over one
# result syncs once each; a name assigned from one holds a host copy
_HOST_METHODS = {"tolist", "cpu", "numpy"}


def _scope_walk(fn: ast.AST) -> Iterable[ast.AST]:
    """Nodes of a function's own scope: nested def/class bodies excluded
    (they are linted as their own scopes); lambdas stay in the enclosing
    scope."""
    stack = list(fn.body)  # type: ignore[attr-defined]
    while stack:
        n = stack.pop()
        yield n
        for c in ast.iter_child_nodes(n):
            if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            stack.append(c)


def _subscript_base(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name):
        return node.value.id
    return None


def _assigned_names(target: ast.AST) -> Iterable[str]:
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _assigned_names(elt)


def _fetches(value: ast.AST) -> bool:
    """The value holds a host copy: it calls .tolist(), .cpu() or .numpy()
    somewhere."""
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr in _HOST_METHODS for n in ast.walk(value))


def rule_host_sync(tree: ast.AST, relpath: str,
                   cfg: LintConfig) -> List[Finding]:
    if not _matches(relpath, cfg.hot_paths):
        return []
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        host_names: Set[str] = set()     # fetched once
        conversions: Dict[str, List[ast.AST]] = {}
        for node in _scope_walk(fn):
            if isinstance(node, ast.Assign):
                if _fetches(node.value):
                    for t in node.targets:
                        host_names.update(_assigned_names(t))
                continue
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            # any .item() is a device sync of its own: never on a hot path
            if isinstance(f, ast.Attribute) and f.attr == "item" \
                    and not node.args:
                out.append(Finding(
                    relpath, node.lineno, "host-sync",
                    ".item() forces a device sync on a hot path: fetch the "
                    "step's values once (torch.stack([...]).tolist())"))
                continue
            # float(m["x"]) / int(m["x"]) / m["x"].tolist() / m["x"].cpu():
            # grouped by m
            base = None
            if isinstance(f, ast.Name) and f.id in ("float", "int") \
                    and len(node.args) == 1:
                base = _subscript_base(node.args[0])
            elif isinstance(f, ast.Attribute) and f.attr in _HOST_METHODS \
                    and not node.args:
                base = _subscript_base(f.value)
            if base is not None:
                conversions.setdefault(base, []).append(node)
        for name, sites in conversions.items():
            if len(sites) < 2 or name in host_names:
                continue
            for site in sorted(sites, key=lambda n: (n.lineno,
                                                     n.col_offset))[1:]:
                out.append(Finding(
                    relpath, site.lineno, "host-sync",
                    f"{len(sites)} separate host syncs on '{name}' in one "
                    f"scope: fetch its values once (torch.stack([...])"
                    f".tolist()) and read them from the host copy"))
    return out


# ---------------------------------------------------------------------------
# rule: obs-contract (as the reference's)
# ---------------------------------------------------------------------------

SPAN_NAME_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$")
METRIC_NAME_RE = re.compile(r"^[a-z0-9_]+(/[a-z0-9_]+)+$")
_METRIC_METHODS = {"observe", "set", "inc"}


def _arg_default(fn: ast.AST, name: str):
    """(found, default node or None if it has none) of a parameter."""
    a = fn.args  # type: ignore[attr-defined]
    pos = list(a.posonlyargs) + list(a.args)
    n_def = len(a.defaults)
    for i, arg in enumerate(pos):
        if arg.arg == name:
            j = i - (len(pos) - n_def)
            return True, (a.defaults[j] if j >= 0 else None)
    for i, arg in enumerate(a.kwonlyargs):
        if arg.arg == name:
            return True, a.kw_defaults[i]
    return False, None


def rule_obs_contract(tree: ast.AST, relpath: str,
                      cfg: LintConfig) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            found, default = _arg_default(node, "obs")
            if found and not (isinstance(default, ast.Constant)
                              and default.value is None):
                out.append(Finding(
                    relpath, node.lineno, "obs-contract",
                    f"'{node.name}' takes obs= but does not default it to "
                    f"None: call sites must stay zero-cost un-observed"))
            continue
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute) and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            continue
        name = node.args[0].value
        if node.func.attr == "span" and not SPAN_NAME_RE.match(name):
            out.append(Finding(
                relpath, node.lineno, "obs-contract",
                f"span name '{name}' violates the <subsystem>.<signal> "
                f"grammar"))
        elif node.func.attr in _METRIC_METHODS \
                and not METRIC_NAME_RE.match(name):
            out.append(Finding(
                relpath, node.lineno, "obs-contract",
                f"metric name '{name}' violates the <subsystem>/<signal> "
                f"grammar"))
    return out


# ---------------------------------------------------------------------------
# rule: axis-name-literal
# ---------------------------------------------------------------------------

# repro_torch.launch.collectives: the axes are the second positional
# argument (after the tensor), or the first for axis_index, or ``axes=``
_COLLECTIVES_ARG1 = {"psum", "pmean", "pmean_many", "all_gather",
                     "psum_scatter"}
_COLLECTIVES_ARG0 = {"axis_index"}


def _has_str_literal(node: ast.AST) -> bool:
    """A string constant, or a tuple/list literal holding one."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return True
    if isinstance(node, (ast.Tuple, ast.List)):
        return any(_has_str_literal(e) for e in node.elts)
    return False


def _call_name(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def rule_axis_name_literal(tree: ast.AST, relpath: str,
                           cfg: LintConfig) -> List[Finding]:
    """Collective axes come from the ``launch.mesh`` constants, not inline
    strings: a rename of the mesh layout is one edit, not a search of the
    repository."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name in _COLLECTIVES_ARG1:
            pos = 1
        elif name in _COLLECTIVES_ARG0:
            pos = 0
        else:
            continue
        axis_args = [kw.value for kw in node.keywords if kw.arg == "axes"]
        if len(node.args) > pos:
            axis_args.append(node.args[pos])
        for a in axis_args:
            if _has_str_literal(a):
                out.append(Finding(
                    relpath, node.lineno, "axis-name-literal",
                    f"string-literal axis name in {name}(): use the "
                    f"repro_torch.launch.mesh constants (POD_AXIS / "
                    f"DATA_AXIS / MODEL_AXIS)"))
    return out


# ---------------------------------------------------------------------------
# rule: rng-implicit
# ---------------------------------------------------------------------------

# torch.<name>(...) draws
_TORCH_DRAWS = {"randn", "rand", "randint", "randperm", "randn_like",
                "rand_like", "randint_like", "normal", "bernoulli",
                "multinomial", "poisson"}
# <tensor>.<name>(...) in-place draws
_INPLACE_DRAWS = {"normal_", "uniform_", "bernoulli_", "exponential_",
                  "random_", "geometric_", "cauchy_", "log_normal_"}


def _is_torch(node: ast.AST) -> bool:
    return isinstance(node, ast.Name) and node.id == "torch"


def rule_rng_implicit(tree: ast.AST, relpath: str,
                      cfg: LintConfig) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        f = node.func
        draw = (f.attr in _TORCH_DRAWS and _is_torch(f.value)) \
            or f.attr in _INPLACE_DRAWS
        if not draw or any(kw.arg == "generator" for kw in node.keywords):
            continue
        out.append(Finding(
            relpath, node.lineno, "rng-implicit",
            f"{f.attr}() without generator= draws from torch's global "
            f"stream: pass the caller's torch.Generator"))
    return out


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

RuleFn = Callable[[ast.AST, str, LintConfig], List[Finding]]

RULES: Dict[str, RuleFn] = {
    "host-sync": rule_host_sync,
    "obs-contract": rule_obs_contract,
    "axis-name-literal": rule_axis_name_literal,
    "rng-implicit": rule_rng_implicit,
}

CATALOG: Dict[str, str] = {
    "host-sync": "per-metric device syncs / .item() on a hot path",
    "obs-contract": "obs= without None default, or span/metric name "
                    "off the naming grammar",
    "axis-name-literal": "collective axis name spelled as a string literal "
                         "instead of a launch.mesh constant",
    "rng-implicit": "random draw without generator= (torch's global "
                    "stream)",
}


def lint_source(source: str, relpath: str,
                cfg: LintConfig = DEFAULT_CONFIG,
                rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint one file's source; suppressions already applied."""
    tree = ast.parse(source, filename=relpath)
    findings: List[Finding] = []
    for rule_id in (rules or RULES):
        findings.extend(RULES[rule_id](tree, relpath, cfg))
    return filter_suppressed(findings, {relpath: source})


def lint_paths(paths: Iterable[Path], *, root: Path = REPO_ROOT,
               cfg: LintConfig = DEFAULT_CONFIG,
               rules: Optional[Sequence[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for path in sorted(paths):
        p = path.resolve()
        rel = p.relative_to(root).as_posix() if p.is_relative_to(root) \
            else path.as_posix()
        findings.extend(lint_source(path.read_text(), rel, cfg,
                                    rules=rules))
    return findings


def run_repo_lint(cfg: LintConfig = DEFAULT_CONFIG) -> List[Finding]:
    """The port's gate: every rule over every module of
    ``src/repro_torch/``."""
    return lint_paths(PORT_ROOT.rglob("*.py"), root=REPO_ROOT, cfg=cfg)
