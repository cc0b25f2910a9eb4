"""The kernel contract checker of the port: the counterpart of
``repro.analysis.kernel_contracts`` for the hand-written CUDA kernels.

A kernel wrapper is a public function of ``src/repro_torch/kernels/*.py``
that launches a ``csrc/*.cu`` entry point: it adds one to its module's
``launches`` count there (itself, or through the module's own functions it
calls). Four checks:

- **kernel-oracle**: every wrapper sits on a row of the contract table in
  ``docs/kernels_torch.md`` that names a ``ref.*`` plain version, and
  every ``ref.*`` the table names is a function of ``kernels/ref.py``.
- **kernel-doc**: every wrapper has its row (``module.function``), the row
  names each CUDA source the wrapper binds and nothing that is not under
  ``csrc/``, each ``ops.*`` autograd Function it names is a class of
  ``kernels/ops.py`` that calls the wrapper, and no row names a wrapper
  that does not exist. (``docs/kernels.md`` is the reference's.)
- **kernel-smoke**: ``chip_smoke.py`` calls every wrapper through the
  module it imports it from, so each kernel is held to its plain version
  on the card.
- **kernel-tile**: pure-Python sweeps of the launch plans over ragged
  shapes and every registry configuration's widths: ``gbn.plan`` and
  ``fused_norm.plan`` return a plan within their shared-memory budget or
  raise their documented ``ValueError``; ``mamba_scan.check_shape`` (the
  gate of ``mamba_scan.plan``) passes or raises ``ValueError``
  (``mamba_scan.plan`` and ``flash_decode.chunk_slots`` ask the built
  library: the card's tests in ``tests/test_torch_port.py`` sweep them).
  Every ``head_dim`` of ``configs/registry.py`` (reduced variants and
  encoders included) is in ``flash_attention.HEAD_DIMS`` and ``BWD_HEAD_DIMS`` and
  ``flash_decode.HEAD_DIMS``, and its GQA group is one the decode kernels
  take: a config the kernels would refuse on the card is a finding here.

AST and small pure-Python sweeps: nothing is traced or compiled on the
CPU.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import REPO_ROOT

KERNELS_DIR = REPO_ROOT / "src" / "repro_torch" / "kernels"
KERNELS_DOC = REPO_ROOT / "docs" / "kernels_torch.md"
CHIP_SMOKE = REPO_ROOT / "chip_smoke.py"
KERNELS_PKG = "repro_torch.kernels"

_WRAPPER_RE = re.compile(r"`(\w+)\.(\w+)`")
_REF_RE = re.compile(r"`ref\.(\w+)`")
_OPS_RE = re.compile(r"`ops\.(\w+)`")
_CSRC_RE = re.compile(r"`csrc/([\w.]+)`")

# ragged and aligned shapes of the plan sweeps
_SWEEP_ROWS = (1, 7, 8, 77, 4096)
_SWEEP_WIDTHS = (1, 7, 100, 128, 256, 1000, 4097, 8192, 16384)
_SWEEP_GHOSTS = (1, 3, 32, 65535, 65536)
_SWEEP_GHOST_ROWS = (1, 7, 128, 1000, 2 ** 19)
_SWEEP_SMS = (132, 114, 1)
_SWEEP_CHUNKS = (1, 13, 256, 2048, 2049)
_SWEEP_STATES = (1, 5, 16, 17)


def _rel(path: Path) -> str:
    p = path.resolve()
    return p.relative_to(REPO_ROOT).as_posix() \
        if p.is_relative_to(REPO_ROOT) else p.as_posix()


# ---------------------------------------------------------------------------
# the wrappers, from the kernels' sources
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Wrapper:
    module: str            # kernels module stem, e.g. "flash_attention"
    name: str              # function name
    path: Path
    line: int
    sources: Tuple[str, ...]   # csrc files it binds


def _counts_launch(node: ast.AST) -> bool:
    """``launches[...] += 1``."""
    return (isinstance(node, ast.AugAssign)
            and isinstance(node.target, ast.Subscript)
            and isinstance(node.target.value, ast.Name)
            and node.target.value.id == "launches")


def _bound_source(node: ast.AST) -> Optional[str]:
    """The csrc file of ``L.bind("x.cu", ...)``."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "bind" and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
            and node.args[0].value.endswith(".cu")):
        return node.args[0].value
    return None


def _closure(start: str, edges: Dict[str, Set[str]]) -> Set[str]:
    seen, stack = {start}, [start]
    while stack:
        for n in edges.get(stack.pop(), ()):
            if n not in seen:
                seen.add(n)
                stack.append(n)
    return seen


def collect_wrappers(kernels_dir: Path = KERNELS_DIR) -> List[Wrapper]:
    """Every public module-level function that counts a launch, itself or
    through the module's own functions, with the csrc files it binds."""
    out: List[Wrapper] = []
    for path in sorted(kernels_dir.glob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        defs = {n.name: n for n in tree.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        calls: Dict[str, Set[str]] = {}
        counts: Set[str] = set()
        binds: Dict[str, Set[str]] = {}
        for name, fn in defs.items():
            calls[name] = set()
            binds[name] = set()
            for node in ast.walk(fn):
                if _counts_launch(node):
                    counts.add(name)
                src = _bound_source(node)
                if src is not None:
                    binds[name].add(src)
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name) \
                        and node.func.id in defs:
                    calls[name].add(node.func.id)
        for name, fn in defs.items():
            if name.startswith("_"):
                continue
            reach = _closure(name, calls)
            if reach & counts:
                srcs = sorted(set().union(*(binds[n] for n in reach)))
                out.append(Wrapper(path.stem, name, path, fn.lineno,
                                   tuple(srcs)))
    return out


# ---------------------------------------------------------------------------
# kernel-oracle, kernel-doc
# ---------------------------------------------------------------------------


def _module_defs(path: Path) -> Dict[str, int]:
    tree = ast.parse(path.read_text(), filename=str(path))
    return {n.name: n.lineno for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _classes(path: Path) -> Dict[str, ast.ClassDef]:
    tree = ast.parse(path.read_text(), filename=str(path))
    return {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}


def _table_rows(doc: str) -> List[Tuple[int, str, List[str]]]:
    """(line, first cell, cells) of every table row of the doc."""
    rows = []
    for i, line in enumerate(doc.splitlines(), start=1):
        if line.lstrip().startswith("|"):
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            rows.append((i, cells[0], cells))
    return rows


def check_contract_table(kernels_dir: Path = KERNELS_DIR,
                         doc_path: Path = KERNELS_DOC) -> List[Finding]:
    doc_rel = _rel(doc_path)
    if not doc_path.exists():
        return [Finding(doc_rel, 0, "kernel-doc",
                        "docs/kernels_torch.md is missing")]
    doc = doc_path.read_text()
    out: List[Finding] = []
    ref_defs = _module_defs(kernels_dir / "ref.py")
    ops_classes = _classes(kernels_dir / "ops.py")
    for i, line in enumerate(doc.splitlines(), start=1):
        for m in _REF_RE.finditer(line):
            if m.group(1) not in ref_defs:
                out.append(Finding(
                    doc_rel, i, "kernel-oracle",
                    f"the table names `ref.{m.group(1)}` but kernels/ref.py "
                    f"has no such function"))
    wrappers = collect_wrappers(kernels_dir)
    known = {(w.module, w.name) for w in wrappers}
    rows: Dict[Tuple[str, str], Tuple[int, List[str]]] = {}
    for i, first, cells in _table_rows(doc):
        m = _WRAPPER_RE.fullmatch(first)
        if m is None or m.group(1) in ("ref", "ops", "csrc"):
            continue
        key = (m.group(1), m.group(2))
        rows[key] = (i, cells)
        if key not in known:
            out.append(Finding(
                doc_rel, i, "kernel-doc",
                f"`{key[0]}.{key[1]}` is on the table but is no wrapper of "
                f"src/repro_torch/kernels (no function that counts a "
                f"launch)"))
    for w in wrappers:
        rel, label = _rel(w.path), f"`{w.module}.{w.name}`"
        if (w.module, w.name) not in rows:
            out.append(Finding(rel, w.line, "kernel-doc",
                               f"{label} has no row in "
                               f"docs/kernels_torch.md"))
            continue
        i, cells = rows[(w.module, w.name)]
        text = " | ".join(cells)
        if not _REF_RE.search(text):
            out.append(Finding(rel, w.line, "kernel-oracle",
                               f"{label}'s row names no `ref.*` plain "
                               f"version"))
        named = set(_CSRC_RE.findall(text))
        for src in w.sources:
            if src not in named:
                out.append(Finding(doc_rel, i, "kernel-doc",
                                   f"{label} binds csrc/{src}, which its "
                                   f"row does not name"))
        for src in named:
            if not (kernels_dir / "csrc" / src).exists():
                out.append(Finding(doc_rel, i, "kernel-doc",
                                   f"{label}'s row names csrc/{src}, which "
                                   f"does not exist"))
        for fn in _OPS_RE.findall(text):
            cls = ops_classes.get(fn)
            if cls is None:
                out.append(Finding(doc_rel, i, "kernel-doc",
                                   f"{label}'s row names `ops.{fn}`, no "
                                   f"class of kernels/ops.py"))
            elif not any(isinstance(n, ast.Attribute) and n.attr == w.name
                         for n in ast.walk(cls)):
                out.append(Finding(doc_rel, i, "kernel-doc",
                                   f"`ops.{fn}` does not call {label}"))
    return out


# ---------------------------------------------------------------------------
# kernel-smoke
# ---------------------------------------------------------------------------


def _aliases(tree: ast.AST) -> Dict[str, str]:
    """{name bound in the script: kernels module stem}."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == KERNELS_PKG:
            for a in node.names:
                out[a.asname or a.name] = a.name
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith(KERNELS_PKG + ".") and a.asname:
                    out[a.asname] = a.name.rsplit(".", 1)[1]
    return out


def check_chip_smoke(kernels_dir: Path = KERNELS_DIR,
                     script: Path = CHIP_SMOKE) -> List[Finding]:
    if not script.exists():
        return [Finding(_rel(script), 0, "kernel-smoke",
                        "chip_smoke.py is missing")]
    tree = ast.parse(script.read_text(), filename=str(script))
    aliases = _aliases(tree)
    called = {(aliases[n.func.value.id], n.func.attr)
              for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
              and isinstance(n.func.value, ast.Name)
              and n.func.value.id in aliases}
    return [Finding(_rel(w.path), w.line, "kernel-smoke",
                    f"`{w.module}.{w.name}` is never called in "
                    f"chip_smoke.py: nothing holds it to its plain version "
                    f"on the card")
            for w in collect_wrappers(kernels_dir)
            if (w.module, w.name) not in called]


# ---------------------------------------------------------------------------
# kernel-tile
# ---------------------------------------------------------------------------


def _line_of(path: Path, name: str) -> int:
    """The line of a module-level assignment to ``name`` (0 if none)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return node.lineno
    return 0


def registry_configs() -> list:
    """Every model configuration of the registry, its reduced variant, and
    the encoder of an encoder-decoder, as (name, n_heads, n_kv_heads,
    head_dim, d_model, ssm, attends): ``attends`` is False for a stack
    with no attention layer (falcon-mamba's head fields are
    placeholders)."""
    from repro_torch.configs.registry import _ARCHS
    out = []
    for cfg in _ARCHS.values():
        for c in (cfg, cfg.reduced()):
            out.append((c.name, c.n_heads, c.n_kv_heads, c.head_dim,
                        c.d_model, c.ssm, c.n_attn_layers > 0))
            if c.encoder is not None:
                e = c.encoder
                out.append((c.name + " encoder", e.n_heads, e.n_kv_heads,
                            e.d_model // e.n_heads, e.d_model, None, True))
    return out


def check_head_widths(configs: Optional[Sequence] = None, *,
                      head_dims: Optional[Iterable[int]] = None,
                      bwd_head_dims: Optional[Iterable[int]] = None,
                      decode_head_dims: Optional[Iterable[int]] = None
                      ) -> List[Finding]:
    """Every config's head width in the kernels' width sets and its GQA
    group one the decode kernels take. The sets default to the modules'
    own; a test passes copies."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    configs = registry_configs() if configs is None else configs
    fa_path, fd_path = KERNELS_DIR / "flash_attention.py", \
        KERNELS_DIR / "flash_decode.py"
    sets = [("flash_attention.HEAD_DIMS", FA.HEAD_DIMS if head_dims is None
             else tuple(head_dims), fa_path, "HEAD_DIMS"),
            ("flash_attention.BWD_HEAD_DIMS", FA.BWD_HEAD_DIMS
             if bwd_head_dims is None else tuple(bwd_head_dims), fa_path,
             "BWD_HEAD_DIMS"),
            ("flash_decode.HEAD_DIMS", FD.HEAD_DIMS if decode_head_dims is None
             else tuple(decode_head_dims), fd_path, "HEAD_DIMS")]
    out: List[Finding] = []
    for name, H, KV, hd, _, _, attends in configs:
        if not attends:
            continue
        for label, dims, path, const in sets:
            if hd not in dims:
                out.append(Finding(
                    _rel(path), _line_of(path, const), "kernel-tile",
                    f"{name}: head_dim={hd} is not in {label} {dims}: its "
                    f"attention raises on the card"))
        if H % KV or H // KV not in FD.GROUPS \
                or (H // KV) * hd > FD.MAX_GROUP_WIDTH:
            out.append(Finding(
                _rel(fd_path), _line_of(fd_path, "GROUPS"), "kernel-tile",
                f"{name}: H={H}, KV={KV}, hd={hd} is no GQA group the "
                f"decode kernels take (groups {FD.GROUPS}, group * hd <= "
                f"{FD.MAX_GROUP_WIDTH})"))
    return out


def _sweep(rel: str, label: str, fn, check) -> List[Finding]:
    """``check(fn())`` or a documented ValueError; any other exception,
    or a plan ``check`` rejects (it returns a message), is a finding."""
    try:
        plan = fn()
    except ValueError:
        return []
    except Exception as e:  # noqa: BLE001 -- reported, not raised
        return [Finding(rel, 0, "kernel-tile",
                        f"{label} raised {type(e).__name__}: {e}")]
    msg = check(plan)
    return [] if msg is None else [Finding(rel, 0, "kernel-tile",
                                           f"{label}: {msg}")]


def check_plans() -> List[Finding]:
    from repro_torch.kernels import fused_norm as FN
    from repro_torch.kernels import gbn as K
    from repro_torch.kernels import mamba_scan as MS
    out: List[Finding] = []
    cfgs = registry_configs()
    d_models = sorted({c[4] for c in cfgs})
    ssms = [c[5] for c in cfgs if c[5] is not None]

    def gbn_ok(p):
        if p.body == "two_pass":
            return None
        if p.smem_bytes > K.SMEM_PER_BLOCK \
                or p.blocks_per_sm * (p.smem_bytes + K.SMEM_RESERVED) \
                > K.SMEM_PER_SM:
            return (f"{p.smem_bytes} bytes a block x {p.blocks_per_sm} "
                    f"blocks pass the SM's shared memory")
        return None

    rel = _rel(KERNELS_DIR / "gbn.py")
    from repro_torch.configs.paper_models import PAPER_MODELS
    channels = sorted({c for m in PAPER_MODELS.values()
                       for c in m.channels + m.hidden_sizes}
                      | set(_SWEEP_WIDTHS))
    for G in _SWEEP_GHOSTS:
        for R in _SWEEP_GHOST_ROWS:
            for C in channels:
                for sms in _SWEEP_SMS:
                    for bwd in (False, True):
                        out += _sweep(rel, f"gbn.plan({G}, {R}, {C}, {sms}, "
                                      f"backward={bwd})",
                                      lambda: K.plan(G, R, C, sms,
                                                     backward=bwd), gbn_ok)

    def norm_ok(p):
        cap = FN.STREAM_SMEM_MAX if p.body == "stream" \
            else FN.SMEM_PER_BLOCK
        if p.smem_bytes > cap:
            return f"{p.smem_bytes} bytes of shared memory past {cap}"
        if p.threads > FN.THREADS or p.blocks < 1:
            return f"{p.threads} threads, {p.blocks} blocks"
        return None

    rel = _rel(KERNELS_DIR / "fused_norm.py")
    for d in sorted(w for w in set(_SWEEP_WIDTHS) | set(d_models)
                    if w <= FN.MAX_D):      # the wrappers refuse wider rows
        for N in _SWEEP_ROWS:
            for sms in _SWEEP_SMS:
                for bwd in (False, True):
                    for size in (2, 4):
                        out += _sweep(rel, f"fused_norm.plan({N}, {d}, {sms}"
                                      f", backward={bwd}, itemsize={size})",
                                      lambda: FN.plan(N, d, sms,
                                                      backward=bwd,
                                                      itemsize=size),
                                      norm_ok)

    rel = _rel(KERNELS_DIR / "mamba_scan.py")
    d_inner = sorted({s.expand * d for s, d in
                      ((c[5], c[4]) for c in cfgs if c[5] is not None)}
                     | {100, 8192})
    states = sorted({s.d_state for s in ssms} | set(_SWEEP_STATES))
    for di in d_inner:
        for c in _SWEEP_CHUNKS:
            for ds in states:
                for bwd in (False, True):
                    for B in (1, 8, MS.MAX_BATCH, MS.MAX_BATCH + 1):
                        out += _sweep(rel, f"mamba_scan.check_shape({B}, {c},"
                                      f" {di}, {ds}, {bwd})",
                                      lambda: MS.check_shape(B, c, di, ds,
                                                             bwd),
                                      lambda _: None)
    return out


def run_kernel_contracts() -> List[Finding]:
    return (check_contract_table() + check_chip_smoke()
            + check_head_widths() + check_plans())
