"""AST rule engine of the port's linter, the port's own copy of the JAX
package's ``repro/lint/engine.py``.

Standard-library ``ast`` only: importing it imports neither torch nor
anything of the port, and a scan of the port takes well under a second.
The engine owns the mechanics (walking files, parsing, pragma
suppression, collecting findings); the rules, what is checked, live in
:mod:`repro_torch.lint.rules`.

Pragma contract (``# lint: allow(<rule>): <reason>``):

* a trailing pragma suppresses findings of ``<rule>`` on its own line;
* a pragma on a comment line of its own also suppresses the line below it
  (and a block of comment lines carries it to the statement after them);
* the reason is mandatory: an allow without one is itself a finding
  (rule id ``lint-pragma``), since a suppression nobody can audit is how
  an invariant rots.

Findings print as ``path:line: rule-id: message`` (paths relative to the
repo), and the CLI (``python -m repro_torch.lint``) exits non-zero when
any remain.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set

BAD_PRAGMA_RULE = "lint-pragma"

# trailing or on a line of its own:  # lint: allow(rule-id): reason
_PRAGMA_RE = re.compile(r"#\s*lint:\s*allow\(([\w-]+)\)\s*(?::\s*(\S.*))?")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a source location."""

    path: str           # posix path relative to the repo
    line: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


class LintContext:
    """What a rule sees of one file: the parsed tree, the source (for
    ``ast.get_source_segment``) and the path relative to the repo (rules
    scope themselves on it)."""

    def __init__(self, rel: str, src: str, tree: ast.AST):
        self.rel = rel
        self.src = src
        self.tree = tree

    def segment(self, node: ast.AST) -> str:
        return ast.get_source_segment(self.src, node) or ""

    def finding(self, node_or_line, rule: str, message: str) -> Finding:
        line = (node_or_line if isinstance(node_or_line, int)
                else getattr(node_or_line, "lineno", 0))
        return Finding(path=self.rel, line=line, rule=rule, message=message)


class Rule:
    """One invariant.  A subclass sets ``name`` (the pragma and CLI id),
    ``invariant`` (what must hold) and ``recurrence`` (the fault it keeps
    from coming back; both print with ``--list-rules``), overrides
    ``applies(rel)`` to scope itself, and implements ``check(ctx)``."""

    name: str = ""
    invariant: str = ""
    recurrence: str = ""

    def applies(self, rel: str) -> bool:
        return True

    def check(self, ctx: LintContext) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError


def _pragmas(src: str):
    """{line: {rule, ...}} of the allows, and the pragmas without a reason
    as (line, message) pairs."""
    allowed: Dict[int, Set[str]] = {}
    bad: List[tuple] = []
    lines = src.splitlines()
    for i, line in enumerate(lines, 1):
        m = _PRAGMA_RE.search(line)
        if not m:
            continue
        rule, reason = m.group(1), m.group(2)
        if not reason:
            bad.append((i, f"allow({rule}) pragma without a reason — "
                           f"write '# lint: allow({rule}): <why>' so the "
                           f"suppression can be audited"))
            continue
        allowed.setdefault(i, set()).add(rule)
        if line.lstrip().startswith("#"):
            allowed.setdefault(i + 1, set()).add(rule)
    # a pragma on a comment line covers the rest of its comment block and
    # the line after it
    for i in sorted(allowed):
        j = i
        while j <= len(lines) and lines[j - 1].lstrip().startswith("#"):
            allowed.setdefault(j + 1, set()).update(allowed[i])
            j += 1
    return allowed, bad


def lint_source(src: str, rel: str, rules: Sequence[Rule]) -> List[Finding]:
    """Lint one source text as if it lived at ``rel`` (relative to the
    repo, so rule scoping applies): what the fixture tests call, and what
    :func:`lint_file` wraps."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(path=rel, line=e.lineno or 0, rule="syntax-error",
                        message=f"file does not parse: {e.msg}")]
    ctx = LintContext(rel, src, tree)
    allowed, bad = _pragmas(src)
    out: List[Finding] = [ctx.finding(line, BAD_PRAGMA_RULE, msg) for line, msg in bad]
    for rule in rules:
        if not rule.applies(rel):
            continue
        for f in rule.check(ctx):
            if f.rule not in allowed.get(f.line, ()):
                out.append(f)
    return sorted(out)


def _rel_path(path: pathlib.Path, root: pathlib.Path) -> str:
    """The path relative to the repo, for rule scoping.  A path outside
    ``root`` (a fixture in a temporary directory) is anchored at its last
    ``src`` or ``tests`` component, so the same scoping applies; failing
    that, its name."""
    rp = path.resolve()
    try:
        return rp.relative_to(root.resolve()).as_posix()
    except ValueError:
        parts = rp.parts
        for i in range(len(parts) - 1, -1, -1):
            if parts[i] in ("src", "tests"):
                return "/".join(parts[i:])
        return rp.name


def lint_file(path: pathlib.Path, root: pathlib.Path,
              rules: Sequence[Rule]) -> List[Finding]:
    return lint_source(path.read_text(), _rel_path(path, root), rules)


def iter_python_files(targets: Sequence[pathlib.Path]):
    for t in targets:
        if t.is_file() and t.suffix == ".py":
            yield t
        elif t.is_dir():
            yield from sorted(p for p in t.rglob("*.py") if "__pycache__" not in p.parts)


def lint_paths(targets: Sequence[pathlib.Path], root: pathlib.Path,
               rules: Sequence[Rule]) -> List[Finding]:
    out: List[Finding] = []
    for path in iter_python_files(targets):
        out.extend(lint_file(path, root, rules))
    return sorted(out)


def repo_root() -> pathlib.Path:
    """The checkout this package was imported from
    (src/repro_torch/lint/engine.py, three parents up)."""
    return pathlib.Path(__file__).resolve().parents[3]


def default_targets(root: Optional[pathlib.Path] = None) -> List[pathlib.Path]:
    """What the self-scan covers: the port's package and its tests
    (``tests/test_torch_*.py``)."""
    root = root or repo_root()
    pkg = root / "src" / "repro_torch"
    return ([pkg] if pkg.exists() else []) + sorted((root / "tests").glob("test_torch_*.py"))


def findings_json(findings: Sequence[Finding]) -> str:
    return json.dumps([f.to_json() for f in findings], indent=2)
