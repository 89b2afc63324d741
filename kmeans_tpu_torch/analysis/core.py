"""Linter infrastructure: source loading, suppressions, the runner.

Counterpart of ``kmeans_tpu/analysis/core.py``, kept as its own copy (the
port imports nothing of the JAX package).  Pure stdlib — ``ast`` +
``tokenize`` only.  The linter inspects every module in the package
(including the CUDA paths) WITHOUT importing any of them — checked code is
never executed — so nothing in this module may depend on torch/numpy.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional

# Suppression comment grammar — see the package docstring.  The reason
# separator accepts an em-dash, en-dash, or plain hyphen.
_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*ok\(\s*(?P<rules>[^)]*)\s*\)\s*"
    r"(?:[—–-]+\s*(?P<reason>.*\S))?\s*$")
# Anything that *tries* to be a suppression — used to catch malformed
# forms (a missing rule list or reason) as findings instead of silently
# ignoring them.
_SUPPRESS_ATTEMPT_RE = re.compile(r"#\s*lint:\s*ok\b")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str           # repo-relative (or as-given) posix path
    line: int
    message: str
    incident: str = ""  # one-line historical-incident citation

    def format(self) -> str:
        cite = f"  [{self.incident}]" if self.incident else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{cite}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "incident": self.incident}


@dataclass
class Suppression:
    """One parsed ``# lint: ok(...)`` comment."""

    path: str
    line: int
    rules: tuple
    reason: str
    used: int = 0       # findings this suppression absorbed

    def to_json(self) -> dict:
        return {"path": self.path, "line": self.line,
                "rules": list(self.rules), "reason": self.reason,
                "used": self.used}


class Module:
    """One parsed source file: AST + raw lines + suppression table."""

    def __init__(self, path: Path, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=str(path))
        # line -> Suppression; plus the malformed attempts for the
        # ``suppression`` rule.
        self.suppressions: Dict[int, Suppression] = {}
        self.malformed_suppressions: List[tuple] = []   # (line, comment)
        self._scan_comments()
        self._parents: Optional[dict] = None

    # -------------------------------------------------------- comments
    def _scan_comments(self) -> None:
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.text).readline))
        except (tokenize.TokenError, IndentationError):     # pragma: no cover
            tokens = []
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            comment = tok.string
            if not _SUPPRESS_ATTEMPT_RE.search(comment):
                continue
            m = _SUPPRESS_RE.search(comment)
            line = tok.start[0]
            if m is None:
                self.malformed_suppressions.append((line, comment.strip()))
                continue
            rules = tuple(r.strip() for r in m.group("rules").split(",")
                          if r.strip())
            reason = (m.group("reason") or "").strip()
            if not rules or not reason:
                self.malformed_suppressions.append((line, comment.strip()))
                continue
            self.suppressions[line] = Suppression(
                path=self.rel, line=line, rules=rules, reason=reason)

    def suppression_for(self, rule: str, line: int) -> Optional[Suppression]:
        """The suppression covering ``rule`` at ``line``: on the line
        itself, or on a directly preceding standalone-comment line."""
        sup = self.suppressions.get(line)
        if sup is not None and rule in sup.rules:
            return sup
        # Walk up over a contiguous run of comment-only lines.
        probe = line - 1
        while probe >= 1 and self._is_comment_only(probe):
            sup = self.suppressions.get(probe)
            if sup is not None and rule in sup.rules:
                return sup
            probe -= 1
        return None

    def _is_comment_only(self, line: int) -> bool:
        if line > len(self.lines):
            return False
        stripped = self.lines[line - 1].strip()
        return stripped.startswith("#")

    # ------------------------------------------------------------- ast
    def parents(self) -> dict:
        """child node -> parent node map (built lazily, cached)."""
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    def enclosing(self, node: ast.AST, kinds) -> Optional[ast.AST]:
        """Nearest ancestor of ``node`` whose type is in ``kinds``."""
        parents = self.parents()
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, kinds):
                return cur
            cur = parents.get(cur)
        return None

    def module_scope_names(self) -> set:
        """Names bound at module top level (imports, defs, classes,
        constants) — the 'static environment' a closure may freely use
        without it being a cache knob.  Import-bound names ANYWHERE in
        the module count too: a function-local ``import ... as dist``
        is still a static module reference, never a knob."""
        names = set()
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            names.add(n.id)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    names.add((alias.asname or alias.name).split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    names.add(alias.asname or alias.name)
        return names


class Package:
    """All modules under the linted paths, plus cross-module indexes."""

    def __init__(self, modules: List[Module]):
        self.modules = modules

    def __iter__(self) -> Iterable[Module]:
        return iter(self.modules)


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)
    suppressions: List[Suppression] = field(default_factory=list)
    files: int = 0
    suppressed: int = 0

    @property
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_json(self) -> dict:
        return {
            "files": self.files,
            "findings": [f.to_json() for f in self.findings],
            "counts": self.counts,
            "suppressed": self.suppressed,
            "suppressions": [s.to_json() for s in self.suppressions],
        }


def _collect_files(paths: Iterable) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if not p.exists():
            raise FileNotFoundError(f"no such file or directory: {p}")
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
        else:
            raise ValueError(f"not a .py file or directory: {p}")
    # De-duplicate while preserving order (overlapping path args).
    seen = set()
    out = []
    for f in files:
        key = f.resolve()
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def load_package(paths: Iterable, root: Optional[Path] = None) -> Package:
    """Parse every ``.py`` under ``paths`` into a :class:`Package`.

    Raises ``FileNotFoundError``/``ValueError`` for malformed paths and
    ``SyntaxError`` for unparseable sources — path problems are CLI
    errors (exit 2 with a message), not findings.
    """
    files = _collect_files(paths)
    modules = []
    for f in files:
        try:
            rel = str(f.resolve().relative_to(
                Path(root).resolve() if root else Path.cwd()))
        except ValueError:
            rel = str(f)
        modules.append(Module(f, rel, f.read_text()))
    return Package(modules)


def lint_paths(paths: Iterable, rules: Optional[Iterable[str]] = None,
               root: Optional[Path] = None) -> Report:
    """Run the rule registry over ``paths``; returns the full report
    with suppressions applied (and counted)."""
    from kmeans_tpu_torch.analysis.rules import RULES

    pkg = load_package(paths, root=root)
    active = [RULES[r] for r in rules] if rules is not None \
        else list(RULES.values())
    report = Report(files=len(pkg.modules))
    for rule in active:
        for finding in rule.run(pkg):
            mod = next((m for m in pkg if m.rel == finding.path), None)
            sup = mod.suppression_for(finding.rule, finding.line) \
                if mod is not None else None
            if sup is not None:
                sup.used += 1
                report.suppressed += 1
            else:
                report.findings.append(finding)
    for mod in pkg:
        report.suppressions.extend(mod.suppressions.values())
    report.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return report
