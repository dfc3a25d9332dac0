"""Parsed modules for the conf-key scanner.

The part of ``hadoop_tpu/analysis/core.py`` that ``confscan.py`` needs:
:class:`SourceModule` (one parsed file and its dotted name),
:class:`Project`, :func:`iter_py_files`, :func:`load_project` and the AST
helper :func:`attr_chain`. The lint checkers, suppressions and baseline
are not ported.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class SourceModule:
    """One parsed file."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)

    @property
    def dotted(self) -> str:
        """The dotted module name under the package root, e.g.
        ``hadoop_tpu_torch.ipc.client``."""
        stem = self.rel[:-3] if self.rel.endswith(".py") else self.rel
        parts = stem.split("/")
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)


class Project:
    """Every module of one scan."""

    def __init__(self, modules: Sequence[SourceModule]):
        self.modules = list(modules)
        self.by_dotted: Dict[str, SourceModule] = {
            m.dotted: m for m in self.modules}


_EXCLUDE_DIRS = {"__pycache__", ".git", "node_modules", ".venv"}


def iter_py_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.append(os.path.abspath(p))
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _EXCLUDE_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.abspath(os.path.join(dirpath, fn)))
    return out


def load_project(paths: Iterable[str], root: Optional[str] = None
                 ) -> Tuple[Project, List[Tuple[str, int, str]]]:
    """Parse every ``.py`` under ``paths``. A file that does not parse is
    returned as ``(rel, line, message)``, not raised."""
    files = iter_py_files(paths)
    if root is None:
        root = os.path.commonpath(files) if files else os.getcwd()
    root = os.path.abspath(root)
    if os.path.isfile(root):
        root = os.path.dirname(root)
    # walk out of the package, so relative paths and dotted names carry
    # its name: hadoop_tpu_torch/ipc/client.py, not ipc/client.py
    while os.path.isfile(os.path.join(root, "__init__.py")):
        root = os.path.dirname(root)
    modules: List[SourceModule] = []
    errors: List[Tuple[str, int, str]] = []
    for f in files:
        rel = os.path.relpath(f, root)
        try:
            with open(f, "r", encoding="utf-8") as fh:
                src = fh.read()
            modules.append(SourceModule(f, rel, src))
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append((rel.replace(os.sep, "/"),
                           getattr(e, "lineno", None) or 1,
                           f"cannot analyse: {e}"))
    return Project(modules), errors


def attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` -> ["a", "b", "c"]; None for a chain not rooted in a
    name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None

