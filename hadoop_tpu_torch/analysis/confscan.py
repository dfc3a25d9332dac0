"""Conf-key extraction: the port's lever space, statically resolved.

The port's copy of ``hadoop_tpu/analysis/confscan.py``, pointed at
``hadoop_tpu_torch/``. It walks the package's AST, resolves every
``conf.get / get_trimmed / get_int / get_bool / get_float /
get_size_bytes / get_time_seconds / get_list`` site (the getters of
``conf.ConfLike``) whose receiver names a conf (a ``conf`` substring in the chain),
and builds the generated registry ``hadoop_tpu_torch/conf/registry.py``
that the door's ``/ws/v1/conf``, strict mode and the
``--check-conf-registry`` gate read, with a README appendix between the
port's own markers (``torch-conf-registry:begin`` / ``:end``; the
reference's scanner treats the region as generated, and its exact
markers are the reference's appendix).

Resolution, in the order tried for a name:

* constants folded structurally (literals, ``+`` / ``*`` / ``<<``
  arithmetic, tuples of constants);
* names bound by a ``for`` or comprehension over a literal container,
  tuple destructuring kept positionwise, so ``for _, key, default in
  RULES`` pairs each key with its own default;
* single-assignment function locals, module-level constants,
  class-attribute constants (``self.X`` / ``Cls.X``) and constants
  imported from other modules of the package;
* f-strings and ``+`` chains expand when every hole resolves and
  degrade to an fnmatch pattern (``fs.*.impl``) when one is dynamic;
* a function whose conf read keys off its own parameter is resolved at
  each of its call sites instead.

A site none of these resolve lands in ``ConfScan.unresolved``; the
shipped tree keeps that list empty. A key read on a receiver without
"conf" in its name is not seen: keep conf objects named so.
"""

from __future__ import annotations

import ast
import difflib
import os
import re
from fnmatch import fnmatchcase
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from hadoop_tpu_torch.analysis.core import (Project, SourceModule,
                                            attr_chain, load_project)

# getter method -> the type the registry records for the key
GETTER_TYPES = {
    "get": "str", "get_trimmed": "str", "get_int": "int",
    "get_bool": "bool", "get_float": "float", "get_size_bytes": "size",
    "get_time_seconds": "time", "get_list": "list",
}

ABSENT = "<absent>"      # the site passes no default argument
DYNAMIC = "<dynamic>"    # default computed at runtime, not a literal

PACKAGE = "hadoop_tpu_torch"
REGISTRY_REL = f"{PACKAGE}/conf/registry.py"
README_REL = "README.md"
COMMAND = "python -m hadoop_tpu_torch.analysis"
README_BEGIN = ("<!-- torch-conf-registry:begin — generated by "
                f"`{COMMAND} --write-conf-registry`; do not edit -->")
README_END = "<!-- torch-conf-registry:end -->"
# hand-written conf-key tables opt into stale-doc checking with these
DOC_BEGIN = "<!-- conf-keys:begin -->"
DOC_END = "<!-- conf-keys:end -->"

_MAX_EXPAND = 64         # cross-product cap for f-string/IfExp expansion
_KEY_RE = re.compile(r"^[A-Za-z0-9_*][A-Za-z0-9_.\-*]*$")

_NO = object()           # "did not fold" sentinel


class ConfRead:
    """One resolved conf read: key (or fnmatch pattern) at a site."""

    __slots__ = ("key", "is_pattern", "getter", "rtype", "defaults",
                 "rel", "line", "via")

    def __init__(self, key: str, is_pattern: bool, getter: str,
                 defaults: Tuple[str, ...], rel: str, line: int,
                 via: Optional[str] = None):
        self.key = key
        self.is_pattern = is_pattern
        self.getter = getter
        self.rtype = GETTER_TYPES[getter]
        self.defaults = defaults      # reprs, or (ABSENT,) / (DYNAMIC,)
        self.rel = rel
        self.line = line
        self.via = via                # helper function name, if threaded

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<ConfRead {self.key} {self.getter} d={self.defaults} "
                f"@{self.rel}:{self.line}>")


class ConfScan:
    """Scan result: every resolved read plus the sites that were not."""

    def __init__(self):
        self.reads: List[ConfRead] = []
        # (rel, line, getter, reason) — empty on the shipped tree
        self.unresolved: List[Tuple[str, int, str, str]] = []
        self.helpers: Set[str] = set()


# ------------------------------------------------------- constant folding

def _fold(node: ast.AST):
    """Structural constant fold; returns the value or ``_NO``."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _fold(node.operand)
        return -v if isinstance(v, (int, float)) else _NO
    if isinstance(node, ast.BinOp):
        l, r = _fold(node.left), _fold(node.right)
        if l is _NO or r is _NO:
            return _NO
        try:
            if isinstance(node.op, ast.Add):
                return l + r
            if isinstance(node.op, ast.Sub):
                return l - r
            if isinstance(node.op, ast.Mult):
                return l * r
            if isinstance(node.op, ast.Div):
                return l / r
            if isinstance(node.op, ast.FloorDiv):
                return l // r
            if isinstance(node.op, ast.LShift):
                return l << r
            if isinstance(node.op, ast.Pow):
                return l ** r
        except (TypeError, ValueError, ZeroDivisionError):
            return _NO
        return _NO
    if isinstance(node, (ast.Tuple, ast.List)):
        elts = [_fold(e) for e in node.elts]
        if any(e is _NO for e in elts):
            return _NO
        return tuple(elts)
    return _NO


# -------------------------------------------------------- module indexing

class _ModuleIndex:
    """Per-module name tables the resolver reads: assigned constants at
    module and class scope (stored as NODES, folded lazily so constant
    chains like ``K2 = K1 + ".x"`` resolve), and the import map."""

    def __init__(self, mod: SourceModule):
        self.mod = mod
        self.consts: Dict[str, ast.AST] = {}
        self.class_consts: Dict[Tuple[str, str], ast.AST] = {}
        self.class_names: Set[str] = set()
        self.class_bases: Dict[str, List[str]] = {}
        # local name -> (source module dotted, original name | None)
        self.imports: Dict[str, Tuple[str, Optional[str]]] = {}
        for node in mod.tree.body:
            self._collect(node, cls=None)

    def _collect(self, node: ast.AST, cls: Optional[str]) -> None:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            self._store(node.targets[0].id, node.value, cls)
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Name):
            self._store(node.target.id, node.value, cls)
        elif isinstance(node, ast.ClassDef) and cls is None:
            self.class_names.add(node.name)
            self.class_bases[node.name] = [
                ".".join(c) for c in
                (attr_chain(b) for b in node.bases) if c]
            for sub in node.body:
                self._collect(sub, cls=node.name)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and cls is None:
            for a in node.names:
                if a.name != "*":
                    self.imports[a.asname or a.name] = (node.module, a.name)
        elif isinstance(node, ast.Import) and cls is None:
            for a in node.names:
                if a.asname:
                    self.imports[a.asname] = (a.name, None)
                else:
                    head = a.name.split(".")[0]
                    self.imports.setdefault(head, (head, None))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Function-scoped imports (the tree's lazy-import idiom) bind
            # the same symbols; record them as module-wide fallbacks so
            # ``from ..keys import K`` inside a method still resolves.
            # Top-level imports use direct assignment above and win.
            for sub in ast.walk(node):
                if isinstance(sub, ast.ImportFrom) and sub.module and \
                        sub.level == 0:
                    for a in sub.names:
                        if a.name != "*":
                            self.imports.setdefault(
                                a.asname or a.name, (sub.module, a.name))
                elif isinstance(sub, ast.Import):
                    for a in sub.names:
                        if a.asname:
                            self.imports.setdefault(a.asname, (a.name, None))
                        else:
                            head = a.name.split(".")[0]
                            self.imports.setdefault(head, (head, None))

    def _store(self, name: str, value: ast.AST, cls: Optional[str]) -> None:
        if cls is None:
            self.consts[name] = value
        else:
            self.class_consts[(cls, name)] = value


# ------------------------------------------------------------- resolution

class _Resolver:
    """Resolves expressions to constant value sets within one module,
    chasing imports into sibling modules through the project."""

    def __init__(self, index: _ModuleIndex,
                 by_dotted: Dict[str, "_ModuleIndex"]):
        self.idx = index
        self.by_dotted = by_dotted
        # per-function caches
        self._loops: Dict[int, Dict[str, Tuple[int, List[Any]]]] = {}
        self._locals: Dict[int, Dict[str, Optional[ast.AST]]] = {}
        self._inflight: Set[Tuple[int, str]] = set()

    # -- public ----------------------------------------------------------

    def values(self, expr: ast.AST, func: Optional[ast.AST],
               cls: Optional[str], depth: int = 0) -> Optional[List[Any]]:
        if depth > 10:
            return None
        v = _fold(expr)
        if v is not _NO:
            return [v]
        if isinstance(expr, ast.Name):
            return self._name_values(expr.id, func, cls, depth)
        if isinstance(expr, ast.Attribute):
            chain = attr_chain(expr)
            return self._attr_values(chain, cls, depth) if chain else None
        if isinstance(expr, ast.IfExp):
            a = self.values(expr.body, func, cls, depth + 1)
            b = self.values(expr.orelse, func, cls, depth + 1)
            if a is not None and b is not None and \
                    len(a) + len(b) <= _MAX_EXPAND:
                return a + b
            return None
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
            l = self.values(expr.left, func, cls, depth + 1)
            r = self.values(expr.right, func, cls, depth + 1)
            if l is None or r is None or len(l) * len(r) > _MAX_EXPAND:
                return None
            try:
                return [a + b for a in l for b in r]
            except TypeError:
                return None
        return None

    def key_of(self, expr: ast.AST, func: Optional[ast.AST],
               cls: Optional[str]
               ) -> Tuple[Optional[List[str]], Optional[str]]:
        """(concrete keys, None) | (None, fnmatch pattern) | (None, None).

        Piecewise strings (f-strings, ``+`` chains) expand when every
        hole resolves and degrade to a ``*`` pattern when one does not.
        """
        vals = self.values(expr, func, cls)
        if vals is not None:
            strs = sorted({v for v in vals if isinstance(v, str)})
            return (strs, None) if strs else (None, None)
        parts = self._string_parts(expr, func, cls)
        if parts is None:
            return (None, None)
        if all(p is not None for p in parts):
            total = 1
            for p in parts:
                total *= len(p)
            if total <= _MAX_EXPAND:
                keys = [""]
                for p in parts:
                    keys = [k + s for k in keys for s in p]
                return (sorted(set(keys)), None)
        pat = "".join(p[0] if (p is not None and len(p) == 1) else "*"
                      for p in parts)
        pat = re.sub(r"\*+", "*", pat)
        if "." not in pat or pat == "*" or not _KEY_RE.match(pat):
            return (None, None)
        return (None, pat)

    # -- piecewise strings ----------------------------------------------

    def _string_parts(self, expr: ast.AST, func, cls
                      ) -> Optional[List[Optional[List[str]]]]:
        """Flatten an f-string / ``+`` chain into resolved-or-None parts."""
        if isinstance(expr, ast.JoinedStr):
            out: List[Optional[List[str]]] = []
            for p in expr.values:
                if isinstance(p, ast.Constant):
                    out.append([str(p.value)])
                elif isinstance(p, ast.FormattedValue):
                    v = self.values(p.value, func, cls)
                    if v is not None and all(
                            isinstance(x, (str, int, float)) for x in v):
                        out.append(sorted({str(x) for x in v}))
                    else:
                        out.append(None)
                else:
                    out.append(None)
            return out
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
            l = self._string_parts(expr.left, func, cls)
            r = self._string_parts(expr.right, func, cls)
            if l is None or r is None:
                return None
            return l + r
        v = self.values(expr, func, cls)
        if v is not None and all(isinstance(x, str) for x in v):
            return [sorted(set(v))]
        if isinstance(expr, ast.Name):
            # chase ``impl_key = f"fs.{scheme}.impl"`` style indirection
            bound = self._name_binding(expr.id, func, cls)
            if bound is not None:
                node, nres, nfunc, ncls = bound
                tag = (id(nfunc) if nfunc is not None else id(nres.idx),
                       expr.id)
                if tag not in self._inflight:
                    self._inflight.add(tag)
                    try:
                        return nres._string_parts(node, nfunc, ncls)
                    finally:
                        self._inflight.discard(tag)
            return [None]        # a hole — becomes '*'
        if isinstance(expr, (ast.Attribute, ast.Call)):
            return [None]
        return None

    def _name_binding(self, name: str, func, cls):
        """(node, owning resolver, func, cls) a name is bound to, when a
        single static binding exists — used to chase string templates
        through one level of assignment."""
        if func is not None:
            node = self._local_assigns(func).get(name)
            if node is not None:
                return (node, self, func, cls)
        node = self.idx.consts.get(name)
        if node is not None:
            return (node, self, None, None)
        imp = self.idx.imports.get(name)
        if imp is not None and imp[1] is not None:
            src = self.by_dotted.get(imp[0])
            if src is not None:
                node = src.consts.get(imp[1])
                if node is not None:
                    return (node, _Resolver(src, self.by_dotted),
                            None, None)
        return None

    # -- names -----------------------------------------------------------

    def _name_values(self, name: str, func, cls, depth
                     ) -> Optional[List[Any]]:
        if func is not None:
            lb = self.loop_bindings(func, cls).get(name)
            if lb is not None:
                return list(lb[1])
            node = self._local_assigns(func).get(name)
            if node is not None:
                tag = (id(func), name)
                if tag in self._inflight:
                    return None
                self._inflight.add(tag)
                try:
                    return self.values(node, func, cls, depth + 1)
                finally:
                    self._inflight.discard(tag)
        node = self.idx.consts.get(name)
        if node is not None:
            tag = (id(self.idx), name)
            if tag in self._inflight:
                return None
            self._inflight.add(tag)
            try:
                return self.values(node, None, None, depth + 1)
            finally:
                self._inflight.discard(tag)
        imp = self.idx.imports.get(name)
        if imp is not None and imp[1] is not None:
            src = self.by_dotted.get(imp[0])
            if src is not None:
                return _Resolver(src, self.by_dotted)._name_values(
                    imp[1], None, None, depth + 1)
        return None

    def _attr_values(self, chain: List[str], cls, depth
                     ) -> Optional[List[Any]]:
        if len(chain) < 2 or len(chain) > 3:
            return None
        head, rest = chain[0], chain[1:]
        if head == "self" and cls is not None and len(rest) == 1:
            return self._class_attr(cls, rest[0], depth)
        if head in self.idx.class_names and len(rest) == 1:
            return self._class_attr(head, rest[0], depth)
        imp = self.idx.imports.get(head)
        if imp is None:
            return None
        src_dotted, orig = imp
        if orig is None:                      # import X[.Y] [as Z]
            mod_dotted = src_dotted
        else:                                 # from X import Y [as Z]
            sub = self.by_dotted.get(f"{src_dotted}.{orig}")
            if sub is not None:               # Y is a submodule
                mod_dotted = f"{src_dotted}.{orig}"
            else:                             # Y is a class in X
                src = self.by_dotted.get(src_dotted)
                if src is not None and len(rest) == 1:
                    node = src.class_consts.get((orig, rest[0]))
                    if node is not None:
                        return _Resolver(src, self.by_dotted).values(
                            node, None, None, depth + 1)
                return None
        src = self.by_dotted.get(mod_dotted)
        if src is None:
            return None
        r = _Resolver(src, self.by_dotted)
        if len(rest) == 1:
            return r._name_values(rest[0], None, None, depth + 1)
        return r._class_attr(rest[0], rest[1], depth)

    def _class_attr(self, cls_name: str, attr: str, depth: int,
                    seen: Optional[Set[Tuple[str, str]]] = None
                    ) -> Optional[List[Any]]:
        """Class-attribute constant, walking base classes (in-module and
        imported) the way runtime attribute lookup would."""
        if depth > 10:
            return None
        seen = seen if seen is not None else set()
        tag = (self.idx.mod.dotted, cls_name)
        if tag in seen:
            return None
        seen.add(tag)
        node = self.idx.class_consts.get((cls_name, attr))
        if node is not None:
            return self.values(node, None, None, depth + 1)
        for base in self.idx.class_bases.get(cls_name, []):
            head = base.split(".")[0]
            if base in self.idx.class_names:
                v = self._class_attr(base, attr, depth + 1, seen)
                if v is not None:
                    return v
                continue
            imp = self.idx.imports.get(head)
            if imp is None:
                continue
            src_dotted, orig = imp
            if "." not in base and orig is not None:
                src = self.by_dotted.get(src_dotted)
                base_cls = orig
            else:
                mod_dotted = src_dotted if orig is None \
                    else f"{src_dotted}.{orig}"
                mod_dotted = ".".join([mod_dotted] + base.split(".")[1:-1])
                src = self.by_dotted.get(mod_dotted)
                base_cls = base.split(".")[-1]
            if src is not None:
                v = _Resolver(src, self.by_dotted)._class_attr(
                    base_cls, attr, depth + 1, seen)
                if v is not None:
                    return v
        return None

    # -- bounded loops ----------------------------------------------------

    def loop_bindings(self, func: ast.AST, cls
                      ) -> Dict[str, Tuple[int, List[Any]]]:
        """name -> (group id, values) for names bound by iterating a
        literal container. Tuple targets bind positionwise and share a
        group id so key/default columns stay paired."""
        cached = self._loops.get(id(func))
        if cached is not None:
            return cached
        out: Dict[str, Tuple[int, List[Any]]] = {}
        gid = 0

        def bind(target: ast.AST, rows: List[Any], group: int) -> None:
            if isinstance(target, ast.Name):
                if all(not isinstance(x, (tuple, list)) for x in rows):
                    out[target.id] = (group, list(rows))
            elif isinstance(target, (ast.Tuple, ast.List)):
                for j, t in enumerate(target.elts):
                    if isinstance(t, ast.Name) and all(
                            isinstance(x, (tuple, list)) and len(x) > j
                            for x in rows):
                        out[t.id] = (group, [x[j] for x in rows])

        pairs: List[Tuple[ast.AST, ast.AST]] = []
        for node in ast.walk(func):
            if isinstance(node, ast.For):
                pairs.append((node.target, node.iter))
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                pairs.extend((g.target, g.iter) for g in node.generators)
        for target, it in pairs:
            container: Optional[List[Any]] = None
            if isinstance(it, ast.Set):
                v = _fold(ast.Tuple(elts=list(it.elts), ctx=ast.Load()))
                container = sorted(v, key=repr) if v is not _NO else None
            else:
                # module/class scope only: a local literal would recurse
                v = self.values(it, None, cls)
                if v is not None and len(v) == 1 and \
                        isinstance(v[0], (tuple, list)):
                    container = list(v[0])
            if container:
                gid += 1
                bind(target, container, gid)
        self._loops[id(func)] = out
        return out

    def _local_assigns(self, func: ast.AST) -> Dict[str, Optional[ast.AST]]:
        """Single-assignment locals; reassigned/for-bound/param names are
        poisoned (None) and never resolve."""
        cached = self._locals.get(id(func))
        if cached is not None:
            return cached
        assigns: Dict[str, Optional[ast.AST]] = {}
        dirty: Set[str] = set()
        fargs = getattr(func, "args", None)
        if fargs is not None:
            for a in (fargs.posonlyargs + fargs.args + fargs.kwonlyargs):
                dirty.add(a.arg)
            if fargs.vararg:
                dirty.add(fargs.vararg.arg)
            if fargs.kwarg:
                dirty.add(fargs.kwarg.arg)

        def poison(t: ast.AST) -> None:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    dirty.add(n.id)

        for node in ast.walk(func):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                if name in assigns:
                    dirty.add(name)
                assigns[name] = node.value
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    poison(t)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                poison(node.target)
            elif isinstance(node, ast.For):
                poison(node.target)
            elif isinstance(node, ast.With):
                for item in node.items:
                    if item.optional_vars is not None:
                        poison(item.optional_vars)
            elif isinstance(node, ast.NamedExpr):
                poison(node.target)
        out = {k: (None if k in dirty else v) for k, v in assigns.items()}
        out = {k: v for k, v in out.items() if v is not None}
        self._locals[id(func)] = out
        return out


# ----------------------------------------------------------- the scanner

def _call_sites(tree: ast.AST):
    """Yield (call, enclosing function, enclosing class name)."""
    out: List[Tuple[ast.Call, Optional[ast.AST], Optional[str]]] = []

    def rec(node: ast.AST, func, cls) -> None:
        for child in ast.iter_child_nodes(node):
            f2, c2 = func, cls
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                f2 = child
            elif isinstance(child, ast.ClassDef):
                c2 = child.name
            if isinstance(child, ast.Call):
                out.append((child, func, cls))
            rec(child, f2, c2)

    rec(tree, None, None)
    return out


def _is_conf_receiver(recv: List[str]) -> bool:
    """The receiver chain names a Configuration: any segment carrying a
    'conf' substring (conf, jconf, self.conf, self.config, ctx.conf)."""
    return any("conf" in p.lower() for p in recv)


def _param_names(func: ast.AST) -> List[str]:
    a = func.args
    return [x.arg for x in (a.posonlyargs + a.args)]


class _Helper:
    """A function whose conf read keys off its own parameter — resolved
    at call sites instead of at the read."""

    __slots__ = ("name", "mod", "func", "cls", "key_param", "getter",
                 "default_node", "default_param", "line")

    def __init__(self, name, mod, func, cls, key_param, getter,
                 default_node, default_param, line):
        self.name = name
        self.mod = mod
        self.func = func
        self.cls = cls
        self.key_param = key_param
        self.getter = getter
        self.default_node = default_node      # ast node or None (absent)
        self.default_param = default_param    # param name, if default is one
        self.line = line


def _sig_default(func: ast.AST, param: str) -> Optional[ast.AST]:
    """The signature default node for ``param``, when it has one."""
    a = func.args
    pos = a.posonlyargs + a.args
    n_def = len(a.defaults)
    for i, arg in enumerate(pos):
        if arg.arg == param:
            j = i - (len(pos) - n_def)
            return a.defaults[j] if j >= 0 else None
    for i, arg in enumerate(a.kwonlyargs):
        if arg.arg == param:
            return a.kw_defaults[i]
    return None


def _defaults_repr(vals: Optional[List[Any]]) -> Tuple[str, ...]:
    if vals is None:
        return (DYNAMIC,)
    return tuple(sorted({repr(v) for v in vals}))


def scan_project(project: Project) -> ConfScan:
    """Resolve every conf read in ``project``."""
    indexes = {m.dotted: _ModuleIndex(m) for m in project.modules}
    resolvers = {m.dotted: _Resolver(indexes[m.dotted], indexes)
                 for m in project.modules}
    scan = ConfScan()

    # pass 1: direct sites; collect helper candidates
    helpers: Dict[str, Optional[_Helper]] = {}   # None = ambiguous
    sites_by_mod = {m.dotted: _call_sites(m.tree) for m in project.modules}
    deferred: List[Tuple[SourceModule, ast.Call, str, Any, Any]] = []

    for mod in project.modules:
        res = resolvers[mod.dotted]
        for call, func, cls in sites_by_mod[mod.dotted]:
            chain = attr_chain(call.func)
            if not chain or len(chain) < 2:
                continue
            getter = chain[-1]
            if getter not in GETTER_TYPES or \
                    not _is_conf_receiver(chain[:-1]):
                continue
            if not call.args:
                scan.unresolved.append((mod.rel, call.lineno, getter,
                                        "no positional key argument"))
                continue
            key_expr = call.args[0]
            default_expr = call.args[1] if len(call.args) > 1 else None
            if default_expr is None:
                for kw in call.keywords:
                    if kw.arg == "default":
                        default_expr = kw.value
            # helper candidate: key is one of the enclosing fn's params
            if isinstance(key_expr, ast.Name) and func is not None and \
                    key_expr.id in _param_names(func):
                dparam = default_expr.id \
                    if isinstance(default_expr, ast.Name) and \
                    default_expr.id in _param_names(func) else None
                h = _Helper(func.name, mod, func, cls, key_expr.id, getter,
                            None if dparam else default_expr, dparam,
                            call.lineno)
                helpers[func.name] = None if func.name in helpers else h
                continue
            deferred.append((mod, call, getter, key_expr, default_expr))
            _ = func, cls  # context re-derived below; keep tuple light

    # (re-walk with context kept — simpler than threading it through)
    def emit_site(mod, res, call, func, cls, getter, key_expr,
                  default_expr, via=None, caller_res=None,
                  caller_func=None, caller_cls=None):
        """Resolve one read. Key/default resolve in (res, func, cls);
        helper-threaded args resolve in the caller's context."""
        kres, kfunc, kcls = ((caller_res, caller_func, caller_cls)
                             if caller_res is not None
                             else (res, func, cls))
        keys, pattern = kres.key_of(key_expr, kfunc, kcls)
        if keys is not None:
            keys = [k for k in keys if "." in k and _KEY_RE.match(k)]
            if not keys:
                return            # dict-style .get on a conf-ish name
        elif pattern is None:
            scan.unresolved.append(
                (mod.rel, call.lineno, getter,
                 f"key expression not statically resolvable"
                 f"{' (via ' + via + ')' if via else ''}"))
            return
        if default_expr is None:
            defaults = (ABSENT,)
        else:
            defaults = _defaults_repr(
                res.values(default_expr, func, cls))
        if keys is not None and len(keys) > 1 and \
                isinstance(key_expr, ast.Name) and \
                isinstance(default_expr, ast.Name) and func is not None:
            # paired tuple-destructured loop columns: zip, don't cross
            lb = res.loop_bindings(func, cls)
            kb, db = lb.get(key_expr.id), lb.get(default_expr.id)
            if kb and db and kb[0] == db[0] and len(kb[1]) == len(db[1]):
                for k, d in zip(kb[1], db[1]):
                    if isinstance(k, str) and "." in k and \
                            _KEY_RE.match(k):
                        scan.reads.append(ConfRead(
                            k, False, getter, (repr(d),), mod.rel,
                            call.lineno, via))
                return
        if keys is not None:
            for k in keys:
                scan.reads.append(ConfRead(k, False, getter, defaults,
                                           mod.rel, call.lineno, via))
        else:
            scan.reads.append(ConfRead(pattern, True, getter, defaults,
                                       mod.rel, call.lineno, via))

    for mod in project.modules:
        res = resolvers[mod.dotted]
        ctx = {id(c): (f, k) for c, f, k in sites_by_mod[mod.dotted]}
        for m2, call, getter, key_expr, default_expr in deferred:
            if m2 is not mod:
                continue
            func, cls = ctx[id(call)]
            emit_site(mod, res, call, func, cls, getter, key_expr,
                      default_expr)

    # pass 2: helper call sites
    used: Set[str] = set()
    live = {n: h for n, h in helpers.items() if h is not None}
    for mod in project.modules:
        res = resolvers[mod.dotted]
        for call, func, cls in sites_by_mod[mod.dotted]:
            chain = attr_chain(call.func)
            if not chain or chain[-1] not in live:
                continue
            h = live[chain[-1]]
            if call is getattr(h, "_self_call", None):  # pragma: no cover
                continue
            params = _param_names(h.func)
            shift = 1 if (params and params[0] in ("self", "cls")
                          and len(chain) > 1) else 0
            arg = _call_arg(call, h.func, h.key_param, shift)
            if arg is None:
                scan.unresolved.append(
                    (mod.rel, call.lineno, h.getter,
                     f"helper {h.name}() called without key argument"))
                continue
            used.add(h.name)
            default_expr = h.default_node
            dres, dfunc, dcls = (resolvers[h.mod.dotted], h.func, h.cls)
            if h.default_param is not None:
                caller_arg = _call_arg(call, h.func, h.default_param, shift)
                if caller_arg is not None:
                    default_expr, dres, dfunc, dcls = (caller_arg, res,
                                                       func, cls)
                else:
                    default_expr = _sig_default(h.func, h.default_param)
            # key resolves in the CALLER's context; default in whichever
            # context owns its expression
            keys, pattern = res.key_of(arg, func, cls)
            defaults = ((ABSENT,) if default_expr is None else
                        _defaults_repr(dres.values(default_expr, dfunc,
                                                   dcls)))
            if keys is not None:
                for k in keys:
                    if "." in k and _KEY_RE.match(k):
                        scan.reads.append(ConfRead(
                            k, False, h.getter, defaults, mod.rel,
                            call.lineno, via=h.name))
            elif pattern is not None:
                scan.reads.append(ConfRead(pattern, True, h.getter,
                                           defaults, mod.rel, call.lineno,
                                           via=h.name))
            else:
                scan.unresolved.append(
                    (mod.rel, call.lineno, h.getter,
                     f"key argument to helper {h.name}() not statically "
                     f"resolvable"))

    for name, h in sorted(helpers.items()):
        if h is None:
            scan.unresolved.append(
                ("<project>", 0, "?",
                 f"helper name '{name}' defined more than once — "
                 f"call sites are ambiguous"))
        elif name not in used:
            scan.unresolved.append(
                (h.mod.rel, h.line, h.getter,
                 f"helper {name}() reads conf by parameter but is never "
                 f"called"))
        if h is not None:
            scan.helpers.add(name)

    scan.reads.sort(key=lambda r: (r.rel, r.line, r.key, r.getter))
    scan.unresolved.sort()
    return scan


def _call_arg(call: ast.Call, func: ast.AST, param: str,
              shift: int) -> Optional[ast.AST]:
    """The argument expression bound to ``param`` at ``call``."""
    for kw in call.keywords:
        if kw.arg == param:
            return kw.value
    pos = _param_names(func)
    try:
        i = pos.index(param) - shift
    except ValueError:
        return None
    if 0 <= i < len(call.args) and not any(
            isinstance(a, ast.Starred) for a in call.args[:i + 1]):
        return call.args[i]
    return _sig_default(func, param)


# --------------------------------------------------------- README parsing

_BACKTICK_RE = re.compile(r"`([^`]+)`")
_DOC_TOKEN_RE = re.compile(
    r"[A-Za-z*][A-Za-z0-9_*<>{},\-]*(?:\.[A-Za-z0-9_*<>{},\-]+)+")


def _expand_doc_token(tok: str) -> List[str]:
    """``fs.<scheme>.impl`` -> ``fs.*.impl``; ``a.{x,y}.z`` -> both."""
    tok = tok.split("=", 1)[0].strip().rstrip(".")
    tok = re.sub(r"<[^>]*>", "*", tok)
    outs = [tok]
    for _ in range(4):
        nxt: List[str] = []
        for t in outs:
            m = re.search(r"\{([^{}]*)\}", t)
            if m is None:
                nxt.append(t)
            else:
                for alt in m.group(1).split(","):
                    nxt.append(t[:m.start()] + alt.strip() + t[m.end():])
        if nxt == outs:
            break
        outs = nxt
        if len(outs) > _MAX_EXPAND:
            return []
    return [t for t in outs
            if "." in t and "{" not in t and _KEY_RE.match(t)]


def readme_doc_keys(text: str) -> Dict[str, Tuple[int, bool, bool]]:
    """Backticked dotted tokens in a README:
    token -> (first line, in generated appendix, in a marked doc table).
    """
    out: Dict[str, Tuple[int, bool, bool]] = {}
    in_gen = in_doc = False
    for i, line in enumerate(text.splitlines(), start=1):
        s = line.strip()
        if s.startswith(README_BEGIN.split(" ", 1)[0]) and \
                "conf-registry:begin" in s:
            in_gen = True
            continue
        if "conf-registry:end" in s:
            in_gen = False
            continue
        if "conf-keys:begin" in s:
            in_doc = True
            continue
        if "conf-keys:end" in s:
            in_doc = False
            continue
        if "`" not in line:
            continue
        for span in _BACKTICK_RE.findall(line):
            for m in _DOC_TOKEN_RE.finditer(span):
                for tok in _expand_doc_token(m.group(0)):
                    if tok not in out:
                        out[tok] = (i, in_gen, in_doc)
    return out


def doc_covers(docs, key: str) -> bool:
    """``key`` (concrete or pattern) is documented by some doc token."""
    if key in docs:
        return True
    for d in docs:
        if "*" in d and fnmatchcase(key, d):
            return True
        if "*" in key and fnmatchcase(d, key):
            return True
    return False


# --------------------------------------------------------- registry build

def build_registry(scan: ConfScan, readme_text: Optional[str] = None
                   ) -> Tuple[Dict[str, dict], Dict[str, dict]]:
    """(KEYS, PATTERNS) aggregated from a scan. ``documented`` records
    the HAND-written README (generated appendix excluded) — the bit is
    metadata about curation, not the undocumented-key gate, which counts
    the appendix too."""
    hand_docs = set()
    if readme_text is not None:
        hand_docs = {t for t, (_, gen, _d)
                     in readme_doc_keys(readme_text).items() if not gen}

    def aggregate(reads: List[ConfRead]) -> Dict[str, dict]:
        table: Dict[str, dict] = {}
        for r in reads:
            e = table.setdefault(r.key, {"types": set(), "defaults": set(),
                                         "files": set(), "sites": 0,
                                         "absent": False})
            e["types"].add(r.rtype)
            e["sites"] += 1
            e["files"].add(r.rel)
            for d in r.defaults:
                if d == ABSENT:
                    e["absent"] = True
                else:
                    e["defaults"].add(d)
        out: Dict[str, dict] = {}
        for key in sorted(table):
            e = table[key]
            defaults = tuple(sorted(e["defaults"]))
            if not defaults:
                defaults = (ABSENT,)
            out[key] = {
                "type": "|".join(sorted(e["types"])),
                "defaults": defaults,
                "namespace": key.split(".", 1)[0],
                "documented": doc_covers(hand_docs, key),
                "sites": e["sites"],
                "files": tuple(sorted(e["files"])),
            }
        return out

    concrete = [r for r in scan.reads if not r.is_pattern]
    patterned = [r for r in scan.reads if r.is_pattern]
    return aggregate(concrete), aggregate(patterned)


# ------------------------------------------------------------- rendering

_REGISTRY_HEADER = f'''"""Conf-key registry of the port — GENERATED, do not edit by hand.

Regenerate:  ``{COMMAND} --write-conf-registry``
Verify:      ``{COMMAND} --check-conf-registry``  (tier-1 gate)

Extracted by ``{PACKAGE}/analysis/confscan.py`` from every statically
resolvable ``conf.get*`` call site in ``{PACKAGE}/``. ``KEYS`` maps each
concrete key to its typed-getter type, the defaults read sites pass,
its namespace, whether the hand-written README documents it (the
generated appendices do not count), and the files that read it.
``PATTERNS`` holds dynamic key families as fnmatch globs. ``LEVERS``
(hand-maintained in ``{PACKAGE}/conf/levers.py``, re-exported here)
carries the tunable-lever annotations: type, range, acceptance guard.
"""

from {PACKAGE}.conf.levers import LEVERS  # noqa: F401  (re-export)

ABSENT = "<absent>"    # a read site passes no default
DYNAMIC = "<dynamic>"  # default computed at runtime, not a literal
'''


def render_registry_source(keys: Dict[str, dict],
                           patterns: Dict[str, dict]) -> str:
    def emit(table: Dict[str, dict]) -> List[str]:
        lines: List[str] = []
        for key in sorted(table):
            e = table[key]
            lines.append(f'    "{key}": {{')
            lines.append(f'        "type": {e["type"]!r},')
            lines.append(f'        "defaults": ({", ".join(map(repr, e["defaults"]))},),')
            lines.append(f'        "namespace": {e["namespace"]!r},')
            lines.append(f'        "documented": {e["documented"]!r}, '
                         f'"sites": {e["sites"]},')
            lines.append('        "files": (')
            for f in e["files"]:
                lines.append(f'            {f!r},')
            lines.append('        ),')
            lines.append('    },')
        return lines

    out = [_REGISTRY_HEADER, "", "KEYS = {"]
    out.extend(emit(keys))
    out.append("}")
    out.append("")
    out.append("PATTERNS = {")
    out.extend(emit(patterns))
    out.append("}")
    return "\n".join(out) + "\n"


def render_readme_table(keys: Dict[str, dict],
                        patterns: Dict[str, dict]) -> str:
    def cell_default(e: dict) -> str:
        shown = []
        for d in e["defaults"]:
            if d == ABSENT:
                shown.append("—")
            elif d == DYNAMIC:
                shown.append("computed")
            else:
                shown.append(f"`{d}`")
        return " / ".join(shown)

    rows = [f"{len(keys)} keys + {len(patterns)} dynamic key families, "
            f"extracted from every `conf.get*` site in `{PACKAGE}/` "
            f"(`{REGISTRY_REL}` is the machine-readable form; a port "
            f"door's `/ws/v1/conf` serves the live effective table).",
            "",
            "| conf key | type | default | read sites |",
            "|---|---|---|---|"]
    for key in sorted(keys):
        e = keys[key]
        rows.append(f"| `{key}` | {e['type']} | {cell_default(e)} "
                    f"| {e['sites']} |")
    for key in sorted(patterns):
        e = patterns[key]
        rows.append(f"| `{key}` (family) | {e['type']} | {cell_default(e)} "
                    f"| {e['sites']} |")
    return "\n".join(rows)


def splice_readme(text: str, table: str) -> Optional[str]:
    """Replace the marked appendix region; None when markers are absent
    or malformed."""
    b, e = text.find(README_BEGIN), text.find(README_END)
    if b < 0 or e < 0 or e < b:
        return None
    head = text[:b + len(README_BEGIN)]
    tail = text[e:]
    return f"{head}\n\n{table}\n\n{tail}"


# ------------------------------------------------------------- the gate

def regenerate(root: str) -> Tuple[Dict[str, str], ConfScan]:
    """{repo-relative path: expected content} for the generated
    artifacts, from a fresh scan of ``root``'s package tree."""
    pkg = os.path.join(root, PACKAGE)
    project, _errors = load_project([pkg], root=root)
    scan = scan_project(project)
    readme_path = os.path.join(root, README_REL)
    readme_text: Optional[str] = None
    if os.path.isfile(readme_path):
        with open(readme_path, "r", encoding="utf-8") as fh:
            readme_text = fh.read()
    keys, patterns = build_registry(scan, readme_text)
    out = {REGISTRY_REL: render_registry_source(keys, patterns)}
    if readme_text is not None:
        spliced = splice_readme(readme_text,
                                render_readme_table(keys, patterns))
        if spliced is not None:
            out[README_REL] = spliced
    return out, scan


def check_registry(root: str) -> Tuple[bool, List[str]]:
    """(current?, unified-diff lines). Regenerating must be a no-op."""
    expected, _scan = regenerate(root)
    diff: List[str] = []
    for rel in sorted(expected):
        path = os.path.join(root, rel)
        actual = ""
        if os.path.isfile(path):
            with open(path, "r", encoding="utf-8") as fh:
                actual = fh.read()
        if actual != expected[rel]:
            diff.extend(difflib.unified_diff(
                actual.splitlines(), expected[rel].splitlines(),
                fromfile=f"{rel} (committed)",
                tofile=f"{rel} (regenerated)", lineterm="", n=1))
    return (not diff), diff


def write_registry(root: str) -> List[str]:
    """Write the generated artifacts; returns the rels that changed."""
    expected, _scan = regenerate(root)
    changed: List[str] = []
    for rel in sorted(expected):
        path = os.path.join(root, rel)
        actual = None
        if os.path.isfile(path):
            with open(path, "r", encoding="utf-8") as fh:
                actual = fh.read()
        if actual != expected[rel]:
            with open(path, "w", encoding="utf-8") as fh:
                fh.write(expected[rel])
            changed.append(rel)
    return changed
