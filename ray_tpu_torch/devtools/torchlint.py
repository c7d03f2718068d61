"""torch-lint: device-sync rules for eager PyTorch on a card (rule family
``torch``), in place of ``ray_tpu/devtools/jaxlint.py``.

Stdlib-only AST analysis riding rtpu-lint's fingerprint/baseline/
``# rtpu-lint: disable=<rule>`` machinery (``lint.py`` runs every rule
family from one CLI). It keeps jaxlint's rule names where the hazard
exists in eager PyTorch:

  host-sync-in-hot-path
      inside a function reachable from a declared hot-path root (the
      engine's decode tick, admission and loop; the decode loop's
      construction; the train and eval steps), any of: ``.item()``,
      ``.cpu()``, ``torch.cuda.synchronize()``; ``.tolist()``,
      ``.numpy()``, ``float()``/``int()``/``bool()`` or ``np.asarray``
      on a value a device program produced; a python ``if``/``while``
      branching on such a value; a pageable host->device copy
      (``.to(<device>)``/``.cuda()`` of a host value not staged through
      ``.pin_memory()``, ``torch.tensor(..., device=)``), which
      synchronizes the stream. The engine's counted fetch (``_fetch``
      over ``_to_host``) and ``decode_loop.to_card`` are the sanctioned
      sites; the intended sync carries an inline allow-comment.
  rng-reinit-per-mesh
      ``torch.manual_seed``, ``torch.cuda.manual_seed[_all]`` or a
      ``torch.Generator`` seeded anew inside a mesh scope, in a declared
      sharded-equivalence module: each rank then draws its own values,
      and "sharded == unsharded" compares different draws.

jaxlint's other four rules (closure-captured-array-into-jit,
donation-then-read, unclamped-dynamic-update-slice, pallas-shape-rules)
name hazards eager PyTorch lacks and are not carried.
``lint_source(source, module, path)`` returns ``lint.Finding`` rows;
module-scoped tables live in ``invariants.py``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ray_tpu_torch.devtools import invariants as inv
# TORCH_RULES is single-sourced in lint.py (the family/baseline machinery
# keys on it); aliased here so rule code and rule registry can't drift.
from ray_tpu_torch.devtools.lint import (Finding, TORCH_RULES as RULES,
                                         _dotted, suppressed)


def _snippet(node: ast.AST, limit: int = 48) -> str:
    try:
        text = ast.unparse(node)
    except Exception:  # noqa: BLE001 — diagnostics only
        text = "<expr>"
    return text if len(text) <= limit else text[: limit - 3] + "..."


def _tail(node: ast.AST) -> str:
    return (_dotted(node) or "").rsplit(".", 1)[-1]


def _callee(func: ast.AST) -> str:
    """The called name: an attribute call's attribute whatever its
    receiver (``torch.Generator(d).manual_seed``), else the dotted tail."""
    return func.attr if isinstance(func, ast.Attribute) else _tail(func)


def _refs_name(expr: ast.AST, names: Set[str]) -> Optional[str]:
    """First dotted read in ``expr`` matching ``names`` (a device-value
    set). Subtrees under a host-fetch call are excluded: the fetch IS
    the sanctioned sync, its result is host data."""
    todo = [expr]
    while todo:
        sub = todo.pop()
        if isinstance(sub, ast.Call) and \
                _tail(sub.func) in inv.HOST_FETCH_SUFFIXES:
            continue  # do not descend into the fetch's operands
        if isinstance(sub, (ast.Attribute, ast.Name)):
            d = _dotted(sub)
            if d is not None:
                for n in names:
                    if d == n or d.startswith(n + "."):
                        return n
        todo.extend(ast.iter_child_nodes(sub))
    return None


def _names_device(arg: ast.AST) -> bool:
    """Does a ``.to(...)``/``device=`` argument name a card?"""
    if isinstance(arg, ast.Constant):
        return isinstance(arg.value, str) and \
            arg.value.startswith(inv.DEVICE_ARG_PREFIXES)
    if isinstance(arg, ast.Call):
        return (_dotted(arg.func) or "") == "torch.device" and \
            bool(arg.args) and _names_device(arg.args[0])
    leaf = _tail(arg)
    return bool(leaf) and bool(inv.DEVICE_ARG_NAME_RE.search(leaf))


def _pinned(receiver: ast.AST) -> bool:
    """Is the copied value staged through ``.pin_memory()``?"""
    return isinstance(receiver, ast.Call) and \
        isinstance(receiver.func, ast.Attribute) and \
        receiver.func.attr == inv.PINNED_STAGE_ATTR


class _TorchLinter:
    def __init__(self, module: str, path: str, source: str,
                 package: str = inv.PACKAGE):
        self.module = inv.module_key(module, package)
        self.path = path
        self.lines = source.splitlines()
        self.findings: List[Finding] = []
        self._scope_names: List[str] = []
        self._functions: Dict[str, List[ast.AST]] = {}

    # ------------------------------------------------------------ utils

    def _emit(self, rule: str, node: ast.AST, message: str,
              scope: Optional[str] = None) -> None:
        # A typoed rule id would be filed under the WRONG family by the
        # baseline writer (RULE_FAMILY defaults to concurrency) and
        # become invisible to --family torch — fail at the source.
        assert rule in RULES, f"unregistered torch rule id {rule!r}"
        line = getattr(node, "lineno", 1)
        if suppressed(self.lines, line, rule):
            return
        self.findings.append(Finding(
            rule, self.path, line,
            scope if scope is not None else ".".join(self._scope_names),
            message))

    # ------------------------------------------------------------- walk

    def run(self, tree: Optional[ast.AST] = None) -> List[Finding]:
        if tree is None:
            try:
                tree = ast.parse("\n".join(self.lines),
                                 filename=self.path)
            except SyntaxError:
                return []  # the concurrency family reports this
        self._walk(tree, mesh_depth=0)
        if self.module in inv.HOT_PATH_ROOTS:
            self._check_hot_paths()
        return self.findings

    def _walk(self, node: ast.AST, mesh_depth: int) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                if not isinstance(child, ast.ClassDef):
                    self._functions.setdefault(child.name,
                                               []).append(child)
                self._scope_names.append(child.name)
                self._walk(child, mesh_depth)
                self._scope_names.pop()
                continue
            if isinstance(child, (ast.With, ast.AsyncWith)):
                d = 0
                for item in child.items:
                    text = _snippet(item.context_expr, 200).lower()
                    if any(m in text for m in inv.MESH_CONTEXT_MARKERS):
                        d = 1
                self._walk(child, mesh_depth + d)
                continue
            if isinstance(child, ast.Call):
                self._check_rng(child, mesh_depth)
            self._walk(child, mesh_depth)

    def _check_rng(self, node: ast.Call, mesh_depth: int) -> None:
        if (mesh_depth > 0
                and _callee(node.func) in inv.RNG_REINIT_SUFFIXES
                and self.module in inv.RNG_SINGLE_INIT_MODULES):
            self._emit(
                "rng-reinit-per-mesh", node,
                f"{_snippet(node.func)}() seeds a generator anew inside "
                "a mesh scope — sharded-equivalence paths must seed ONE "
                "host init and place it (each rank draws its own values "
                "otherwise)")

    # ------------------------------------------------------ hot paths

    def _check_hot_paths(self) -> None:
        roots = inv.HOT_PATH_ROOTS[self.module]
        # Intra-module call graph over bare function/method names.
        edges: Dict[str, Set[str]] = {}
        for name, fns in self._functions.items():
            outs: Set[str] = set()
            for fn in fns:
                for sub in ast.walk(fn):
                    if isinstance(sub, ast.Call):
                        t = _tail(sub.func)
                        if t in self._functions and t != name:
                            outs.add(t)
            edges[name] = outs
        hot: Set[str] = set()
        todo = [r for r in roots if r in self._functions]
        while todo:
            cur = todo.pop()
            if cur in hot:
                continue
            hot.add(cur)
            todo.extend(edges.get(cur, ()))
        for name in sorted(hot):
            for fn in self._functions[name]:
                self._check_hot_fn(fn, name)

    def _check_hot_fn(self, fn, name: str) -> None:
        device: Set[str] = set()

        def producer_call(expr: ast.AST) -> Optional[str]:
            """'device' / 'host' / None for the calls inside expr."""
            found = None
            for sub in ast.walk(expr):
                if not isinstance(sub, ast.Call):
                    continue
                t = _tail(sub.func)
                if t in inv.HOST_FETCH_SUFFIXES:
                    return "host"
                if t in inv.DEVICE_PRODUCER_SUFFIXES:
                    found = "device"
            return found

        def flag(node, what: str) -> None:
            self._emit(
                "host-sync-in-hot-path", node,
                f"{what} in hot-path function '{name}' — the decode/"
                "train hot path syncs the host AT MOST once per chunk "
                "through its counted fetch; route through it (or "
                "to_card for a host->device copy) or allow-comment the "
                "intended sync", scope=name)

        def check_copy(node: ast.Call) -> None:
            d = _dotted(node.func) or ""
            if d in inv.H2D_TENSOR_FACTORIES:
                dev = [kw.value for kw in node.keywords
                       if kw.arg == "device"]
                if dev and _names_device(dev[0]):
                    flag(node, f"pageable host->device copy {d}(..., "
                               f"device={_snippet(dev[0])})")
                return
            if not isinstance(node.func, ast.Attribute):
                return
            attr, recv = node.func.attr, node.func.value
            if attr == "cuda":
                to_card = True
            elif attr == "to":
                to_card = any(_names_device(a) for a in node.args) or any(
                    kw.arg == "device" and _names_device(kw.value)
                    for kw in node.keywords)
            else:
                return
            if to_card and not _pinned(recv) and \
                    _refs_name(recv, device) is None:
                flag(node, f"pageable host->device copy "
                           f"{_snippet(node.func)}()")

        def scan(node: ast.AST) -> None:
            """Dispatch on the node ITSELF, then recurse — statements
            are checked wherever they sit, not only as direct children
            of the body."""
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                return
            if isinstance(node, ast.Assign):
                scan(node.value)
                verdict = producer_call(node.value)
                if verdict is None and _refs_name(node.value, device):
                    verdict = "device"
                flat: List[ast.AST] = []
                for tgt in node.targets:
                    if isinstance(tgt, (ast.Tuple, ast.List)):
                        flat.extend(tgt.elts)
                    else:
                        flat.append(tgt)
                for tgt in flat:
                    if isinstance(tgt, ast.Starred):
                        tgt = tgt.value
                    if isinstance(tgt, (ast.Name, ast.Attribute)):
                        d = _dotted(tgt)
                        if d is None:
                            continue
                        if verdict == "device":
                            device.add(d)
                        else:
                            device.discard(d)
                return
            if isinstance(node, (ast.If, ast.While)):
                ref = _refs_name(node.test, device)
                if ref is not None:
                    flag(node, f"python {type(node).__name__.lower()}"
                               f" on device value '{ref}'")
            elif isinstance(node, ast.Call):
                d = _dotted(node.func) or ""
                attr = node.func.attr \
                    if isinstance(node.func, ast.Attribute) else None
                if _callee(node.func) in inv.HOST_SYNC_ATTRS:
                    flag(node, f".{attr}()" if attr else f"{d}()")
                elif attr in inv.DEVICE_SYNC_ATTRS:
                    ref = _refs_name(node.func.value, device)
                    if ref is not None:
                        flag(node, f".{attr}() on device value '{ref}'")
                elif d in inv.DEVICE_SYNC_FUNCS and node.args:
                    ref = _refs_name(node.args[0], device)
                    if ref is not None:
                        flag(node, f"{d}() on device value '{ref}'")
                else:
                    check_copy(node)
            for child in ast.iter_child_nodes(node):
                scan(child)

        for stmt in fn.body:
            scan(stmt)


def lint_source(source: str, module: str, path: str,
                tree: Optional[ast.AST] = None,
                package: str = inv.PACKAGE) -> List[Finding]:
    """Run the torch rule family over one module's source. ``tree``
    reuses a caller-side parse (lint_paths parses once per file for
    every family)."""
    return _TorchLinter(module, path, source, package).run(tree)
