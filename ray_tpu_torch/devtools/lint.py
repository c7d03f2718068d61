"""rtpu-lint for the port: AST-based invariant enforcement over
``ray_tpu_torch/`` and ``chip_smoke.py`` (``ray_tpu/devtools/lint.py``'s
static half, with its tables keyed by module paths inside the package).

Stdlib-only; it imports neither torch nor anything of the runtime, so it
runs on the CPU and needs no card. Run as
``python -m ray_tpu_torch.devtools.lint [--family X] [--stats]
[--write-baseline]`` (from the repo root or anywhere: the default scan
roots resolve relative to the installed package). Rules live in
``invariants.py``; each finding carries a rule id:

  lock-order            nested acquisition violating a declared chain,
                        or two locks from a never-nested group held
                        together
  blocking-under-lock   socket recv*/sendmsg, subprocess, pipe reads,
                        or a long time.sleep inside a ``with <lock>``
                        body (I/O-serialization locks exempt)
  close-without-shutdown  socket .close() with no earlier shutdown in
                        the same function (recv_into-sink modules only)
  banned-api            jax<0.5-breaking calls/imports; dashboard
                        innerHTML/document.write in JS strings
  swallowed-exception   broad except that neither raises, logs, nor
                        uses the bound exception
  daemon-no-join        a daemon Thread stored on self but never
                        joined by any method of the class
  retry-without-deadline  a ``while True:`` retry loop around
                        retrying_call / socket connect with no visible
                        deadline, attempt counter, or stop-event check
  span-not-closed       a ``tracing.trace/span/remote_span(...)`` call
                        not used as a context manager — the span never
                        ends and its ContextVar parentage leaks onto
                        every later span in the thread

A second rule family, ``torch`` (``torchlint.py``, in place of
``ray_tpu``'s ``jax``), flags device syncs on the hot path
(host-sync-in-hot-path) and generators seeded anew in a mesh scope
(rng-reinit-per-mesh). A third, ``dist`` (``distlint.py``), enforces the
distributed RPC contract against the port's ``cluster/protocol.py``; a
fourth, ``res`` (``reslint.py``), resource lifetimes; a fifth, ``chan``
(``chanlint.py``), the channel protocol of the compiled-DAG data plane.
``--family {all,concurrency,torch,dist,res,chan}`` selects which
families run (default: all).

Baseline workflow: legacy findings live in ``lint_baseline.json``,
sectioned per rule family with a per-family schema version
(fingerprint -> count). A run fails (exit 1) only when a fingerprint's
current count exceeds its baselined count — new violations fail, old
ones are tracked. Update after an intentional change with
``--write-baseline`` (``--family X --write-baseline`` rewrites ONLY
that family's section, never touching the other families' entries).
Suppress a single line with ``# rtpu-lint: disable=<rule-id>``.
"""

from __future__ import annotations

import argparse
import ast
import hashlib
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.devtools import invariants as inv

_HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_BASELINE = os.path.join(_HERE, "lint_baseline.json")

RULES = (
    "lock-order", "blocking-under-lock", "close-without-shutdown",
    "banned-api", "swallowed-exception", "daemon-no-join",
    "retry-without-deadline", "span-not-closed",
)

#: Rule families: "concurrency" = the tables above (the original
#: rtpu-lint rule set), "torch" = the device-sync family in
#: ``torchlint.py``, "dist" / "res" / "chan" as in ``ray_tpu``. Each
#: family versions its fingerprinting scheme independently
#: (FAMILY_SCHEMA) so a rule rewrite in one family never invalidates the
#: others' baseline sections.
TORCH_RULES = ("host-sync-in-hot-path", "rng-reinit-per-mesh")
DIST_RULES = (
    "unclassified-rpc-handler", "retry-unsafe-call",
    "direct-notify-bypasses-outbox", "serial-fanout-no-deadline",
    "wall-clock-deadline", "missing-chaos-role",
    "retry-unsafe-block-rpc",
)
RES_RULES = (
    "acquire-without-release", "begin-without-commit",
    "unbounded-registry-growth", "thread-without-stop",
    "fd-leak-on-error",
)
CHAN_RULES = (
    "chan-cursor-publish-order", "chan-spill-pin-unreleased",
    "chan-ack-before-consume", "chan-raw-seq-send",
    "chan-register-without-unregister", "chan-dial-without-liveness",
    "chan-blocking-op-no-deadline", "chan-mutate-after-send",
)
FAMILIES = ("concurrency", "torch", "dist", "res", "chan")
#: The families whose rules and tables are ray_tpu's: the port's run
#: over ray_tpu's tree gives ray_tpu's own findings.
SHARED_FAMILIES = ("concurrency", "dist", "res", "chan")
FAMILY_RULES = {"concurrency": RULES, "torch": TORCH_RULES,
                "dist": DIST_RULES, "res": RES_RULES,
                "chan": CHAN_RULES}
FAMILY_SCHEMA = {"concurrency": 1, "torch": 1, "dist": 1, "res": 1,
                 "chan": 1}
RULE_FAMILY = {rule: fam for fam, rules in FAMILY_RULES.items()
               for rule in rules}


class Finding:
    __slots__ = ("rule", "path", "line", "scope", "message")

    def __init__(self, rule: str, path: str, line: int, scope: str,
                 message: str):
        self.rule = rule
        self.path = path
        self.line = line
        self.scope = scope
        self.message = message

    def fingerprint(self) -> str:
        # Line numbers drift with every edit: the fingerprint hashes the
        # rule + file + enclosing scope + message so baselined findings
        # survive unrelated churn. Duplicates within one scope share a
        # fingerprint and are baselined by COUNT.
        raw = "|".join((self.rule, self.path, self.scope, self.message))
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.message}"
                f"  (in {self.scope or '<module>'})")


def suppressed(lines: List[str], line: int, rule: str) -> bool:
    """Is ``rule`` disabled on source ``line`` by an inline
    ``# rtpu-lint: disable=<rule>[,<rule>...]`` comment? The ONE
    implementation of the suppression protocol — both rule families
    route through it."""
    if not 1 <= line <= len(lines):
        return False
    text = lines[line - 1]
    tok = inv.SUPPRESS_TOKEN
    if tok in text:
        parts = text.split(tok, 1)[1].split()
        if parts and rule in parts[0].split(","):
            return True
    return False


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _lock_name(expr: ast.AST) -> Optional[str]:
    """The lock's short name if ``expr`` looks like a lock (self._lock,
    module_lock, conn.send_lock ...)."""
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    else:
        return None
    if inv.LOCK_NAME_RE.search(name):
        return name
    return None


class _FileLinter(ast.NodeVisitor):
    def __init__(self, module: str, path: str, source: str,
                 package: str = inv.PACKAGE):
        self.module = inv.module_key(module, package)
        self.path = path
        self.lines = source.splitlines()
        self.findings: List[Finding] = []
        self._scope: List[str] = []
        self._held: List[str] = []  # with-lock stack (short names)
        self._order = inv.LOCK_ORDER.get(self.module, ())
        self._never = inv.NEVER_NESTED.get(self.module, ())
        self._io_locks = inv.IO_LOCKS.get(self.module, set())
        self._is_dashboard = self.module in inv.DASHBOARD_MODULES
        self._check_sockets = self.module in inv.SOCKET_SHUTDOWN_MODULES
        self._js_counts: Dict[str, int] = {}

    # ------------------------------------------------------------ utils

    def _suppressed(self, line: int, rule: str) -> bool:
        if suppressed(self.lines, line, rule):
            return True
        if rule == "swallowed-exception" and \
                1 <= line <= len(self.lines) and \
                inv.NOQA_BROAD_EXCEPT in self.lines[line - 1]:
            return True
        return False

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 1)
        if self._suppressed(line, rule):
            return
        self.findings.append(Finding(rule, self.path, line,
                                     ".".join(self._scope), message))

    # ------------------------------------------------------------ scope

    def visit_FunctionDef(self, node):
        self._scope.append(node.name)
        if self._check_sockets:
            self._check_close_without_shutdown(node)
        self._check_span_not_closed(node)
        # A nested def's body runs LATER, on whatever thread calls it —
        # not under the with-locks lexically enclosing the def. Clear
        # the held stack for its body so closures defined inside a lock
        # block aren't falsely flagged (and restore for the remainder
        # of the enclosing block).
        held, self._held = self._held, []
        self.generic_visit(node)
        self._held = held
        self._scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self._scope.append(node.name)
        self._check_daemon_threads(node)
        self.generic_visit(node)
        self._scope.pop()

    # -------------------------------------------------- socket shutdown

    def _check_close_without_shutdown(self, fn) -> None:
        """Within one function: ``x.close()`` on a socket-looking name
        with no earlier ``x.shutdown(...)`` / ``_shutdown_socket(x)``.
        A bare close() frees the fd without waking a thread blocked in
        recv on it — which then keeps writing into freed shm."""
        events = []  # (lineno, col, kind, varname)
        # Walk THIS function only: nested defs get their own visit (a
        # shared walk would double-report every close() inside them).
        todo = list(ast.iter_child_nodes(fn))
        nodes = []
        while todo:
            sub = todo.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda, ast.ClassDef)):
                continue
            nodes.append(sub)
            todo.extend(ast.iter_child_nodes(sub))
        for sub in nodes:
            if not isinstance(sub, ast.Call):
                continue
            if isinstance(sub.func, ast.Attribute):
                var = _dotted(sub.func.value)
                if var is None or not inv.SOCKET_NAME_RE.search(var):
                    continue
                if sub.func.attr == "shutdown":
                    events.append((sub.lineno, sub.col_offset, "shut",
                                   var))
                elif sub.func.attr == "close":
                    events.append((sub.lineno, sub.col_offset, "close",
                                   var))
            elif isinstance(sub.func, ast.Name) and \
                    "shutdown" in sub.func.id and sub.args:
                var = _dotted(sub.args[0])
                if var is not None:
                    events.append((sub.lineno, sub.col_offset, "shut",
                                   var))
        shut = set()
        for lineno, _col, kind, var in sorted(events):
            if kind == "shut":
                shut.add(var)
            elif var not in shut:
                if not self._suppressed(lineno, "close-without-shutdown"):
                    self.findings.append(Finding(
                        "close-without-shutdown", self.path, lineno,
                        ".".join(self._scope),
                        f"{var}.close() without a prior shutdown() in "
                        f"'{fn.name}' — a reader blocked in recv stays "
                        "alive writing into freed buffers"))

    # -------------------------------------------------- unclosed spans

    @staticmethod
    def _is_span_call(call: ast.Call) -> Optional[str]:
        """'tracing.span'-style descriptor if this call constructs a
        tracing context manager, else None."""
        fn = call.func
        if isinstance(fn, ast.Attribute) and \
                fn.attr in inv.TRACING_SPAN_ATTRS:
            recv = _dotted(fn.value)
            if recv is not None and \
                    inv.TRACING_RECEIVER_RE.search(recv.split(".")[-1]):
                return f"{recv}.{fn.attr}"
        elif isinstance(fn, ast.Name) and fn.id in inv.TRACING_SPAN_NAMES:
            return fn.id
        return None

    def _check_span_not_closed(self, fn) -> None:
        """Within one function: a tracing.trace/span/remote_span call
        must be consumed as a context manager — directly as a ``with``
        item, assigned to a name that is later a ``with`` item, or
        passed to ``.enter_context(...)``. Anything else opens a span
        that never ends and leaks its ContextVar parentage onto every
        later span in the thread/task."""
        span_calls: List[Tuple[ast.Call, str]] = []
        ok_ids: set = set()  # id() of span calls consumed correctly
        with_names: set = set()
        assigned: Dict[str, List[ast.Call]] = {}
        # Walk THIS function only: nested defs get their own visit.
        todo = list(ast.iter_child_nodes(fn))
        nodes = []
        while todo:
            sub = todo.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda, ast.ClassDef)):
                continue
            nodes.append(sub)
            todo.extend(ast.iter_child_nodes(sub))
        for sub in nodes:
            if isinstance(sub, ast.Call):
                desc = self._is_span_call(sub)
                if desc is not None:
                    span_calls.append((sub, desc))
                fn_attr = sub.func
                if isinstance(fn_attr, ast.Attribute) and \
                        fn_attr.attr == "enter_context":
                    for arg in sub.args:
                        ok_ids.add(id(arg))
            elif isinstance(sub, (ast.With, ast.AsyncWith)):
                for item in sub.items:
                    ok_ids.add(id(item.context_expr))
                    if isinstance(item.context_expr, ast.Name):
                        with_names.add(item.context_expr.id)
            elif isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Name) \
                    and isinstance(sub.value, ast.Call):
                if self._is_span_call(sub.value) is not None:
                    assigned.setdefault(sub.targets[0].id,
                                        []).append(sub.value)
        for name, calls in assigned.items():
            if name in with_names:
                for c in calls:
                    ok_ids.add(id(c))
        for call, desc in span_calls:
            if id(call) in ok_ids:
                continue
            self._emit(
                "span-not-closed", call,
                f"{desc}(...) is not used as a context manager — the "
                "span never ends and its ContextVar parentage leaks "
                "onto every later span in this thread (use `with`, or "
                "stack.enter_context)")

    # ------------------------------------------------ unbounded retries

    def visit_While(self, node):
        self._check_retry_loop(node)
        self.generic_visit(node)

    def _check_retry_loop(self, node: ast.While) -> None:
        """``while True:`` around retrying_call / socket connect with no
        deadline, attempt counter, or stop-event check: under chaos
        (peer dead, frames dropped) the loop never exits. Success-path
        ``break``/``return`` do NOT bound it — the hang case is the one
        where success never comes."""
        test = node.test
        if not (isinstance(test, ast.Constant) and test.value is True
                or isinstance(test, ast.Constant) and test.value == 1):
            return
        # Walk THIS loop only; nested defs run on their own schedule.
        nodes, todo = [], list(node.body)
        while todo:
            sub = todo.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda, ast.ClassDef)):
                continue
            nodes.append(sub)
            todo.extend(ast.iter_child_nodes(sub))
        retry_call = None
        bounded = False
        for sub in nodes:
            if isinstance(sub, ast.Call):
                dotted = _dotted(sub.func) or ""
                if isinstance(sub.func, ast.Attribute):
                    attr = sub.func.attr
                    if attr in inv.RETRY_CALL_ATTRS:
                        retry_call = retry_call or f".{attr}()"
                    elif any(dotted.endswith(s)
                             for s in inv.RETRY_CONNECT_SUFFIXES):
                        retry_call = retry_call or f"{dotted}()"
                    elif attr == "connect":
                        var = _dotted(sub.func.value) or ""
                        if inv.SOCKET_NAME_RE.search(var):
                            retry_call = retry_call or f"{var}.connect()"
                    if attr in inv.RETRY_STOP_ATTRS:
                        var = _dotted(sub.func.value) or ""
                        if inv.RETRY_STOP_NAME_RE.search(var):
                            bounded = True
                if dotted in inv.RETRY_DEADLINE_CALLS:
                    bounded = True
            name = None
            if isinstance(sub, ast.Name):
                name = sub.id
            elif isinstance(sub, ast.Attribute):
                name = sub.attr
            if name is not None and \
                    inv.RETRY_DEADLINE_NAME_RE.search(name):
                bounded = True
        if retry_call is not None and not bounded:
            self._emit(
                "retry-without-deadline", node,
                f"while True loop retries {retry_call} with no "
                "deadline, attempt counter, or stop-event check — "
                "bound it (a chaos run hangs here when the peer "
                "never recovers)")

    # -------------------------------------------------------- lock rules

    def _check_lock_pair(self, node: ast.AST, new: str) -> None:
        for held in self._held:
            if held == new:
                continue
            for chain in self._order:
                if new in chain and held in chain and \
                        chain.index(new) < chain.index(held):
                    self._emit(
                        "lock-order", node,
                        f"acquires '{new}' while holding '{held}' — "
                        f"declared order is {' -> '.join(chain)}")
            for group in self._never:
                if new in group and held in group:
                    self._emit(
                        "lock-order", node,
                        f"acquires '{new}' while holding '{held}' — "
                        "these locks are declared never-nested")

    def visit_With(self, node):
        count = 0
        for item in node.items:
            self.visit(item.context_expr)
            name = _lock_name(item.context_expr)
            if name is not None:
                self._check_lock_pair(item.context_expr, name)
                self._held.append(name)
                count += 1
        for stmt in node.body:
            self.visit(stmt)
        if count:
            del self._held[-count:]

    visit_AsyncWith = visit_With

    def _held_non_io(self) -> List[str]:
        return [h for h in self._held if h not in self._io_locks]

    def visit_Call(self, node):
        dotted = _dotted(node.func)
        # .acquire() on another lock while inside a with-lock body.
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "acquire":
            name = _lock_name(node.func.value)
            if name is not None and self._held:
                self._check_lock_pair(node, name)
        # Blocking calls under a (non-IO) lock.
        held = self._held_non_io()
        if held:
            blocked = None
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in inv.BLOCKING_METHODS:
                blocked = f".{node.func.attr}()"
            elif dotted in inv.BLOCKING_FUNCS:
                blocked = f"{dotted}()"
            elif dotted == "time.sleep" and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, (int, float)) and \
                        arg.value > inv.SLEEP_UNDER_LOCK_MAX_S:
                    blocked = f"time.sleep({arg.value})"
            if blocked is not None:
                self._emit(
                    "blocking-under-lock", node,
                    f"{blocked} inside `with {held[-1]}` — blocking "
                    "I/O must not run while holding a state lock")
        # Banned jax calls.
        if dotted is not None:
            for suffix, hint in inv.BANNED_CALLS.items():
                if dotted == suffix or dotted.endswith("." + suffix):
                    self._emit("banned-api", node,
                               f"call to {dotted}: {hint}")
                    break
        self.generic_visit(node)

    # ---------------------------------------------------------- imports

    def _banned_import(self, node: ast.AST, path: str) -> None:
        entry = inv.BANNED_IMPORTS.get(path)
        if entry is None:
            return
        hint, exempt = entry
        if self.module in exempt:
            return
        self._emit("banned-api", node, f"import of {path}: {hint}")

    def visit_Import(self, node):
        for alias in node.names:
            self._banned_import(node, alias.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        self._banned_import(node, mod)
        for alias in node.names:
            self._banned_import(node, f"{mod}.{alias.name}")
        self.generic_visit(node)

    # ------------------------------------------------------- JS strings

    def visit_Constant(self, node):
        if self._is_dashboard and isinstance(node.value, str):
            for sub, hint in inv.BANNED_JS_SUBSTRINGS.items():
                start = 0
                while True:
                    idx = node.value.find(sub, start)
                    if idx < 0:
                        break
                    line = node.lineno + node.value.count("\n", 0, idx)
                    # Fingerprint by per-file occurrence INDEX, not char
                    # offset: edits elsewhere in the JS must not churn
                    # the baseline.
                    n = self._js_counts.get(sub, 0)
                    self._js_counts[sub] = n + 1
                    if not self._suppressed(line, "banned-api"):
                        self.findings.append(Finding(
                            "banned-api", self.path, line,
                            ".".join(self._scope) + f"+{sub}#{n}",
                            f"'{sub}' in dashboard JS: {hint}"))
                    start = idx + len(sub)
        self.generic_visit(node)

    # ------------------------------------------------------ bare excepts

    def visit_ExceptHandler(self, node):
        if self._broad(node.type) and not self._handled(node):
            self._emit(
                "swallowed-exception", node,
                "broad except neither raises, logs, nor uses the "
                "exception — log at debug minimum or narrow the type")
        self.generic_visit(node)

    @staticmethod
    def _broad(type_node) -> bool:
        if type_node is None:
            return True
        names = []
        if isinstance(type_node, ast.Tuple):
            names = [t for t in type_node.elts]
        else:
            names = [type_node]
        for t in names:
            n = t.id if isinstance(t, ast.Name) else (
                t.attr if isinstance(t, ast.Attribute) else "")
            if n in ("Exception", "BaseException"):
                return True
        return False

    @staticmethod
    def _handled(handler: ast.ExceptHandler) -> bool:
        bound = handler.name
        for sub in ast.walk(ast.Module(body=handler.body,
                                       type_ignores=[])):
            if isinstance(sub, ast.Raise):
                return True
            if bound and isinstance(sub, ast.Name) and sub.id == bound:
                return True  # exception object is inspected/reported
            if isinstance(sub, ast.Call):
                fn = sub.func
                n = fn.attr if isinstance(fn, ast.Attribute) else (
                    fn.id if isinstance(fn, ast.Name) else "")
                if n in inv.LOGGING_CALL_NAMES:
                    return True
        return False

    # ------------------------------------------------- daemon-thread join

    def _check_daemon_threads(self, cls: ast.ClassDef) -> None:
        daemons: List[Tuple[str, ast.AST]] = []
        joined: set = set()
        for sub in ast.walk(cls):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                tgt = sub.targets[0]
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                        and isinstance(sub.value, ast.Call)):
                    fn = _dotted(sub.value.func) or ""
                    if fn.endswith("Thread"):
                        for kw in sub.value.keywords:
                            if (kw.arg == "daemon"
                                    and isinstance(kw.value, ast.Constant)
                                    and kw.value.value is True):
                                daemons.append((tgt.attr, sub))
            if (isinstance(sub, ast.Attribute) and sub.attr == "join"
                    and isinstance(sub.value, ast.Attribute)
                    and isinstance(sub.value.value, ast.Name)
                    and sub.value.value.id == "self"):
                joined.add(sub.value.attr)
        for attr, node in daemons:
            if attr not in joined:
                self._emit(
                    "daemon-no-join", node,
                    f"daemon thread self.{attr} is never joined by any "
                    "method of this class — join it on close/shutdown "
                    "so teardown is ordered")


# --------------------------------------------------------------- driver


def lint_source(source: str, module: str, path: str,
                tree: Optional[ast.AST] = None,
                package: str = inv.PACKAGE) -> List[Finding]:
    """Lint one module's source; ``module`` (dotted, inside ``package``)
    selects the invariant tables that apply (tests inject fixture
    snippets this way). ``tree`` skips the parse when the caller already
    has one (lint_paths parses each file once for every rule family)."""
    if tree is None:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            return [Finding("banned-api", path, e.lineno or 1, "",
                            f"syntax error: {e.msg}")]
    linter = _FileLinter(module, path, source, package)
    linter.visit(tree)
    return linter.findings


def _module_for(path: str, root: str) -> str:
    rel = os.path.relpath(path, root)
    mod = rel[:-3] if rel.endswith(".py") else rel
    mod = mod.replace(os.sep, ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


def default_roots() -> Tuple[str, List[str]]:
    """(repo_root, scan paths): the installed ray_tpu_torch package plus
    the repo root's ``chip_smoke.py`` when present."""
    pkg = os.path.dirname(_HERE)          # .../ray_tpu_torch
    repo = os.path.dirname(pkg)           # the dir holding the package
    paths = [pkg]
    smoke = os.path.join(repo, "chip_smoke.py")
    if os.path.exists(smoke):
        paths.append(smoke)
    return repo, paths


def protocol_path(root: str, package: str = inv.PACKAGE) -> str:
    """The ``cluster/protocol.py`` whose classification sets the dist
    family holds ``package``'s handlers and retries to."""
    return os.path.join(root, *package.split("."), "cluster",
                        "protocol.py")


def iter_py_files(paths: List[str]):
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            for f in sorted(filenames):
                if f.endswith(".py"):
                    yield os.path.join(dirpath, f)


def lint_paths(paths: List[str], root: str,
               families: Tuple[str, ...] = FAMILIES,
               package: str = inv.PACKAGE) -> List[Finding]:
    """Every finding of ``families`` in the files under ``paths``, each
    keyed by its module path under ``root``; ``package`` names the
    package whose tables and ``cluster/protocol.py`` apply."""
    run_torch = "torch" in families
    run_conc = "concurrency" in families
    run_dist = "dist" in families
    run_res = "res" in families
    run_chan = "chan" in families
    if run_torch:
        from ray_tpu_torch.devtools import torchlint  # deferred: imports us
    if run_dist:
        from ray_tpu_torch.devtools import distlint  # deferred: ditto
    if run_res:
        from ray_tpu_torch.devtools import reslint  # deferred: ditto
    if run_chan:
        from ray_tpu_torch.devtools import chanlint  # deferred: ditto
    protocol = protocol_path(root, package)
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
        except (OSError, UnicodeDecodeError):
            continue
        rel = os.path.relpath(path, root)
        module = _module_for(path, root)
        rows: List[Finding] = []
        # ONE parse per file, shared by every family.
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError as e:
            tree = None
            # Reported whichever family runs: a torch-only run must not
            # silently skip (and exit 0 on) a file it could not check.
            rows.append(Finding("banned-api", rel, e.lineno or 1,
                                "", f"syntax error: {e.msg}"))
        if tree is not None:
            if run_conc:
                rows.extend(lint_source(source, module, rel, tree=tree,
                                        package=package))
            if run_torch:
                rows.extend(torchlint.lint_source(
                    source, module, rel, tree=tree, package=package))
            if run_dist:
                rows.extend(distlint.lint_source(
                    source, module, rel, tree=tree, package=package,
                    protocol=protocol))
            if run_res:
                rows.extend(reslint.lint_source(
                    source, module, rel, tree=tree, package=package))
            if run_chan:
                rows.extend(chanlint.lint_source(
                    source, module, rel, tree=tree, package=package))
        findings.extend(rows)  # every family already emits rel paths
    return findings


def _read_baseline_json(path: str) -> Optional[dict]:
    """The parsed baseline dict, or None when the file is missing,
    unparseable, or not a JSON object — callers must distinguish
    "nothing there" (recoverable) from "parsed fine but empty" ({})."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) else None


def load_baseline(path: str) -> Dict[str, dict]:
    """Merged fingerprint -> entry table across every family section.
    Reads both the sectioned v2 format and the flat v1 one (whose
    findings were all concurrency-family)."""
    data = _read_baseline_json(path) or {}
    if "families" in data:
        merged: Dict[str, dict] = {}
        for fam, section in data["families"].items():
            want = FAMILY_SCHEMA.get(fam)
            if want is not None and section.get("schema") != want:
                # Stale fingerprint scheme for THIS family: its entries
                # cannot match current fingerprints, so merging them
                # only hides the problem. Skipping the section makes
                # the mismatch loud (that family's debt reports as new
                # -> regenerate with --family <fam> --write-baseline)
                # while the OTHER family's section keeps working — the
                # isolation the per-family schema exists to provide.
                print(f"rtpu-lint: baseline section '{fam}' has schema "
                      f"{section.get('schema')!r}, current is {want}; "
                      f"ignoring it — regenerate with --family {fam} "
                      "--write-baseline", file=sys.stderr)
                continue
            merged.update(section.get("findings", {}))
        return merged
    return data.get("findings", {})


def write_baseline(path: str, findings: List[Finding],
                   families: Optional[Tuple[str, ...]] = None) -> None:
    """Write the sectioned (v2) baseline. With ``families`` given, ONLY
    those sections are regenerated — the other family's entries are
    carried over verbatim (the per-family analog of the partial-path
    hazard: a torch-only rewrite must never drop the concurrency debt)."""
    fams = tuple(families) if families else FAMILIES
    sections: Dict[str, dict] = {}
    existing = _read_baseline_json(path)
    if families and existing is None and os.path.exists(path):
        # The file exists but cannot be parsed: carrying "nothing" over
        # would silently drop the other family's entire debt — the same
        # truncation hazard the partial-path refusal guards. Refuse.
        # (A valid-but-empty '{}' baseline parses to a dict and is NOT
        # refused; a full rewrite never needs the old content at all.)
        raise ValueError(
            f"existing baseline {path} is unreadable/corrupt; a "
            "partial-family rewrite would drop every other family's "
            "entries — restore the file from version control (do NOT "
            "delete it: a partial write of a missing file also starts "
            "from nothing), or rerun without --family to regenerate "
            "every section")
    existing = existing or {}
    for fam, section in existing.get("families", {}).items():
        if fam not in fams:
            sections[fam] = section
    if "findings" in existing and "families" not in existing \
            and "concurrency" not in fams:
        # v1 file being partially rewritten: its flat findings ARE the
        # concurrency section.
        sections["concurrency"] = {
            "schema": FAMILY_SCHEMA["concurrency"],
            "findings": existing["findings"]}
    tables: Dict[str, Dict[str, dict]] = {fam: {} for fam in fams}
    for f in findings:
        fam = RULE_FAMILY.get(f.rule, "concurrency")
        if fam not in tables:
            continue
        entry = tables[fam].setdefault(f.fingerprint(), {
            "count": 0, "rule": f.rule, "path": f.path,
            "message": f.message})
        entry["count"] += 1
    for fam in fams:
        sections[fam] = {"schema": FAMILY_SCHEMA.get(fam, 1),
                         "findings": dict(sorted(tables[fam].items()))}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": 2,
                   "note": "legacy findings tracked-not-fatal, "
                           "sectioned per rule family; regenerate with "
                           "python -m ray_tpu_torch.devtools.lint "
                           "--write-baseline [--family X]",
                   "families": dict(sorted(sections.items()))},
                  fh, indent=1, sort_keys=False)
        fh.write("\n")


def new_findings(findings: List[Finding],
                 baseline: Dict[str, dict]) -> List[Finding]:
    """Findings whose per-fingerprint count exceeds the baseline's."""
    budget = {fp: e.get("count", 0) for fp, e in baseline.items()}
    out = []
    for f in findings:
        fp = f.fingerprint()
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
        else:
            out.append(f)
    return out


def run(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("paths", nargs="*",
                   help="files/dirs to lint (default: the ray_tpu_torch "
                        "package + the repo root's chip_smoke.py)")
    p.add_argument("--baseline", default=DEFAULT_BASELINE,
                   help="baseline JSON (default: the packaged one)")
    p.add_argument("--write-baseline", action="store_true",
                   help="rewrite the baseline from this run's findings "
                        "(with --family: only that family's section)")
    p.add_argument("--family", choices=("all",) + FAMILIES,
                   default="all",
                   help="rule family to run (default: all)")
    p.add_argument("--all", action="store_true",
                   help="print baselined findings too, not just new")
    p.add_argument("--stats", action="store_true",
                   help="print per-rule finding counts")
    args = p.parse_args(argv)

    families = FAMILIES if args.family == "all" else (args.family,)
    root, roots = default_roots()
    paths = args.paths or roots
    findings = lint_paths(paths, root, families=families)

    if args.stats:
        # One table: family / rule / current findings / baselined
        # budget — the at-a-glance debt readout per family. Purely
        # informational; the exit code below is unchanged by --stats.
        counts: Dict[str, int] = {}
        for f in findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        base_counts: Dict[str, int] = {}
        data = _read_baseline_json(args.baseline) or {}
        sections = data.get("families", {})
        if not sections and "findings" in data:  # v1 flat = concurrency
            sections = {"concurrency": {"findings": data["findings"]}}
        for section in sections.values():
            for entry in section.get("findings", {}).values():
                rule = entry.get("rule", "?")
                base_counts[rule] = (base_counts.get(rule, 0)
                                     + entry.get("count", 0))
        print(f"{'family':12s} {'rule':36s} {'found':>6s} "
              f"{'baseline':>9s}")
        for fam in families:
            fam_found = fam_base = 0
            for rule in FAMILY_RULES[fam]:
                n, b = counts.get(rule, 0), base_counts.get(rule, 0)
                fam_found += n
                fam_base += b
                print(f"{fam:12s} {rule:36s} {n:6d} {b:9d}")
            print(f"{fam:12s} {'TOTAL':36s} {fam_found:6d} "
                  f"{fam_base:9d}")

    if args.write_baseline:
        if args.paths and (os.path.abspath(args.baseline)
                           == os.path.abspath(DEFAULT_BASELINE)):
            # A partial scan must never truncate the repo baseline: the
            # next full run would report every other legacy finding as
            # new and fail tier-1.
            print("refusing --write-baseline of the packaged baseline "
                  "from an explicit path list (it would drop every "
                  "finding outside those paths); rerun with no paths, "
                  "or pass --baseline <other-file>", file=sys.stderr)
            return 2
        try:
            write_baseline(args.baseline, findings,
                           families=None if args.family == "all"
                           else families)
        except ValueError as e:
            print(f"refusing --write-baseline: {e}", file=sys.stderr)
            return 2
        print(f"baseline written: {len(findings)} findings "
              f"({'+'.join(families)}) -> {args.baseline}")
        return 0

    baseline = load_baseline(args.baseline)
    fresh = new_findings(findings, baseline)
    if args.all:
        for f in findings:
            mark = "NEW " if f in fresh else "base"
            print(f"[{mark}] {f}")
    else:
        for f in fresh:
            print(f"NEW: {f}")
    n_base = len(findings) - len(fresh)
    print(f"rtpu-lint: {len(findings)} findings "
          f"({n_base} baselined, {len(fresh)} new)")
    if fresh:
        print("new findings fail the lint — fix them, suppress with "
              "'# rtpu-lint: disable=<rule>', or (for an accepted "
              "legacy-style debt) --write-baseline")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(run())
