"""res-lint: resource-lifetime rules (rule family ``res``),
``ray_tpu/devtools/reslint.py``'s rules over the port.

Stdlib-only AST analysis riding rtpu-lint's fingerprint/baseline/
``# rtpu-lint: disable=<rule>`` machinery (``lint.py`` runs every rule
family from one CLI). Every rule codifies a lifetime bug ``ray_tpu``
shipped and re-found by hand, again and again:

  acquire-without-release
      a releasable handle (``BufferLease(...)``, ``<x>.pin(...)``) is
      obtained but not released on every path and not consumed as a
      context manager — ``with``, ``stack.enter_context``, a
      try-``finally`` release, or an ownership transfer (returned,
      stored, passed onward) are all OK. The borrow-pin bug:
      owners pinned borrowed objects forever because the release half
      was simply absent.
  begin-without-commit
      ``<kv>.begin_speculation(...)`` with no
      ``commit_speculation``/``release`` (or a cleanup helper) on the
      failure arm — a device fault mid-verify would strand the
      reservation and ``used_blocks()`` would never drop (a
      hazard re-opened whenever the tick's error handling is
      touched).
  unbounded-registry-growth
      a ``self.<attr>`` dict/list/set/deque grown from an RPC handler
      or long-lived loop (directly or through same-class helpers) with
      no eviction, ``maxlen``, cap check, or reaper evidence anywhere
      in the class — the ``_local_objects`` mirror and the
      return-lease memo (which needed a hand-picked 4096 cap) both
      shipped exactly this shape.
  thread-without-stop
      a daemon ``Thread``/``Timer`` attribute never joined/cancelled —
      and no stop-event set — anywhere REACHABLE from the owning
      class's ``stop()``/``close()``/``shutdown()`` through same-class
      helper calls. Generalizes daemon-no-join (which accepted
      a join in ANY method): a join that the stop path never runs is
      teardown theater.
  fd-leak-on-error
      a socket/file opened and bound to a local, followed by calls
      that can raise before the handle is closed or ownership escapes,
      with no enclosing try whose handler/finally closes it and no
      ``with`` — the open fd leaks on the exception path.

``lint_source(source, module, path)`` returns ``lint.Finding`` rows;
module-scoped tables live in ``invariants.py``. The runtime half of
this family is ``res_debug.py`` (``RTPU_DEBUG_RES=1``): the same
acquire/release seams these rules police statically are counted in a
per-process balance registry and asserted drained at close.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.devtools import invariants as inv
# RES_RULES is single-sourced in lint.py (the family/baseline machinery
# keys on it); aliased here so rule code and rule registry can't drift.
from ray_tpu_torch.devtools.lint import (RES_RULES as RULES, Finding, _dotted,
                                   suppressed)


def _leaf(dotted: Optional[str]) -> str:
    return dotted.rsplit(".", 1)[-1] if dotted else ""


def _walk_no_nested(root_nodes) -> List[ast.AST]:
    """Child subtree of the given statements, excluding nested function
    and class bodies (they run on their own schedule)."""
    out: List[ast.AST] = []
    todo = list(root_nodes)
    while todo:
        sub = todo.pop()
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda, ast.ClassDef)):
            continue
        out.append(sub)
        todo.extend(ast.iter_child_nodes(sub))
    return out


def _self_attr(node: ast.AST) -> Optional[str]:
    """'attr' for a ``self.attr`` expression, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _ResLinter:
    def __init__(self, module: str, path: str, source: str,
                 package: str = inv.PACKAGE):
        self.module = inv.module_key(module, package)
        self.path = path
        self.lines = source.splitlines()
        self.findings: List[Finding] = []
        self._scope: List[str] = []

    # ------------------------------------------------------------ utils

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        assert rule in RULES, f"unregistered res rule id {rule!r}"
        line = getattr(node, "lineno", 1)
        if suppressed(self.lines, line, rule):
            return
        self.findings.append(Finding(rule, self.path, line,
                                     ".".join(self._scope), message))

    # ------------------------------------------------------------- walk

    def run(self, tree: Optional[ast.AST] = None) -> List[Finding]:
        if tree is None:
            try:
                tree = ast.parse("\n".join(self.lines),
                                 filename=self.path)
            except SyntaxError:
                return []  # the concurrency family reports this
        self._walk(tree)
        return self.findings

    def _walk(self, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scope.append(child.name)
                self._check_acquire_release(child)
                self._check_begin_commit(child)
                self._check_fd_leak(child)
                self._walk(child)
                self._scope.pop()
                continue
            if isinstance(child, ast.ClassDef):
                self._scope.append(child.name)
                self._check_registry_growth(child)
                self._check_thread_stop(child)
                self._walk(child)
                self._scope.pop()
                continue
            self._walk(child)

    # ----------------------------------------------- acquire vs release

    @staticmethod
    def _is_acquire(call: ast.Call) -> Optional[str]:
        dotted = _dotted(call.func)
        leaf = _leaf(dotted)
        if leaf in inv.RES_ACQUIRE_CONSTRUCTORS:
            return leaf
        if isinstance(call.func, ast.Attribute) and \
                call.func.attr in inv.RES_ACQUIRE_ATTRS:
            return f"{dotted or call.func.attr}()"
        return None

    def _check_acquire_release(self, fn) -> None:
        """A releasable handle bound to a local must be consumed as a
        context manager, released in a ``finally``, or have its
        ownership escape (returned / stored / passed onward). A release
        that only sits on the straight-line success path is the finding
        — the exception path skips it (the forever-pinned borrow)."""
        nodes = _walk_no_nested(ast.iter_child_nodes(fn))
        ok_ids: Set[int] = set()          # acquire Calls consumed safely
        acquires: List[Tuple[ast.Call, str]] = []
        bound: Dict[str, List[ast.Call]] = {}
        # Pass 1: find acquires + structurally-safe consumptions.
        for sub in nodes:
            if isinstance(sub, (ast.With, ast.AsyncWith)):
                for item in sub.items:
                    ok_ids.add(id(item.context_expr))
            elif isinstance(sub, ast.Return) and sub.value is not None:
                for c in ast.walk(sub.value):
                    ok_ids.add(id(c))  # ownership transferred to caller
            elif isinstance(sub, ast.Call):
                desc = self._is_acquire(sub)
                if desc is not None:
                    acquires.append((sub, desc))
                # An acquire nested inside ANOTHER call's args is an
                # ownership transfer (enter_context included).
                for arg in list(sub.args) + [kw.value
                                             for kw in sub.keywords]:
                    for c in ast.walk(arg):
                        ok_ids.add(id(c))
            elif isinstance(sub, ast.Assign):
                tgt = sub.targets[0] if len(sub.targets) == 1 else None
                if isinstance(sub.value, ast.Call) and \
                        self._is_acquire(sub.value) is not None:
                    if isinstance(tgt, ast.Name):
                        bound.setdefault(tgt.id, []).append(sub.value)
                    else:
                        # self.x = acquire(...) / container[k] = ...:
                        # lifecycle escapes to the owner object.
                        ok_ids.add(id(sub.value))
        # Pass 2: per bound name, look at how it is used.
        name_events: Dict[str, Dict[str, bool]] = {
            n: {"with": False, "rel_fin": False, "rel_any": False,
                "escape": False} for n in bound}
        finally_ids: Set[int] = set()
        for sub in nodes:
            if isinstance(sub, ast.Try):
                for s in sub.finalbody:
                    for c in ast.walk(s):
                        finally_ids.add(id(c))
        for sub in nodes:
            if isinstance(sub, (ast.With, ast.AsyncWith)):
                for item in sub.items:
                    ce = item.context_expr
                    if isinstance(ce, ast.Name) and ce.id in name_events:
                        name_events[ce.id]["with"] = True
            elif isinstance(sub, ast.Call):
                if isinstance(sub.func, ast.Attribute) and \
                        isinstance(sub.func.value, ast.Name) and \
                        sub.func.value.id in name_events:
                    ev = name_events[sub.func.value.id]
                    if sub.func.attr in inv.RES_RELEASE_ATTRS:
                        ev["rel_any"] = True
                        if id(sub) in finally_ids:
                            ev["rel_fin"] = True
                    elif sub.func.attr == "enter_context":
                        pass
                # The HANDLE ITSELF passed as an argument -> ownership
                # transfer. A sub-attribute (``conn.sendall(buf.view)``)
                # is a use, not a transfer — the borrow-pin leaked
                # exactly through that distinction.
                for arg in list(sub.args) + [kw.value
                                             for kw in sub.keywords]:
                    cands = [arg]
                    if isinstance(arg, (ast.Tuple, ast.List)):
                        cands = list(arg.elts)
                    elif isinstance(arg, ast.Starred):
                        cands = [arg.value]
                    for c in cands:
                        if isinstance(c, ast.Name) and \
                                c.id in name_events:
                            name_events[c.id]["escape"] = True
            elif isinstance(sub, ast.Return) and sub.value is not None:
                for c in ast.walk(sub.value):
                    if isinstance(c, ast.Name) and c.id in name_events:
                        name_events[c.id]["escape"] = True
            elif isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                        for c in ast.walk(sub.value):
                            if isinstance(c, ast.Name) and \
                                    c.id in name_events:
                                name_events[c.id]["escape"] = True
        for name, calls in bound.items():
            ev = name_events[name]
            if ev["with"] or ev["rel_fin"] or ev["escape"]:
                continue
            for call in calls:
                if id(call) in ok_ids:
                    continue
                desc = self._is_acquire(call) or name
                if ev["rel_any"]:
                    self._emit(
                        "acquire-without-release", call,
                        f"'{name}' ({desc}) is released on the success "
                        "path only — an exception between acquire and "
                        "release pins it forever; use `with`, "
                        "try/finally, or stack.enter_context")
                else:
                    self._emit(
                        "acquire-without-release", call,
                        f"'{name}' ({desc}) is acquired but never "
                        "released and never escapes this function — "
                        "the pin/lease leaks on every path")
        for call, desc in acquires:
            # Bare-expression acquire: the handle is dropped on the
            # floor immediately (not bound, not consumed, not passed).
            if id(call) in ok_ids:
                continue
            if any(call in vals for vals in bound.values()):
                continue
            self._emit(
                "acquire-without-release", call,
                f"{desc} result is discarded — the acquired pin/lease "
                "can never be released")

    # ----------------------------------------------- begin vs commit

    def _check_begin_commit(self, fn) -> None:
        """``begin_speculation`` opens a reservation; the failure arm
        (an ``except``/``finally`` covering the in-flight window) must
        resolve it — ``commit_speculation``/``release`` directly, or a
        same-class cleanup helper (``self._fail_roster(...)`` releases
        every active slot). No failure arm at all is the finding too:
        the first device fault strands the reservation."""
        nodes = _walk_no_nested(ast.iter_child_nodes(fn))
        begin: Optional[ast.Call] = None
        handler_bodies: List[ast.AST] = []
        for sub in nodes:
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr == "begin_speculation":
                begin = begin or sub
            elif isinstance(sub, ast.Try):
                for h in sub.handlers:
                    handler_bodies.extend(h.body)
                handler_bodies.extend(sub.finalbody)
        if begin is None:
            return
        cleanup = False
        for sub in _walk_no_nested(handler_bodies):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute):
                attr = sub.func.attr
                if attr in inv.RES_COMMIT_ATTRS or \
                        inv.RES_CLEANUP_NAME_RE.search(attr):
                    cleanup = True
                    break
        if cleanup:
            return
        if handler_bodies:
            msg = ("begin_speculation has no commit_speculation/release "
                   "(or cleanup helper) on the failure arm — a device "
                   "fault mid-verify strands the reservation and "
                   "used_blocks() never drops")
        else:
            msg = ("begin_speculation with no try/except/finally "
                   "covering the in-flight window — the first raise "
                   "strands the reservation (no failure arm resolves "
                   "it)")
        self._emit("begin-without-commit", begin, msg)

    # ------------------------------------------- registry growth bounds

    @staticmethod
    def _method_self_calls(fn) -> Set[str]:
        out: Set[str] = set()
        for sub in _walk_no_nested(ast.iter_child_nodes(fn)):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    isinstance(sub.func.value, ast.Name) and \
                    sub.func.value.id == "self":
                out.add(sub.func.attr)
        return out

    def _check_registry_growth(self, cls: ast.ClassDef) -> None:
        """``self.<attr>`` containers grown from RPC handlers or
        long-lived loops (directly or through same-class helpers) need
        eviction evidence somewhere in the class: a pop/del/clear on
        the attr, a ``maxlen=``/cap check, or a reaper-named method
        touching it. The ``_local_objects`` mirror and the
        return-lease memo both grew forever before they were caught by hand
        by hand."""
        if self.module not in inv.RES_REGISTRY_MODULES:
            return
        methods = {m.name: m for m in cls.body
                   if isinstance(m, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        # Hot set: rpc handlers + long-lived loops, closed over
        # same-class helper calls (the historical leaks hid one helper
        # away from the handler).
        hot: Set[str] = set()
        for name, m in methods.items():
            if name.startswith("rpc_") or \
                    inv.RES_LOOP_NAME_RE.search(name):
                hot.add(name)
            else:
                for sub in _walk_no_nested(ast.iter_child_nodes(m)):
                    if isinstance(sub, ast.While) and \
                            isinstance(sub.test, ast.Constant) and \
                            sub.test.value:
                        hot.add(name)
                        break
        frontier = list(hot)
        while frontier:
            callee_sets = [self._method_self_calls(methods[n])
                           for n in frontier if n in methods]
            frontier = []
            for cs in callee_sets:
                for callee in cs:
                    if callee in methods and callee not in hot:
                        hot.add(callee)
                        frontier.append(callee)
        # Growth sites in hot methods.
        growth: Dict[str, ast.AST] = {}   # attr -> first growth node
        evidence: Set[str] = set()        # attrs with bounding evidence
        reaper_methods = {n for n in methods
                          if inv.RES_REAPER_NAME_RE.search(n)}
        for name, m in methods.items():
            in_hot = name in hot
            in_reaper = name in reaper_methods
            # Local aliases of self.<attr> within this method: an
            # eviction call on the alias counts for the attr (the
            # outbox drain binds ``outbox = self._obj_notify_outbox``
            # and poplefts the local; ``subs = self._subs.get(ch)``
            # removes through the fetched inner container).
            aliases: Dict[str, Set[str]] = {}  # local name -> attrs
            body = _walk_no_nested(ast.iter_child_nodes(m))
            for sub in body:
                tgt = None
                src = None
                if isinstance(sub, ast.Assign) and \
                        len(sub.targets) == 1 and \
                        isinstance(sub.targets[0], ast.Name):
                    tgt, src = sub.targets[0].id, sub.value
                elif isinstance(sub, ast.For) and \
                        isinstance(sub.target, ast.Name):
                    tgt, src = sub.target.id, sub.iter
                if tgt is None or src is None:
                    continue
                for c in ast.walk(src):
                    attr = _self_attr(c)
                    if attr:
                        aliases.setdefault(tgt, set()).add(attr)
            for sub in body:
                # self.X[k] = v  /  self.X: T = deque(maxlen=...)
                if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    targets = (sub.targets
                               if isinstance(sub, ast.Assign)
                               else [sub.target])
                    value = sub.value
                    for tgt in targets:
                        if isinstance(tgt, ast.Subscript):
                            attr = _self_attr(tgt.value)
                            if attr and in_hot and attr not in growth:
                                growth[attr] = tgt
                    # self.X = <call with maxlen=...> (bounded ctor) or
                    # a reassignment outside __init__ (reset evidence).
                    tgt0 = targets[0] if len(targets) == 1 else None
                    attr = _self_attr(tgt0) if tgt0 is not None else None
                    if attr and value is not None:
                        if isinstance(value, ast.Call) and any(
                                kw.arg == "maxlen"
                                for kw in value.keywords):
                            evidence.add(attr)
                        elif name != "__init__":
                            evidence.add(attr)  # re-bound = reset path
                elif isinstance(sub, ast.Delete):
                    for t in sub.targets:
                        if isinstance(t, ast.Subscript):
                            attr = _self_attr(t.value)
                            if attr:
                                evidence.add(attr)
                elif isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute):
                    if isinstance(sub.func.value, ast.Name) and \
                            sub.func.attr in inv.RES_EVICT_ATTRS:
                        # Eviction through a local alias of self.<attr>.
                        evidence.update(
                            aliases.get(sub.func.value.id, ()))
                    attr = _self_attr(sub.func.value)
                    if attr is None:
                        # self.X.setdefault(k, []).append(v) — receiver
                        # is itself a call on self.X.
                        base = sub.func.value
                        if isinstance(base, ast.Call) and \
                                isinstance(base.func, ast.Attribute):
                            attr = _self_attr(base.func.value)
                    if attr is None:
                        continue
                    a = sub.func.attr
                    if a in inv.RES_EVICT_ATTRS:
                        evidence.add(attr)
                    elif in_reaper:
                        evidence.add(attr)
                    elif a in ("append", "add", "appendleft", "insert",
                               "setdefault", "update") and in_hot:
                        growth.setdefault(attr, sub)
                # len(self.X) anywhere = a cap check exists.
                elif isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Name) and \
                        sub.func.id == "len" and sub.args:
                    attr = _self_attr(sub.args[0])
                    if attr:
                        evidence.add(attr)
        for attr, node in sorted(growth.items()):
            if attr in evidence:
                continue
            self._emit(
                "unbounded-registry-growth", node,
                f"self.{attr} grows from an RPC handler / long-lived "
                "loop with no eviction, maxlen, cap check, or reaper "
                "evidence anywhere in this class — it leaks one entry "
                "per request forever (the _local_objects / return-"
                "lease-memo shape); bound it or reap it")

    # --------------------------------------------- thread stop lifecycle

    def _check_thread_stop(self, cls: ast.ClassDef) -> None:
        """Daemon Thread/Timer attrs must be joined/cancelled — or a
        stop event set — on a path REACHABLE from the class's
        stop/close/shutdown. A join in an unrelated method passes PR
        5's daemon-no-join but still leaves teardown unordered."""
        methods = {m.name: m for m in cls.body
                   if isinstance(m, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        stop_roots = [n for n in methods if n in inv.RES_STOP_METHOD_NAMES]
        if not stop_roots:
            return  # no teardown surface: daemon-no-join covers it
        threads: List[Tuple[str, ast.AST, str]] = []  # (attr, node, kind)
        for sub in ast.walk(cls):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                tgt = sub.targets[0]
                attr = _self_attr(tgt)
                if attr is None or not isinstance(sub.value, ast.Call):
                    continue
                fn = _dotted(sub.value.func) or ""
                if fn.endswith("Timer"):
                    threads.append((attr, sub, "Timer"))
                elif fn.endswith("Thread"):
                    for kw in sub.value.keywords:
                        if kw.arg == "daemon" and \
                                isinstance(kw.value, ast.Constant) and \
                                kw.value.value is True:
                            threads.append((attr, sub, "Thread"))
        if not threads:
            return
        reachable: Set[str] = set(stop_roots)
        frontier = list(stop_roots)
        while frontier:
            name = frontier.pop()
            if name not in methods:
                continue
            for callee in self._method_self_calls(methods[name]):
                if callee in methods and callee not in reachable:
                    reachable.add(callee)
                    frontier.append(callee)
        joined: Set[str] = set()
        stop_evented = False
        for name in reachable:
            for sub in _walk_no_nested(
                    ast.iter_child_nodes(methods[name])):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute):
                    attr = _self_attr(sub.func.value)
                    if attr is not None:
                        if sub.func.attr in ("join", "cancel"):
                            joined.add(attr)
                        elif sub.func.attr == "set" and \
                                inv.RES_STOP_EVENT_NAME_RE.search(attr):
                            stop_evented = True
        for attr, node, kind in threads:
            if attr in joined or stop_evented:
                continue
            roots = "/".join(sorted(stop_roots))
            self._emit(
                "thread-without-stop", node,
                f"daemon {kind} self.{attr} is never joined/cancelled "
                f"(and no stop event is set) on any path reachable "
                f"from {roots}() — teardown leaves it running against "
                "freed state")

    # ------------------------------------------------- fd leak on error

    @staticmethod
    def _is_open_call(call: ast.Call) -> Optional[str]:
        dotted = _dotted(call.func)
        if dotted is None:
            return None
        if isinstance(call.func, ast.Name):
            if dotted in inv.RES_OPEN_NAME_CALLS:
                return dotted
            return None
        for suffix in inv.RES_OPEN_CALL_SUFFIXES:
            if dotted == suffix or dotted.endswith("." + suffix):
                return dotted
        return None

    def _check_fd_leak(self, fn) -> None:
        """``name = socket.socket(...)`` / ``name = open(...)`` followed
        by calls that can raise before the handle escapes or closes,
        with no try whose handler/finally closes it: the fd leaks on
        the exception path. ``with`` and immediate escape are fine."""
        # Statement-level linear scan in source order, per open.
        stmts = [s for s in _walk_no_nested(ast.iter_child_nodes(fn))
                 if isinstance(s, ast.stmt)]
        stmts.sort(key=lambda s: (s.lineno, s.col_offset))
        # Protected region: statements inside a Try whose handlers or
        # finally close SOME name — map try node -> closed names.
        protected: Dict[int, Set[str]] = {}  # id(stmt) -> closing names
        for sub in _walk_no_nested(ast.iter_child_nodes(fn)):
            if not isinstance(sub, ast.Try):
                continue
            closing: Set[str] = set()
            for region in ([h.body for h in sub.handlers]
                           + [sub.finalbody]):
                for s in _walk_no_nested(region):
                    if isinstance(s, ast.Call) and \
                            isinstance(s.func, ast.Attribute) and \
                            s.func.attr in inv.RES_CLOSE_ATTRS and \
                            isinstance(s.func.value, ast.Name):
                        closing.add(s.func.value.id)
                    elif isinstance(s, ast.Call) and \
                            isinstance(s.func, ast.Name) and \
                            "shutdown" in s.func.id and s.args and \
                            isinstance(s.args[0], ast.Name):
                        closing.add(s.args[0].id)
            for s in _walk_no_nested(sub.body):
                if isinstance(s, ast.stmt):
                    protected.setdefault(id(s), set()).update(closing)
        opens: List[Tuple[str, ast.Call, int]] = []  # (name, call, idx)
        for i, s in enumerate(stmts):
            if isinstance(s, ast.Assign) and len(s.targets) == 1 and \
                    isinstance(s.targets[0], ast.Name) and \
                    isinstance(s.value, ast.Call):
                desc = self._is_open_call(s.value)
                if desc is not None:
                    opens.append((s.targets[0].id, s.value, i))
        for name, call, idx in opens:
            risky: Optional[ast.AST] = None
            for s in stmts[idx + 1:]:
                text_nodes = list(ast.walk(s))
                mentions = any(isinstance(c, ast.Name) and c.id == name
                               for c in text_nodes)
                closes = any(
                    isinstance(c, ast.Call)
                    and isinstance(c.func, ast.Attribute)
                    and c.func.attr in inv.RES_CLOSE_ATTRS
                    and isinstance(c.func.value, ast.Name)
                    and c.func.value.id == name
                    for c in text_nodes)
                if closes:
                    risky = None
                    break
                escapes = False
                if isinstance(s, ast.Return):
                    if mentions:
                        escapes = True  # ownership goes to the caller
                elif isinstance(s, ast.Assign):
                    for tgt in s.targets:
                        if isinstance(tgt, (ast.Attribute, ast.Subscript)) \
                                and mentions:
                            escapes = True
                        if isinstance(tgt, ast.Name) and tgt.id == name:
                            escapes = True  # rebound; we lose track
                elif mentions:
                    for c in text_nodes:
                        if isinstance(c, ast.Call):
                            for arg in list(c.args) + \
                                    [kw.value for kw in c.keywords]:
                                if any(isinstance(x, ast.Name)
                                       and x.id == name
                                       for x in ast.walk(arg)):
                                    escapes = True
                if escapes:
                    break
                has_call = any(isinstance(c, ast.Call)
                               for c in text_nodes)
                if has_call and name not in protected.get(id(s), set()):
                    risky = risky or s
            if risky is not None:
                self._emit(
                    "fd-leak-on-error", call,
                    f"'{name}' is opened, then line {risky.lineno} can "
                    "raise before it is closed or ownership escapes — "
                    "the fd leaks on the exception path; use `with`, "
                    "or try/except-close-reraise")


def lint_source(source: str, module: str, path: str,
                tree: Optional[ast.AST] = None,
                package: str = inv.PACKAGE) -> List[Finding]:
    """Run the res rule family over one module's source. ``tree``
    reuses a caller-side parse (lint_paths parses once per file for
    every family)."""
    return _ResLinter(module, path, source, package).run(tree)
