"""dist-lint: distributed RPC-contract rules (rule family ``dist``),
``ray_tpu/devtools/distlint.py``'s rules over the port.

Stdlib-only AST analysis riding rtpu-lint's fingerprint/baseline/
``# rtpu-lint: disable=<rule>`` machinery (``lint.py`` runs every rule
family from one CLI). Every rule codifies a protocol bug ``ray_tpu``
shipped and found by hand:

  unclassified-rpc-handler
      a ``def rpc_<m>`` on a server class where ``<m>`` appears in
      neither ``protocol.RETRY_SAFE_RPCS`` (any recovery group) nor
      ``protocol.NON_RETRYABLE_RPCS`` — its retry/idempotency semantics
      are undeclared. Three changes in a row grew the hand-maintained set as
      an afterthought ("RETRY_SAFE_RPCS += trace_tail/..."); before
      ROADMAP item 3 replays RPCs by design, forgetting to classify
      must be a lint failure, not a catch made by hand.
  retry-unsafe-call
      ``<client>.retrying_call("<m>", ...)`` where ``<m>`` is not
      declared retry-safe: the caller re-delivers a request whose
      handler never promised at-most-once.
  direct-notify-bypasses-outbox
      a direct ``notify``/``call`` of an object-directory method
      (``object_added``/``object_removed``/``object_batch``) from a
      module that owns a batched outbox, outside its designated sender
      — the stale-directory bug: the direct frame overtakes the same
      process's still-queued add and the directory goes permanently
      stale.
  serial-fanout-no-deadline
      a loop issuing blocking per-peer RPCs with no total deadline, no
      bounded iteration, and no concurrency — the
      ``rpc_cluster_leases`` bug: N mid-death nodes x one control
      timeout each outran every caller's own deadline.
  wall-clock-deadline
      ``time.time()`` feeding deadline/timeout arithmetic or
      comparisons — an NTP step mid-wait stretches or collapses the
      window; ``time.monotonic()`` is required. Plain timestamping
      (span starts, cross-process freshness stamps, which NEED the
      epoch clock) is exempt.
  missing-chaos-role
      an RPC-handler class with no ``chaos_role`` declaration (class
      attribute or ``self.chaos_role = ...``) and no known role-setting
      base: the server silently opts out of every role-targeted chaos
      plan (``kill:role=head:...`` never fires on it).
  retry-unsafe-block-rpc
      a lease-block handler (``rpc_lease_block_*``) whose method is
      classified but NOT retry-safe. Blocks are leases: their grant/
      renew/install/revoke RPCs are retried by owners and double-
      delivered by the RTPU_DEBUG_RPC witness, so a non-idempotent
      classification means a retried grant double-installs admission
      budget and the lease census never drains to zero. Unclassified
      block handlers are caught by unclassified-rpc-handler; this rule
      closes the other gap (classified, but on the wrong side).

Classification sets are read from the linted source itself when it
declares them (fixtures), else statically from a ``cluster/protocol.py``:
the port's own by default, ``ray_tpu``'s when the cross check lints
``ray_tpu``'s tree — the linter never imports the runtime.
``lint_source(source, module, path)`` returns ``lint.Finding`` rows;
module-scoped tables live in ``invariants.py``.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from ray_tpu_torch.devtools import invariants as inv
# DIST_RULES is single-sourced in lint.py (the family/baseline
# machinery keys on it); aliased here so rule code and rule registry
# can't drift.
from ray_tpu_torch.devtools.lint import (DIST_RULES as RULES, Finding,
                                         _dotted, suppressed)

#: Names in protocol.py whose module-level set/frozenset assignments
#: contribute to the classification tables.
_SET_NAMES = {
    "READONLY_RPCS", "IDEMPOTENT_RPCS", "ACKED_RETRY_RPCS",
    "RETRY_SAFE_RPCS", "NON_RETRYABLE_RPCS",
}


def _literal_strings(node: ast.AST) -> Optional[FrozenSet[str]]:
    """A set/list/tuple literal of string constants, else None."""
    if isinstance(node, (ast.Set, ast.List, ast.Tuple)):
        out = []
        for e in node.elts:
            if not (isinstance(e, ast.Constant)
                    and isinstance(e.value, str)):
                return None
            out.append(e.value)
        return frozenset(out)
    return None


def extract_classification_sets(tree: ast.AST) -> Dict[str, FrozenSet[str]]:
    """Module-level RPC classification sets, resolved statically:
    ``X = frozenset({...})``, ``X = {...}``, and unions of
    already-resolved names (``A | B | C``)."""
    resolved: Dict[str, FrozenSet[str]] = {}

    def value_of(node: ast.AST) -> Optional[FrozenSet[str]]:
        lit = _literal_strings(node)
        if lit is not None:
            return lit
        if isinstance(node, ast.Call):
            fn = _dotted(node.func) or ""
            if fn.rsplit(".", 1)[-1] in ("frozenset", "set") and \
                    len(node.args) == 1:
                return _literal_strings(node.args[0])
            return None
        if isinstance(node, ast.Name):
            return resolved.get(node.id)
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
            left = value_of(node.left)
            right = value_of(node.right)
            if left is not None and right is not None:
                return left | right
        return None

    for stmt in getattr(tree, "body", []):
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name):
            name = stmt.targets[0].id
            if name in _SET_NAMES:
                val = value_of(stmt.value)
                if val is not None:
                    resolved[name] = val
    return resolved


#: The port's own protocol module, read when the caller names none.
_OWN_PROTOCOL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cluster", "protocol.py")
_REPO_SETS: Dict[str, Tuple[FrozenSet[str], FrozenSet[str]]] = {}


def _protocol_sets(path: Optional[str] = None
                   ) -> Tuple[FrozenSet[str], FrozenSet[str]]:
    """(retry_safe, non_retryable) from a protocol.py (the port's by
    default), parsed statically ONCE per path (the linter must work —
    and agree with itself — without importing the runtime)."""
    path = path or _OWN_PROTOCOL
    hit = _REPO_SETS.get(path)
    if hit is not None:
        return hit
    retry_safe: FrozenSet[str] = frozenset()
    non_retryable: FrozenSet[str] = frozenset()
    try:
        with open(path, "r", encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
        sets = extract_classification_sets(tree)
        retry_safe = sets.get("RETRY_SAFE_RPCS", frozenset())
        non_retryable = sets.get("NON_RETRYABLE_RPCS", frozenset())
    except (OSError, SyntaxError):
        pass  # no sets -> every handler reports unclassified, loudly
    _REPO_SETS[path] = (retry_safe, non_retryable)
    return _REPO_SETS[path]


def _reset_repo_sets_cache() -> None:
    """Test hook: forget the parsed protocol.py sets."""
    _REPO_SETS.clear()


class _DistLinter:
    def __init__(self, module: str, path: str, source: str,
                 package: str = inv.PACKAGE,
                 protocol: Optional[str] = None):
        self.module = inv.module_key(module, package)
        self.protocol = protocol
        self.path = path
        self.lines = source.splitlines()
        self.findings: List[Finding] = []
        self._scope: List[str] = []
        self._fn_stack: List[ast.AST] = []

    # ------------------------------------------------------------ utils

    def _emit(self, rule: str, node: ast.AST, message: str,
              scope: Optional[str] = None) -> None:
        assert rule in RULES, f"unregistered dist rule id {rule!r}"
        line = getattr(node, "lineno", 1)
        if suppressed(self.lines, line, rule):
            return
        self.findings.append(Finding(
            rule, self.path, line,
            scope if scope is not None else ".".join(self._scope),
            message))

    # ------------------------------------------------------------- walk

    def run(self, tree: Optional[ast.AST] = None) -> List[Finding]:
        if tree is None:
            try:
                tree = ast.parse("\n".join(self.lines),
                                 filename=self.path)
            except SyntaxError:
                return []  # the concurrency family reports this
        local = extract_classification_sets(tree)
        if local:
            retry_safe = local.get("RETRY_SAFE_RPCS", frozenset())
            if not retry_safe:
                retry_safe = (local.get("READONLY_RPCS", frozenset())
                              | local.get("IDEMPOTENT_RPCS", frozenset())
                              | local.get("ACKED_RETRY_RPCS",
                                          frozenset()))
            non_retryable = local.get("NON_RETRYABLE_RPCS", frozenset())
        else:
            retry_safe, non_retryable = _protocol_sets(self.protocol)
        self._retry_safe = retry_safe
        self._classified = retry_safe | non_retryable
        self._walk(tree)
        return self.findings

    def _walk(self, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scope.append(child.name)
                self._fn_stack.append(child)
                self._check_retry_unsafe_calls(child)
                self._check_wall_clock(child)
                self._walk(child)
                self._fn_stack.pop()
                self._scope.pop()
                continue
            if isinstance(child, ast.ClassDef):
                self._scope.append(child.name)
                self._check_server_class(child)
                self._walk(child)
                self._scope.pop()
                continue
            if isinstance(child, (ast.For, ast.While)):
                self._check_serial_fanout(child)
            if isinstance(child, ast.Call):
                self._check_outbox_bypass(child)
            self._walk(child)

    # --------------------------------------------- handler classification

    def _check_server_class(self, cls: ast.ClassDef) -> None:
        handlers = [stmt for stmt in cls.body
                    if isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                    and stmt.name.startswith("rpc_")]
        if not handlers:
            return
        # Class-local declarations (servers outside the control plane —
        # test fixtures, plugin servers — declare their own methods
        # instead of growing protocol.py; the RTPU_DEBUG_RPC witness
        # honors the same attributes).
        local: Set[str] = set()
        local_safe: Set[str] = set()
        for stmt in cls.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id in (
                        "extra_retry_safe_rpcs", "extra_idempotent_rpcs",
                        "extra_non_retryable_rpcs"):
                val = stmt.value
                if isinstance(val, ast.Call) and val.args:
                    val = val.args[0]
                lit = _literal_strings(val)
                if lit:
                    local.update(lit)
                    if stmt.targets[0].id != "extra_non_retryable_rpcs":
                        local_safe.update(lit)
        for h in handlers:
            method = h.name[len("rpc_"):]
            if method not in self._classified and method not in local:
                self._emit(
                    "unclassified-rpc-handler", h,
                    f"handler '{h.name}' serves method '{method}' which "
                    "is in neither RETRY_SAFE_RPCS nor "
                    "NON_RETRYABLE_RPCS — declare its retry/idempotency "
                    "semantics in cluster/protocol.py (re-delivery and "
                    "blind chaos drops key on that contract)")
            elif (method.startswith("lease_block_")
                    and method not in self._retry_safe
                    and method not in local_safe):
                self._emit(
                    "retry-unsafe-block-rpc", h,
                    f"lease-block handler '{h.name}' is classified "
                    "non-retryable — block grant/renew/install/revoke "
                    "must be retry-safe (owners retry them and the "
                    "RTPU_DEBUG_RPC witness double-delivers them; a "
                    "non-idempotent grant double-installs admission "
                    "budget and leaks the lease census)")
        self._check_chaos_role(cls)

    def _check_chaos_role(self, cls: ast.ClassDef) -> None:
        for base in cls.bases:
            d = _dotted(base) or ""
            if d.rsplit(".", 1)[-1] in inv.CHAOS_ROLE_BASES:
                return  # base's __init__ sets the role
        for sub in ast.walk(cls):
            if isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Name) and \
                            tgt.id == "chaos_role":
                        return  # class attribute
                    if isinstance(tgt, ast.Attribute) and \
                            tgt.attr == "chaos_role" and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self":
                        return  # set in __init__
            elif isinstance(sub, ast.AnnAssign):
                tgt = sub.target
                if isinstance(tgt, ast.Name) and tgt.id == "chaos_role":
                    return
        self._emit(
            "missing-chaos-role", cls,
            f"RPC-handler class '{cls.name}' declares no chaos_role — "
            "role-targeted fault plans (kill:role=...:...) silently "
            "skip this server; set a class-level chaos_role")

    # ------------------------------------------------- retry-unsafe calls

    def _check_retry_unsafe_calls(self, fn) -> None:
        """Within one function: ``x.retrying_call("<m>", ...)`` with
        ``<m>`` not declared retry-safe. Constant method names are
        checked directly; a Name argument is resolved through simple
        same-function string bindings (including conditional ones)."""
        str_bindings: Dict[str, Set[str]] = {}
        calls: List[Tuple[ast.Call, ast.AST]] = []
        todo = list(ast.iter_child_nodes(fn))
        while todo:
            sub = todo.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Name):
                vals = self._possible_strings(sub.value)
                if vals:
                    str_bindings.setdefault(
                        sub.targets[0].id, set()).update(vals)
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr == "retrying_call" and sub.args:
                calls.append((sub, sub.args[0]))
            todo.extend(ast.iter_child_nodes(sub))
        for call, arg in calls:
            names: Set[str] = set()
            if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                            str):
                names = {arg.value}
            elif isinstance(arg, ast.Name):
                names = str_bindings.get(arg.id, set())
            for m in sorted(names):
                if m not in self._retry_safe:
                    self._emit(
                        "retry-unsafe-call", call,
                        f"retrying_call('{m}') but '{m}' is not in "
                        "RETRY_SAFE_RPCS — retrying re-delivers a "
                        "request whose handler never promised "
                        "at-most-once; classify the method or stop "
                        "retrying it")

    @staticmethod
    def _possible_strings(node: ast.AST) -> Set[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return {node.value}
        if isinstance(node, ast.IfExp):
            return (_DistLinter._possible_strings(node.body)
                    | _DistLinter._possible_strings(node.orelse))
        return set()

    # ------------------------------------------------- outbox discipline

    def _check_outbox_bypass(self, node: ast.Call) -> None:
        allowed = inv.OUTBOX_OWNER_MODULES.get(self.module)
        if allowed is None:
            return
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr in ("notify", "call", "retrying_call",
                                       "call_async")
                and node.args):
            return
        arg = node.args[0]
        if not (isinstance(arg, ast.Constant)
                and isinstance(arg.value, str)
                and arg.value in inv.OUTBOX_METHODS):
            return
        fn_scope = self._scope[-1] if self._scope else "<module>"
        if fn_scope in allowed:
            return
        self._emit(
            "direct-notify-bypasses-outbox", node,
            f"direct {node.func.attr}('{arg.value}') outside the "
            f"designated outbox sender ({'/'.join(sorted(allowed))}) — "
            "this frame can overtake the same process's still-queued "
            "add/remove of the same object (the stale-directory "
            "inversion); enqueue through the outbox instead")

    # --------------------------------------------------- serial fan-outs

    def _check_serial_fanout(self, loop) -> None:
        if self.module not in inv.DIST_FANOUT_MODULES:
            return
        # Walk THIS loop only; nested defs run on their own schedule
        # (and a thread target's blocking call is the concurrency FIX,
        # not the bug). A blocking call whose enclosing try's handlers
        # all EXIT the loop (break/return/raise) is escape-on-failure —
        # the loop cannot keep paying timeouts peer after peer, which
        # is the shape this rule hunts (the census caught, logged,
        # and CONTINUED to the next dead node).
        found: List[Tuple[str, bool]] = []  # (label, guarded)
        concurrent = [False]

        def handler_exits(t: ast.Try) -> bool:
            if not t.handlers:
                return False
            return all(any(isinstance(s, (ast.Break, ast.Return,
                                          ast.Raise))
                           for s in ast.walk(h))
                       for h in t.handlers)

        def scan(n: ast.AST, guarded: bool) -> None:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                return
            if isinstance(n, ast.Try):
                g = guarded or handler_exits(n)
                for s in n.body:
                    scan(s, g)
                for h in n.handlers:
                    for s in h.body:
                        scan(s, guarded)
                for s in list(n.orelse) + list(n.finalbody):
                    scan(s, guarded)
                return
            if isinstance(n, ast.Call):
                if isinstance(n.func, ast.Attribute):
                    attr = n.func.attr
                    dotted = _dotted(n.func) or ""
                    if attr in inv.FANOUT_RPC_ATTRS:
                        found.append((f".{attr}()", guarded))
                    if attr in inv.FANOUT_CONCURRENCY_ATTRS or \
                            dotted.endswith(inv.FANOUT_THREAD_SUFFIXES):
                        concurrent[0] = True
                elif isinstance(n.func, ast.Name) and \
                        n.func.id.endswith(inv.FANOUT_THREAD_SUFFIXES):
                    concurrent[0] = True
            for c in ast.iter_child_nodes(n):
                scan(c, guarded)

        for stmt in loop.body:
            scan(stmt, False)
        unguarded = [label for label, guarded in found if not guarded]
        if not unguarded or concurrent[0]:
            return
        blocking = unguarded[0]
        if self._loop_bounded(loop):
            return
        self._emit(
            "serial-fanout-no-deadline", loop,
            f"loop issues blocking {blocking} per peer with no total "
            "deadline, bounded iteration, or concurrency — N mid-death "
            "peers x one control timeout each outruns every caller's "
            "deadline (the rpc_cluster_leases bug); add a total "
            "deadline or fan out concurrently")

    def _loop_bounded(self, loop) -> bool:
        """Bounded-total evidence: a constant-``range`` iteration, or a
        deadline-ish name / monotonic clock read anywhere in the
        ENCLOSING function (the bound usually lives just outside the
        loop, as in _create_pg_inner)."""
        if isinstance(loop, ast.For) and isinstance(loop.iter, ast.Call):
            d = _dotted(loop.iter.func) or ""
            if d == "range" and all(
                    isinstance(a, ast.Constant) for a in loop.iter.args):
                return True
        scope = self._fn_stack[-1] if self._fn_stack else loop
        for sub in ast.walk(scope):
            if isinstance(sub, ast.Call):
                d = _dotted(sub.func) or ""
                if d in inv.RETRY_DEADLINE_CALLS:
                    # time.time counts as a bound here: using the wrong
                    # CLOCK is the wall-clock-deadline rule's report,
                    # not a second fan-out finding on the same loop.
                    return True
            name = None
            if isinstance(sub, ast.Name):
                name = sub.id
            elif isinstance(sub, ast.Attribute):
                name = sub.attr
            if name is not None and \
                    inv.RETRY_DEADLINE_NAME_RE.search(name):
                return True
        return False

    # ---------------------------------------------- wall-clock deadlines

    @staticmethod
    def _has_wall_clock_call(node: ast.AST) -> Optional[ast.Call]:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                d = _dotted(sub.func) or ""
                if d in ("time.time", "_time.time") or \
                        d.endswith(".time.time"):
                    return sub
        return None

    @staticmethod
    def _has_deadline_name(node: ast.AST) -> Optional[str]:
        for sub in ast.walk(node):
            name = None
            if isinstance(sub, ast.Name):
                name = sub.id
            elif isinstance(sub, ast.Attribute):
                name = sub.attr
            if name is not None and \
                    inv.WALLCLOCK_DEADLINE_NAME_RE.search(name):
                return name
        return None

    def _check_wall_clock(self, fn) -> None:
        """``time.time()`` feeding deadline arithmetic: assigned to a
        deadline-ish name, or sharing a BinOp/Compare with one. Bare
        timestamping (``t0 = time.time()``, span emission) is exempt."""
        flagged: Set[int] = set()

        def flag(call: ast.Call, how: str) -> None:
            if id(call) in flagged:
                return
            flagged.add(id(call))
            self._emit(
                "wall-clock-deadline", call,
                f"time.time() {how} — wall clock jumps under NTP steps; "
                "deadline/timeout arithmetic must use time.monotonic() "
                "(epoch timestamps for cross-process stamps are exempt "
                "and unflagged)")

        todo = list(ast.iter_child_nodes(fn))
        while todo:
            sub = todo.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(sub, ast.Assign):
                call = self._has_wall_clock_call(sub.value)
                if call is not None:
                    for tgt in sub.targets:
                        d = _dotted(tgt)
                        leaf = d.rsplit(".", 1)[-1] if d else None
                        if leaf is not None and \
                                inv.WALLCLOCK_DEADLINE_NAME_RE.search(
                                    leaf):
                            flag(call, f"assigned to deadline-like "
                                       f"name '{leaf}'")
            if isinstance(sub, ast.BinOp):
                for side, other in ((sub.left, sub.right),
                                    (sub.right, sub.left)):
                    call = self._has_wall_clock_call(side)
                    if call is not None:
                        name = self._has_deadline_name(other)
                        if name is not None:
                            flag(call, f"in arithmetic with "
                                       f"deadline-like name '{name}'")
            if isinstance(sub, ast.Compare):
                operands = [sub.left] + list(sub.comparators)
                for i, side in enumerate(operands):
                    call = self._has_wall_clock_call(side)
                    if call is None:
                        continue
                    for j, other in enumerate(operands):
                        if j == i:
                            continue
                        name = self._has_deadline_name(other)
                        if name is not None:
                            flag(call, f"compared against "
                                       f"deadline-like name '{name}'")
            todo.extend(ast.iter_child_nodes(sub))


def lint_source(source: str, module: str, path: str,
                tree: Optional[ast.AST] = None,
                package: str = inv.PACKAGE,
                protocol: Optional[str] = None) -> List[Finding]:
    """Run the dist rule family over one module's source. ``tree``
    reuses a caller-side parse (lint_paths parses once per file for
    every family); ``protocol`` is the protocol.py path whose sets
    classify handlers (the port's own by default)."""
    return _DistLinter(module, path, source, package, protocol).run(tree)
