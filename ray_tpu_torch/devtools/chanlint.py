"""chan-lint: channel-protocol rules (rule family ``chan``),
``ray_tpu/devtools/chanlint.py``'s rules over the port.

Stdlib-only AST analysis riding rtpu-lint's fingerprint/baseline/
``# rtpu-lint: disable=<rule>`` machinery. The pre-negotiated channel
plane (``dag/ring.py`` shm SPSC rings, ``dag/peer.py`` peer sockets,
the pickle-5 scatter frames both carry) became the hot data path in
``ray_tpu`` — and every real bug it then found lived there. Every rule
codifies one of those bug classes; the runtime half is
``devtools/chan_debug.py`` (``RTPU_DEBUG_CHAN=1``).

  chan-cursor-publish-order
      a ring writer that publishes the write cursor (``_set_u64``
      with a wpos-flavored offset, or a wpos-named attribute store)
      BEFORE the payload memcpy into the mmap. The SPSC ring's only
      memory-ordering contract is publish-after-fill; a reordered
      publish hands the reader a cursor over garbage bytes.
  chan-spill-pin-unreleased
      a teardown path (close/stop/shutdown/...) that unlinks spill
      side-files with no consumption evidence (settle helper, rpos
      check, reclaim grace, rename-claim) in the function — the exact
      ``_spill_in`` race: writer close reclaimed a file the
      reader was still opening.
  chan-ack-before-consume
      a reader that sends the consumption ack BEFORE the application
      dequeues the frame from the inbox — the credit window then
      bounds socket receipt, not application consumption, and a slow
      consumer overruns its own bounded inbox.
  chan-raw-seq-send
      a ``write``/``write_error``/``write_stop`` carrying an explicit
      seq on a channel-ish receiver outside the auto-seq facades
      (``CHAN_SEQ_EXEMPT_MODULES``): hand-minted seqs are how gaps
      and duplicates ship (the witness sees them as send-seq-gap).
  chan-register-without-unregister
      a module that RPCs ``channel_register`` but never
      ``channel_unregister`` anywhere: dead channels pin directory
      entries on the head forever and writers dial corpses.
  chan-dial-without-liveness
      a transport class (``CHAN_TRANSPORT_MODULES``) dialing with
      ``create_connection`` and no _GONE/liveness handling anywhere
      in the class: a dial with no death branch spins forever on a
      torn-down reader.
  chan-blocking-op-no-deadline
      a channel ``read``/``recv`` with no timeout argument and no
      deadline evidence in the enclosing function — a dead peer turns
      the caller into a zombie (the channel analog of dist-lint's
      serial-fanout-no-deadline).
  chan-mutate-after-send
      a buffer handed to a channel send and then mutated in the same
      function (subscript store, augmented assign, or a mutating
      method). Sends are zero-copy — pickle-5 out-of-band views and
      ring spills alias the caller's memory, so the mutation races
      the reader's view of the frame. The witness catches surviving
      instances empirically via sampled frame checksums.

``lint_source(source, module, path)`` returns ``lint.Finding`` rows;
module-scoped tables live in ``invariants.py``.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Tuple

from ray_tpu_torch.devtools import invariants as inv
# CHAN_RULES is single-sourced in lint.py (the family/baseline
# machinery keys on it); aliased here so rule code and rule registry
# can't drift.
from ray_tpu_torch.devtools.lint import (CHAN_RULES as RULES, Finding, _dotted,
                                   suppressed)

_CLOSE_NAME_RE = re.compile(
    r"(close|shutdown|stop|teardown|__exit__|__del__)")
_UNLINK_NAMES = {"unlink", "remove"}
_SEND_ATTRS = {"write", "send"}
_RAW_SEQ_ATTRS = {"write", "write_error", "write_stop"}
_RPC_SEND_ATTRS = {"retrying_call", "call", "notify"}


def _receiver_dotted(func: ast.AST) -> Optional[str]:
    """Dotted form of an attribute-call's receiver, looking through a
    subscript (``self._channels[key].write`` -> ``self._channels``)."""
    if not isinstance(func, ast.Attribute):
        return None
    base = func.value
    d = _dotted(base)
    if d is None and isinstance(base, ast.Subscript):
        d = _dotted(base.value)
    if d is None and isinstance(base, ast.Call):
        d = _dotted(base.func)
    return d


def _channelish(func: ast.AST) -> bool:
    d = _receiver_dotted(func)
    if not d:
        return False
    return any(inv.CHAN_RECEIVER_RE.search(part)
               for part in d.split("."))


class _ChanLinter:
    def __init__(self, module: str, path: str, source: str,
                 package: str = inv.PACKAGE):
        self.module = inv.module_key(module, package)
        self.path = path
        self.lines = source.splitlines()
        self.findings: List[Finding] = []
        self._scope: List[str] = []
        self._fn_stack: List[ast.AST] = []

    # ------------------------------------------------------------ utils

    def _emit(self, rule: str, node: ast.AST, message: str,
              scope: Optional[str] = None) -> None:
        assert rule in RULES, f"unregistered chan rule id {rule!r}"
        line = getattr(node, "lineno", 1)
        if suppressed(self.lines, line, rule):
            return
        self.findings.append(Finding(
            rule, self.path, line,
            scope if scope is not None else ".".join(self._scope),
            message))

    def _src(self, node: ast.AST) -> str:
        lo = getattr(node, "lineno", 1) - 1
        hi = getattr(node, "end_lineno", lo + 1)
        return "\n".join(self.lines[lo:hi])

    # ------------------------------------------------------------- walk

    def run(self, tree: Optional[ast.AST] = None) -> List[Finding]:
        if tree is None:
            try:
                tree = ast.parse("\n".join(self.lines),
                                 filename=self.path)
            except SyntaxError:
                return []  # the concurrency family reports this
        self._check_register_lifecycle(tree)
        self._walk(tree)
        return self.findings

    def _walk(self, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scope.append(child.name)
                self._fn_stack.append(child)
                self._check_cursor_publish_order(child)
                self._check_spill_pin(child)
                self._check_ack_before_consume(child)
                self._check_mutate_after_send(child)
                self._walk(child)
                self._fn_stack.pop()
                self._scope.pop()
                continue
            if isinstance(child, ast.ClassDef):
                self._scope.append(child.name)
                self._check_dial_liveness(child)
                self._walk(child)
                self._scope.pop()
                continue
            if isinstance(child, ast.Call):
                self._check_raw_seq_send(child)
                self._check_blocking_op(child)
            self._walk(child)

    # --------------------------------------------- cursor publish order

    def _check_cursor_publish_order(
            self, fn: ast.AST) -> None:
        fills: List[int] = []
        pubs: List[Tuple[int, ast.AST]] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    # payload memcpy: mm[a:b] = ...
                    if isinstance(tgt, ast.Subscript):
                        d = _dotted(tgt.value) or ""
                        last = d.rsplit(".", 1)[-1]
                        if inv.CHAN_MM_NAME_RE.search(last):
                            fills.append(node.lineno)
                    # cursor store as attribute: self._wpos = ...
                    elif isinstance(tgt, ast.Attribute) and \
                            inv.CHAN_CURSOR_PUBLISH_RE.search(tgt.attr):
                        pubs.append((node.lineno, node))
            elif isinstance(node, ast.Call):
                d = _dotted(node.func) or ""
                last = d.rsplit(".", 1)[-1]
                if last == "pack_into" and len(node.args) >= 2:
                    arg_d = _dotted(node.args[1]) or ""
                    arg_last = arg_d.rsplit(".", 1)[-1]
                    if inv.CHAN_MM_NAME_RE.search(arg_last):
                        fills.append(node.lineno)
                elif last.endswith("_set_u64") or last == "set_u64":
                    if node.args:
                        off = (_dotted(node.args[0]) or "")
                        if inv.CHAN_CURSOR_PUBLISH_RE.search(off):
                            pubs.append((node.lineno, node))
        if not fills or not pubs:
            return
        first_pub_line, pub_node = min(pubs, key=lambda p: p[0])
        if first_pub_line < max(fills):
            self._emit(
                "chan-cursor-publish-order", pub_node,
                "write cursor published before the payload fill "
                f"completes (publish at line {first_pub_line}, fill at "
                f"line {max(fills)}) — the reader observes a cursor "
                "over garbage bytes; publish AFTER the memcpy")

    # ------------------------------------------------- spill pin pairing

    def _check_spill_pin(self, fn: ast.AST) -> None:
        if not _CLOSE_NAME_RE.search(fn.name):
            return
        touches_spill = any(
            isinstance(n, ast.Attribute)
            and inv.CHAN_SPILL_ATTR_RE.search(n.attr)
            for n in ast.walk(fn))
        if not touches_spill:
            return
        unlinks = [n for n in ast.walk(fn)
                   if isinstance(n, ast.Call)
                   and (_dotted(n.func) or "").rsplit(".", 1)[-1]
                   in _UNLINK_NAMES]
        if not unlinks:
            return
        if inv.CHAN_SETTLE_EVIDENCE_RE.search(self._src(fn)):
            return
        self._emit(
            "chan-spill-pin-unreleased", unlinks[0],
            f"{fn.name} reclaims spill side-files with no consumption "
            "evidence (no settle/rpos check, no reclaim grace, no "
            "rename-claim) — the reader's _spill_in may still open the "
            "file this unlink destroys (the _spill_in race)")

    # ------------------------------------------------ ack before consume

    def _check_ack_before_consume(self, fn: ast.AST) -> None:
        gets: List[int] = []
        acks: List[Tuple[int, ast.AST]] = []
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            if node.func.attr == "get":
                d = _receiver_dotted(node.func) or ""
                if any(inv.CHAN_INBOX_NAME_RE.search(part)
                       for part in d.split(".")):
                    gets.append(node.lineno)
            elif node.func.attr == "ack":
                acks.append((node.lineno, node))
        if not gets or not acks:
            return
        first_ack_line, ack_node = min(acks, key=lambda a: a[0])
        if first_ack_line < min(gets):
            self._emit(
                "chan-ack-before-consume", ack_node,
                "consumption ack sent before the application dequeues "
                "the frame — the credit window stops bounding "
                "unconsumed frames and a slow consumer overruns its "
                "bounded inbox")

    # ---------------------------------------------------- raw seq sends

    def _check_raw_seq_send(self, call: ast.Call) -> None:
        func = call.func
        if not (isinstance(func, ast.Attribute)
                and func.attr in _RAW_SEQ_ATTRS):
            return
        if self.module in inv.CHAN_SEQ_EXEMPT_MODULES:
            return
        if not _channelish(func):
            return
        nargs = len(call.args)
        carries_seq = (
            (func.attr == "write" and nargs >= 2)
            or (func.attr == "write_error" and nargs >= 2)
            or (func.attr == "write_stop" and nargs >= 1)
            or any(kw.arg == "seq" for kw in call.keywords))
        if not carries_seq:
            return
        self._emit(
            "chan-raw-seq-send", call,
            f"explicit seq passed to .{func.attr}() outside the "
            "auto-seq facades — hand-minted seqs ship gaps/duplicates "
            "(route through ChannelWriter, or add the module to "
            "CHAN_SEQ_EXEMPT_MODULES if it IS a facade)")

    # ------------------------------------------------ register lifecycle

    def _check_register_lifecycle(self, tree: ast.AST) -> None:
        register: Optional[ast.Call] = None
        has_unregister = False
        for node in ast.walk(tree):
            # an RPC-shaped send whose first arg is the method name
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _RPC_SEND_ATTRS
                    and node.args):
                continue
            arg0 = node.args[0]
            if not (isinstance(arg0, ast.Constant)
                    and isinstance(arg0.value, str)):
                continue
            if arg0.value == "channel_register" and register is None:
                register = node
            elif arg0.value == "channel_unregister":
                has_unregister = True
        if register is not None and not has_unregister:
            self._emit(
                "chan-register-without-unregister", register,
                "module RPCs channel_register but never "
                "channel_unregister — dead channels pin directory "
                "entries on the head and writers dial corpses",
                scope="")

    # ---------------------------------------------------- dial liveness

    def _check_dial_liveness(self, cls: ast.ClassDef) -> None:
        if self.module not in inv.CHAN_TRANSPORT_MODULES:
            return
        dials = [n for n in ast.walk(cls)
                 if isinstance(n, ast.Call)
                 and (_dotted(n.func) or "").rsplit(".", 1)[-1]
                 == "create_connection"]
        if not dials:
            return
        if inv.CHAN_LIVENESS_RE.search(self._src(cls)):
            return
        self._emit(
            "chan-dial-without-liveness", dials[0],
            f"{cls.name} dials peers but has no _GONE/liveness "
            "handling anywhere in the class — a dial with no death "
            "branch spins forever on a torn-down reader")

    # ------------------------------------------------------ blocking ops

    def _check_blocking_op(self, call: ast.Call) -> None:
        func = call.func
        if not (isinstance(func, ast.Attribute)
                and func.attr in ("read", "recv")):
            return
        if not _channelish(func):
            return
        if any(kw.arg == "timeout" for kw in call.keywords):
            return
        # A second positional to read() (after seq) is the timeout.
        max_pos = 1 if func.attr == "read" else 0
        if len(call.args) > max_pos:
            return
        fn = self._fn_stack[-1] if self._fn_stack else None
        if fn is not None and inv.RETRY_DEADLINE_NAME_RE.search(
                self._src(fn)):
            return
        self._emit(
            "chan-blocking-op-no-deadline", call,
            f"channel .{func.attr}() with no timeout and no deadline "
            "in the enclosing function — a dead peer turns this "
            "caller into a zombie")

    # ------------------------------------------------- mutate after send

    def _check_mutate_after_send(self, fn: ast.AST) -> None:
        # buffer name -> first send line
        sent: dict = {}
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SEND_ATTRS):
                continue
            if not _channelish(node.func):
                continue
            for arg in node.args:
                if isinstance(arg, ast.Name):
                    sent.setdefault(arg.id, node.lineno)
        if not sent:
            return
        for node in ast.walk(fn):
            line = getattr(node, "lineno", 0)
            name = None
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript) and \
                            isinstance(tgt.value, ast.Name):
                        name = tgt.value.id
            elif isinstance(node, ast.AugAssign):
                tgt = node.target
                if isinstance(tgt, ast.Subscript) and \
                        isinstance(tgt.value, ast.Name):
                    name = tgt.value.id
                elif isinstance(tgt, ast.Name):
                    name = tgt.id
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in inv.CHAN_MUTATING_ATTRS and \
                    isinstance(node.func.value, ast.Name):
                name = node.func.value.id
            if name is not None and name in sent \
                    and line > sent[name]:
                self._emit(
                    "chan-mutate-after-send", node,
                    f"buffer {name!r} mutated after being handed to a "
                    f"channel send at line {sent[name]} — sends are "
                    "zero-copy (pickle-5 out-of-band / ring spill "
                    "views alias this memory), so the mutation races "
                    "the reader (copy first, or mutate before "
                    "sending)")


def lint_source(source: str, module: str, path: str,
                tree: Optional[ast.AST] = None,
                package: str = inv.PACKAGE) -> List[Finding]:
    return _ChanLinter(module, path, source, package).run(tree)
