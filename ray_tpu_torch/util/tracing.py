"""Distributed tracing: spans that follow tasks across processes
(``ray_tpu/util/tracing.py``).

Parity target: the reference's opt-in OpenTelemetry integration
(reference: python/ray/util/tracing/tracing_helper.py — monkeypatched
submit/execute hooks propagating a trace context through task metadata)
re-designed in-runtime: when ``tracing_enabled`` is on, every task spec
carries its submitter's (trace_id, span_id); executors open a child span
around the user function, and finished spans flush to the head's trace
ring. ``get_trace`` assembles the cross-process tree; ``to_chrome_trace``
renders it for chrome://tracing (alongside util/timeline.py's scheduler-
level events).

    from ray_tpu_torch.util import tracing
    with tracing.trace("pipeline-run") as t:
        ray_tpu_torch.get(step.remote(x))      # worker spans parent to this one
    spans = tracing.get_trace(t.trace_id)
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

# ContextVar, not threading.local: concurrent asyncio coroutines on one
# event-loop thread must not cross-contaminate span parentage (same reason
# core/runtime_context uses ContextVar for the worker context).
_current_span: "contextvars.ContextVar[Optional[Dict[str, Any]]]" = \
    contextvars.ContextVar("rtpu_span", default=None)
_buffer: List[Dict[str, Any]] = []
_buffer_lock = threading.Lock()
_FLUSH_AT = 64
# Runtime-less processes (node managers) register an explicit flush sink
# so their spans (e.g. pull-manager per-holder fetches) still reach the
# head's trace ring.
_sink: Optional[Callable[[list], None]] = None


def enabled() -> bool:
    return bool(cfg.tracing_enabled)


def current() -> Optional[Dict[str, str]]:
    """The active span's wire context {trace_id, span_id}, or None."""
    span = _current_span.get()
    if span is None:
        return None
    return {"trace_id": span["trace_id"], "span_id": span["span_id"]}


def _record(span: Dict[str, Any]) -> None:
    with _buffer_lock:
        _buffer.append(span)
        flush_now = len(_buffer) >= _FLUSH_AT
    if flush_now:
        flush()


def set_sink(sink: Optional[Callable[[list], None]]) -> None:
    """Register a flush destination for processes with no runtime (node
    managers): called with the span batch instead of the runtime's head
    client."""
    global _sink
    _sink = sink


def flush() -> None:
    """Ship buffered spans to the head (best-effort; spans are telemetry)."""
    with _buffer_lock:
        spans, _buffer[:] = list(_buffer), []
    if not spans:
        return
    try:
        from ray_tpu_torch.core.runtime_context import get_runtime

        rt = get_runtime()
        if rt is None or not hasattr(rt, "head"):
            if _sink is not None:
                _sink(spans)
            return
        # Tag the span batch with this process's node id so trace_dump
        # can apply that node's clock offset when merging clusters whose
        # hosts disagree on wall time.
        nid = getattr(rt, "node_id", None)
        if nid:
            for s in spans:
                s.setdefault("node", nid)
        rt.head.notify("trace_spans", spans)
    except Exception:
        pass


class _SpanHandle:
    def __init__(self, span: Dict[str, Any]):
        self._span = span
        self.trace_id = span["trace_id"]
        self.span_id = span["span_id"]

    def set_attribute(self, key: str, value: Any) -> None:
        self._span["attrs"][key] = value


@contextlib.contextmanager
def trace(name: str, attrs: Optional[Dict[str, Any]] = None):
    """Open a ROOT span (a fresh trace id). No-op handle when disabled."""
    with _span_impl(name, attrs, new_trace=True) as h:
        yield h


@contextlib.contextmanager
def span(name: str, attrs: Optional[Dict[str, Any]] = None):
    """Open a child span of the current context (or a root if none)."""
    with _span_impl(name, attrs, new_trace=False) as h:
        yield h


@contextlib.contextmanager
def _span_impl(name, attrs, new_trace: bool,
               remote_parent: Optional[Dict[str, str]] = None):
    if not enabled():
        yield _SpanHandle({"trace_id": "", "span_id": "", "attrs": {}})
        return
    parent = _current_span.get()
    if remote_parent is not None:
        trace_id = remote_parent["trace_id"]
        parent_id = remote_parent["span_id"]
    elif parent is not None and not new_trace:
        trace_id = parent["trace_id"]
        parent_id = parent["span_id"]
    else:
        trace_id = uuid.uuid4().hex[:16]
        parent_id = ""
    rec = {
        "trace_id": trace_id,
        "span_id": uuid.uuid4().hex[:16],
        "parent_id": parent_id,
        "name": name,
        "start": time.time(),
        "end": None,
        "attrs": dict(attrs or {}),
        "ok": True,
        "pid": os.getpid(),
    }
    token = _current_span.set(rec)
    try:
        yield _SpanHandle(rec)
    except BaseException:
        rec["ok"] = False
        raise
    finally:
        rec["end"] = time.time()
        _current_span.reset(token)
        _record(rec)


@contextlib.contextmanager
def remote_span(name: str, wire_ctx: Optional[Dict[str, str]]):
    """Executor-side: a span parented to a context that crossed the wire
    (the task spec's trace field). Used by the worker runtime."""
    with _span_impl(name, None, new_trace=False,
                    remote_parent=wire_ctx) as h:
        yield h


# -------------------------------------------------- manual / hot-path API
#
# The context-manager API owns the ContextVar parentage; hot paths (the
# engine's per-chunk accounting, dispatcher threads pairing tasks with
# leases) instead record FINISHED spans with explicit parents and their
# own measured timestamps — no ContextVar traffic, no allocation at all
# when tracing is off (callers gate on a None wire context).


def _new_rec(name: str, parent: Optional[Dict[str, str]],
             attrs: Optional[Dict[str, Any]], start: float,
             end: Optional[float], ok: bool) -> Dict[str, Any]:
    """One span record shape for the whole manual API: parent falls
    back to the calling thread's current span; no parent starts a
    fresh trace."""
    if parent is None:
        parent = current()
    if parent is not None and parent.get("trace_id"):
        trace_id, parent_id = parent["trace_id"], parent["span_id"]
    else:
        trace_id, parent_id = uuid.uuid4().hex[:16], ""
    return {
        "trace_id": trace_id,
        "span_id": uuid.uuid4().hex[:16],
        "parent_id": parent_id,
        "name": name,
        "start": start,
        "end": end,
        "attrs": dict(attrs or {}),
        "ok": ok,
        "pid": os.getpid(),
    }


def emit_span(name: str, start: float, end: float,
              parent: Optional[Dict[str, str]] = None,
              attrs: Optional[Dict[str, Any]] = None,
              ok: bool = True) -> Optional[Dict[str, str]]:
    """Record a completed span [start, end] (wall-clock seconds).
    ``parent`` is a wire context ({trace_id, span_id}); None falls back
    to the calling thread's current span, and a missing parent starts a
    fresh trace. Returns the new span's wire context (for chaining)."""
    if not enabled():
        return None
    rec = _new_rec(name, parent, attrs, start, end, ok)
    _record(rec)
    return {"trace_id": rec["trace_id"], "span_id": rec["span_id"]}


def start_span(name: str, parent: Optional[Dict[str, str]] = None,
               attrs: Optional[Dict[str, Any]] = None
               ) -> Optional[Dict[str, Any]]:
    """Open a manually-managed span (no ContextVar): returns the record,
    finish it with ``end_span``. For request lifecycles that span
    threads/event loops (the serve proxy)."""
    if not enabled():
        return None
    return _new_rec(name, parent, attrs, time.time(), None, True)


def end_span(rec: Optional[Dict[str, Any]], ok: bool = True) -> None:
    """Close + record a ``start_span`` record. None-safe (tracing off)."""
    if rec is None:
        return
    rec["end"] = time.time()
    if not ok:
        rec["ok"] = False
    _record(rec)


def ctx_of(rec: Optional[Dict[str, Any]]) -> Optional[Dict[str, str]]:
    """The wire context of a ``start_span`` record (None-safe)."""
    if rec is None:
        return None
    return {"trace_id": rec["trace_id"], "span_id": rec["span_id"]}


@contextlib.contextmanager
def attach(wire_ctx: Optional[Dict[str, str]]):
    """Re-enter a wire context on THIS thread without recording a span:
    child spans opened inside parent to it. Needed where ContextVars
    don't propagate (run_in_executor hops in the serve proxy)."""
    if not enabled() or not wire_ctx:
        yield
        return
    token = _current_span.set({"trace_id": wire_ctx["trace_id"],
                               "span_id": wire_ctx["span_id"],
                               "attrs": {}})
    try:
        yield
    finally:
        _current_span.reset(token)


# ---------------------------------------------------------------- queries


def get_trace(trace_id: str, timeout: float = 10.0) -> List[Dict[str, Any]]:
    """All spans of a trace collected at the head (flushes local first)."""
    from ray_tpu_torch.core.runtime_context import require_runtime

    flush()
    rt = require_runtime()
    return rt.head.retrying_call("get_trace", trace_id, timeout=timeout)


def to_chrome_trace(trace_id: str, path: Optional[str] = None):
    """Render one trace as chrome://tracing JSON (one row per span name)."""
    import json

    spans = get_trace(trace_id)
    events = []
    for s in spans:
        events.append({
            "name": s["name"], "ph": "X", "pid": "trace",
            "tid": s["name"].split(":")[0],
            "ts": s["start"] * 1e6,
            "dur": max(((s["end"] or s["start"]) - s["start"]) * 1e6, 1),
            "args": dict(s.get("attrs") or {},
                         span_id=s["span_id"], parent=s["parent_id"],
                         ok=s.get("ok", True)),
        })
    if path:
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
    return events
