"""Replica actor: hosts one copy of a deployment's user callable
(``ray_tpu/serve/_private/replica.py``). Under ``RTPU_DEBUG_RES=1`` every
open stream cursor slot is a ``serve_stream`` entry of the resource
witness, settled on completion, error, cancel or the TTL reaper.

Parity target: reference python/ray/serve/_private/replica.py (ReplicaActor
:883, UserCallableWrapper :1125) — constructs the user class once, serves
`handle_request`, and tracks its own ongoing-request gauge (the signal the
pow-2 router and the autoscaler consume). When the runtime kills the
replica it calls the user callable's ``__del__``, as the reference's
replica shutdown does, so a callable that owns threads stops them.
"""

from __future__ import annotations

import logging
import queue as _queue_mod
import threading
import time
import uuid
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch.devtools import res_debug as _resdbg

_logger = logging.getLogger(__name__)

# Per-request serve context (multiplexed model id, ...). A ContextVar so
# asyncio deployments interleave safely too.
import contextvars

_request_context: "contextvars.ContextVar[Optional[dict]]" = (
    contextvars.ContextVar("rtpu_serve_request_ctx", default=None))


def get_request_context() -> dict:
    return _request_context.get() or {}


class ReplicaActor:
    def __init__(self, cls, init_args: tuple, init_kwargs: Dict[str, Any]):
        self._callable = cls(*init_args, **init_kwargs)
        self._ongoing = 0
        self._total = 0
        from ray_tpu_torch.devtools.lock_debug import make_lock

        self._lock = make_lock("serve.replica._lock")
        self._started = time.time()
        # Live response streams: stream_id -> [queue, cancelled_event,
        # last_poll_monotonic] (a drain thread pulls the user generator so
        # cursor polls never block on it). Streams abandoned without a
        # cancel (client crash) are reaped after _STREAM_TTL_S idle.
        self._streams: Dict[str, list] = {}
        self._stream_errors: Dict[str, BaseException] = {}
        # Request-rate window for autoscaling decisions.
        self._window: list = []

    def _resolve_target(self, method: str):
        target = (self._callable if method == "__call__"
                  else getattr(self._callable, method))
        if method == "__call__" and not callable(self._callable):
            raise TypeError(
                f"{type(self._callable).__name__} is not callable; "
                f"route to a named method instead")
        return target

    def handle_request(self, method: str, args: tuple,
                       kwargs: Dict[str, Any],
                       context: Optional[Dict[str, Any]] = None):
        with self._lock:
            self._ongoing += 1
            self._total += 1
            now = time.time()
            self._window.append(now)
            if len(self._window) > 1000:
                self._window = self._window[-500:]
        token = _request_context.set(context or {})
        # Serve-path trace propagation: the handle ships the request's
        # wire span context in the request context dict; the replica
        # span wraps the user callable so engine spans (opened on this
        # thread) parent under it. None when tracing is off.
        wire = (context or {}).get("trace")
        try:
            if wire is not None:
                from ray_tpu_torch.util import tracing as _tracing

                with _tracing.remote_span(f"serve.replica:{method}",
                                          wire):
                    result = self._resolve_target(method)(*args, **kwargs)
                _tracing.flush()
                return result
            return self._resolve_target(method)(*args, **kwargs)
        finally:
            _request_context.reset(token)
            with self._lock:
                self._ongoing -= 1

    # ------------------------------------------------------------ streaming

    def handle_request_streaming(self, method: str, args: tuple,
                                 kwargs: Dict[str, Any],
                                 context: Optional[Dict[str, Any]] = None,
                                 first_wait_s: float = 1.0,
                                 ) -> Tuple[str, list, bool]:
        """Start a streaming call: the user method must return an
        iterator/generator. Returns ``(sid, items, done)`` — the first
        chunk piggybacks on the start RPC (bounded by ``first_wait_s``)
        so streaming TTFT costs ONE actor round trip, same as a
        non-streaming call; later chunks ride next_chunks cursor polls
        (reference: streaming responses flow as ObjectRefGenerators;
        here the cursor rides the actor plane). A first token slower
        than ``first_wait_s`` returns an empty chunk and the consumer
        falls back to polling — never an error."""
        self._reap_stale_streams()
        target = self._resolve_target(method)
        sid = uuid.uuid4().hex
        buf: "_queue_mod.Queue" = _queue_mod.Queue()
        cancelled = threading.Event()
        self._streams[sid] = [buf, cancelled, time.monotonic()]
        # RTPU_DEBUG_RES: every open cursor slot must be settled by
        # completion, error, cancel, or the TTL reaper — the balance
        # the leak witness asserts after a stream-cancel loop.
        _resdbg.note_acquire("serve_stream", key=(id(self), sid),
                             owner=self, note="stream_open")
        ctx = context or {}

        def drain():
            with self._lock:
                self._ongoing += 1
                self._total += 1
                self._window.append(time.time())
            token = _request_context.set(ctx)
            gen = None
            # Streaming trace propagation: the replica span covers the
            # whole generator drain; engine streams started inside it
            # (generate_stream) capture it as their parent.
            wire = ctx.get("trace")
            try:
                import contextlib as _cl

                with _cl.ExitStack() as stack:
                    if wire is not None:
                        from ray_tpu_torch.util import tracing as _tracing

                        stack.enter_context(_tracing.remote_span(
                            f"serve.replica:{method}", wire))
                    gen = target(*args, **kwargs)
                    for item in gen:
                        if cancelled.is_set():
                            break  # stop consuming/computing on cancel
                        buf.put(("item", item))
                buf.put(("done", None))
            except BaseException as e:  # noqa: BLE001 -> surfaced to caller
                buf.put(("error", e))
            finally:
                if cancelled.is_set() and hasattr(gen, "close"):
                    try:
                        gen.close()
                    except Exception:
                        pass
                if wire is not None:
                    from ray_tpu_torch.util import tracing as _tracing

                    _tracing.flush()
                _request_context.reset(token)
                with self._lock:
                    self._ongoing -= 1

        threading.Thread(target=drain, daemon=True,
                         name=f"serve-stream-{sid[:8]}").start()
        if first_wait_s <= 0:
            return sid, [], False
        # Same semantics as the consumer's first next_chunks poll —
        # including raising a pre-first-token stream error here, which
        # the caller surfaces exactly like a failed poll.
        items, done = self.next_chunks(sid, wait_s=first_wait_s)
        return sid, items, done

    _STREAM_TTL_S = 600.0

    def _settle_stream(self, sid: str) -> None:
        """Settle the witness ledger at every cursor-slot drop site
        (done / error / cancel / TTL reap). Idempotent — re-entered
        release paths must never turn into a false report."""
        _resdbg.note_release("serve_stream", (id(self), sid))

    def _reap_stale_streams(self) -> None:
        now = time.monotonic()
        for sid, entry in list(self._streams.items()):
            if now - entry[2] > self._STREAM_TTL_S:
                entry[1].set()
                self._streams.pop(sid, None)
                self._stream_errors.pop(sid, None)
                self._settle_stream(sid)

    def next_chunks(self, sid: str, max_items: int = 64,
                    wait_s: float = 10.0) -> Tuple[list, bool]:
        """Cursor poll: blocks up to wait_s for the first item, then
        drains whatever else is ready. Returns (items, done)."""
        pending_err = self._stream_errors.pop(sid, None)
        if pending_err is not None:
            self._streams.pop(sid, None)
            self._settle_stream(sid)
            raise pending_err
        entry = self._streams.get(sid)
        if entry is None:
            return [], True
        buf = entry[0]
        entry[2] = time.monotonic()
        items: list = []
        try:
            kind, val = buf.get(timeout=wait_s)
        except _queue_mod.Empty:
            return [], False
        while True:
            if kind == "item":
                items.append(val)
            elif kind == "done":
                self._streams.pop(sid, None)
                self._settle_stream(sid)
                return items, True
            else:
                if items:
                    # Deliver buffered items first; the error surfaces on
                    # the NEXT poll (raising now would drop them).
                    self._stream_errors[sid] = val
                    return items, False
                self._streams.pop(sid, None)
                self._settle_stream(sid)
                raise val
            if len(items) >= max_items:
                return items, False
            try:
                kind, val = buf.get_nowait()
            except _queue_mod.Empty:
                return items, False

    def cancel_stream(self, sid: str) -> bool:
        entry = self._streams.pop(sid, None)
        self._stream_errors.pop(sid, None)
        if entry is None:
            return False
        entry[1].set()  # the drain thread stops pulling the generator
        self._settle_stream(sid)
        return True

    def queue_len(self) -> int:
        return self._ongoing

    def load_snapshot(self) -> Dict[str, Any]:
        """Compact load view the controller polls once per reconcile
        tick and piggybacks on the router long-poll (one RPC round of
        freshness). Base fields come from the replica's own gauges; a
        user callable exposing ``load_snapshot()`` (e.g. the LLM engine
        deployment) merges richer signals — queue depth, KV headroom,
        resident prefix-block hashes, EWMA TTFT."""
        snap: Dict[str, Any] = {"queue_depth": self._ongoing,
                                "ts": time.time()}
        hook = getattr(self._callable, "load_snapshot", None)
        if hook is not None:
            try:
                extra = hook()
                if extra:
                    snap.update(extra)
            except Exception as e:
                _logger.debug("user load_snapshot failed: %r", e)
        return snap

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            now = time.time()
            recent = [t for t in self._window if now - t < 10.0]
            return {"ongoing": self._ongoing, "total": self._total,
                    "rps_10s": len(recent) / 10.0,
                    "uptime_s": now - self._started}

    def reconfigure(self, user_config: Any) -> bool:
        """Push a config update without restarting (reference: the
        `reconfigure` user hook)."""
        hook = getattr(self._callable, "reconfigure", None)
        if hook is not None:
            hook(user_config)
            return True
        return False

    def health_check(self) -> bool:
        hook = getattr(self._callable, "check_health", None)
        if hook is not None:
            hook()
        return True

    def __ray_shutdown__(self) -> None:
        """Called once by the runtime when it kills this replica: runs the
        user callable's ``__del__`` (the reference's replica shutdown
        hook), e.g. an engine's ``close``."""
        hook = getattr(self._callable, "__del__", None)
        if hook is not None:
            hook()
