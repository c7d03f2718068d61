"""Cluster pubsub: publish/subscribe from ANY process (driver or worker)
(``ray_tpu/util/pubsub.py``).

Parity target: the reference's pubsub substrate (reference: src/ray/pubsub/
publisher.h / subscriber.h — GCS and per-worker publishers with long-poll
subscribers). Redesign: the head is the broker (it already fans out NODE /
log events); subscribers hold one dedicated push connection, publishers
fire one notify frame. Built-in channels: "NODE" (membership events),
"LOG" (shipped worker lines); user channels are free-form strings.

    from ray_tpu_torch.util import pubsub
    sub = pubsub.subscribe("my-channel", lambda payload: ...)
    pubsub.publish("my-channel", {"anything": "picklable"})
    sub.unsubscribe()
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.cluster.protocol import RpcClient


class Subscription:
    def __init__(self, hub: "_PubSubHub", channel: str, handler: Callable):
        self._hub = hub
        self.channel = channel
        self._handler = handler

    def unsubscribe(self) -> None:
        self._hub._remove(self.channel, self._handler)


class _PubSubHub:
    """One per process: a dedicated head connection carrying pushes (the
    core's request/response client stays free of fan-out traffic)."""

    def __init__(self, head_addr: str):
        self._head_addr = head_addr
        self._handlers: Dict[str, List[Callable]] = {}
        self._lock = threading.Lock()
        self._client_lock = threading.Lock()
        self._client: Optional[RpcClient] = None
        self._closed = False

    def _ensure_client(self) -> RpcClient:
        with self._client_lock:
            if self._client is None or not self._client._alive:
                client = RpcClient(
                    self._head_addr, on_push=self._on_push,
                    on_close=self._on_close)
                self._client = client
                with self._lock:
                    channels = list(self._handlers)
                for ch in channels:
                    client.call("subscribe", ch, timeout=10)
            return self._client

    def _on_push(self, method: str, args) -> None:
        if method != "pubsub":
            return
        channel, payload = args
        with self._lock:
            handlers = list(self._handlers.get(channel, ()))
        for h in handlers:
            try:
                h(payload)
            except Exception:
                pass  # one broken handler must not break delivery

    def _on_close(self, _client) -> None:
        """The push connection died (head restart loses its in-memory
        subscriber table): a subscribe-only process would otherwise go
        silent forever, so reconnect + resubscribe on a background thread
        with backoff until the head is back."""
        with self._lock:
            want = bool(self._handlers) and not self._closed
        if not want:
            return

        def rejoin():
            import time as _t

            from ray_tpu_torch.core.config import GLOBAL_CONFIG as _cfg

            delay = _cfg.pubsub_retry_delay_s
            while not self._closed:
                with self._lock:
                    if not self._handlers:
                        return
                try:
                    self._ensure_client()
                    return
                except Exception:
                    _t.sleep(delay)
                    delay = min(delay * 2, 10.0)

        threading.Thread(target=rejoin, daemon=True,
                         name="pubsub-rejoin").start()

    def subscribe(self, channel: str, handler: Callable) -> Subscription:
        with self._lock:
            self._handlers.setdefault(channel, []).append(handler)
        try:
            # _ensure_client resubscribes every handler channel on a fresh
            # connection; the explicit call covers the existing-connection
            # case (head-side registration is idempotent either way).
            self._ensure_client().call("subscribe", channel, timeout=10)
        except BaseException:
            # No Subscription is returned on failure, so nothing could
            # ever remove the handler — an orphan would double-deliver
            # after a successful retry.
            self._remove(channel, handler)
            raise
        return Subscription(self, channel, handler)

    def _remove(self, channel: str, handler: Callable) -> None:
        with self._lock:
            lst = self._handlers.get(channel)
            if lst and handler in lst:
                lst.remove(handler)
            drop = lst is not None and not lst
            if drop:
                del self._handlers[channel]
        if drop and self._client is not None and self._client._alive:
            # Tell the head: otherwise it keeps fanning this channel's
            # publishes to us for the process lifetime.
            try:
                self._client.notify("unsubscribe", channel)
            except Exception:
                pass

    def publish(self, channel: str, payload: Any) -> None:
        self._ensure_client().notify("publish", channel, payload)

    def close(self) -> None:
        self._closed = True
        if self._client is not None:
            self._client.close()
            self._client = None


_hub: Optional[_PubSubHub] = None
_hub_lock = threading.Lock()


def _get_hub() -> _PubSubHub:
    global _hub
    from ray_tpu_torch.core.runtime_context import require_runtime

    rt = require_runtime()
    head_addr = getattr(rt, "head_addr", None)
    if head_addr is None:
        if getattr(rt, "is_client", False):
            raise RuntimeError(
                "pubsub is not proxied through the client:// gateway yet; "
                "subscribe/publish from a process inside the cluster")
        raise RuntimeError("pubsub requires a cluster runtime "
                           "(local_mode has no head broker)")
    with _hub_lock:
        if _hub is None or _hub._head_addr != head_addr or _hub._closed:
            if _hub is not None:
                _hub.close()
            _hub = _PubSubHub(head_addr)
        return _hub


def close() -> None:
    """Tear down this process's hub (called by ray_tpu_torch.shutdown): stops
    the rejoin loop so a dead head isn't reconnect-polled forever."""
    global _hub
    with _hub_lock:
        if _hub is not None:
            _hub.close()
            _hub = None


def subscribe(channel: str, handler: Callable[[Any], None]) -> Subscription:
    """Register ``handler(payload)`` for every publish on ``channel``."""
    return _get_hub().subscribe(channel, handler)


def publish(channel: str, payload: Any) -> None:
    """Publish a picklable payload to every subscriber of ``channel``."""
    _get_hub().publish(channel, payload)
