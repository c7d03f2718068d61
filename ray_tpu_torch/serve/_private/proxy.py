"""HTTP ingress: an asyncio proxy routing to deployment handles
(``ray_tpu/serve/_private/proxy.py``'s wire contract, served on asyncio's
own streams where ``ray_tpu``'s uses aiohttp, which the card's host does
not have).

Parity target: reference python/ray/serve/_private/proxy.py (ProxyActor
:1129, HTTPProxy :752 — uvicorn/ASGI): an event-loop data plane where one
loop multiplexes every in-flight request over awaited object refs, instead
of parking one thread per request. Endpoints:
`POST /<deployment>[/<method>][?stream=1]` with a JSON body,
`GET /-/healthz` liveness, `GET /-/routes` deployment listing,
`GET /-/slo` SLO admission state.

The server is ``asyncio.start_server`` with a small HTTP/1.1 reader:
``Content-Length`` (or chunked) request bodies, keep-alive connections,
and a chunked ``application/jsonlines`` reply for streams — one
``{"item": ...}`` line per streamed item, ``{"error": ...}`` as the
terminal line when the generator raises. A client that hangs up mid-stream
cancels the replica-side generator. JSON replies carry aiohttp's
``application/json; charset=utf-8`` and ``json.dumps`` bodies, so a client
of ``ray_tpu``'s proxy reads the same bytes here.

SLO admission (slo.py): every POST passes the per-process
AdmissionController first — past the configured p99 TTFT budget
requests queue (bounded) then shed as HTTP 503 with a JSON
``{"error": "overloaded", ...}`` body, and the proxy feeds the
controller one TTFT sample per admitted request (time to full result,
or to the first streamed chunk).
"""

from __future__ import annotations

import asyncio
import http
import json
import threading
import time
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlsplit

from ray_tpu_torch.serve._private.slo import (AdmissionController,
                                              DeploymentOverloadedError)

_JSON = "application/json; charset=utf-8"
_TEXT = "text/plain; charset=utf-8"
_MAX_HEAD = 64 * 1024


class _BadRequest(Exception):
    pass


class _Reader:
    """Buffered HTTP/1.1 request reader over an ``asyncio.StreamReader``.
    Bytes read ahead (a pipelined next request, or the hang-up watch
    during a stream) stay in the buffer for the next parse."""

    def __init__(self, reader: asyncio.StreamReader):
        self._r = reader
        self._buf = bytearray()
        self.eof = False

    async def fill(self) -> bool:
        """Read more bytes; False once the peer has closed its side."""
        data = await self._r.read(65536)
        if not data:
            self.eof = True
            return False
        self._buf += data
        return True

    async def _until(self, sep: bytes, limit: int) -> Optional[bytes]:
        while True:
            i = self._buf.find(sep)
            if i >= 0:
                out = bytes(self._buf[:i])
                del self._buf[:i + len(sep)]
                return out
            if len(self._buf) > limit:
                raise _BadRequest("header section too large")
            if not await self.fill():
                return None

    async def _exactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            if not await self.fill():
                raise _BadRequest("body shorter than Content-Length")
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    async def request(self) -> Optional[Tuple[str, str, str,
                                              Dict[str, str], bytes]]:
        """(method, target, version, headers, body), or None at a clean
        end of the connection."""
        while self._buf[:2] == b"\r\n":  # tolerated between requests
            del self._buf[:2]
        head = await self._until(b"\r\n\r\n", _MAX_HEAD)
        if head is None:
            return None
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, version = lines[0].split(" ", 2)
        except ValueError:
            raise _BadRequest(f"bad request line {lines[0]!r}") from None
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            name, sep, value = line.partition(":")
            if not sep:
                raise _BadRequest(f"bad header line {line!r}")
            headers[name.strip().lower()] = value.strip()
        if "chunked" in headers.get("transfer-encoding", "").lower():
            parts = []
            while True:
                size_line = await self._until(b"\r\n", _MAX_HEAD)
                if size_line is None:
                    raise _BadRequest("truncated chunked body")
                size = int(size_line.split(b";")[0].strip() or b"0", 16)
                if size == 0:
                    while await self._until(b"\r\n", _MAX_HEAD):
                        pass  # trailers
                    break
                parts.append(await self._exactly(size))
                await self._exactly(2)
            body = b"".join(parts)
        else:
            try:
                n = int(headers.get("content-length", "0") or 0)
            except ValueError:
                raise _BadRequest("bad Content-Length") from None
            body = await self._exactly(n) if n > 0 else b""
        return method.upper(), target, version.upper(), headers, body


def _head(status: int, headers: Dict[str, str]) -> bytes:
    lines = [f"HTTP/1.1 {status} {http.HTTPStatus(status).phrase}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class _Reply:
    """One whole (non-streamed) response."""

    __slots__ = ("status", "content_type", "body")

    def __init__(self, status: int, content_type: str, body: bytes):
        self.status = status
        self.content_type = content_type
        self.body = body

    @classmethod
    def json(cls, data: Any, status: int = 200) -> "_Reply":
        return cls(status, _JSON, json.dumps(data).encode())

    @classmethod
    def text(cls, status: int) -> "_Reply":
        return cls(status, _TEXT,
                   f"{status}: {http.HTTPStatus(status).phrase}".encode())


class _Stream:
    """A chunked ``application/jsonlines`` response, written as items
    arrive. The head goes out with the first write."""

    def __init__(self, writer: asyncio.StreamWriter, keep_alive: bool):
        self._w = writer
        self._keep = keep_alive
        self._started = False

    async def write(self, data: bytes) -> None:
        out = b""
        if not self._started:
            self._started = True
            headers = {"Content-Type": "application/jsonlines",
                       "Transfer-Encoding": "chunked"}
            if not self._keep:
                headers["Connection"] = "close"
            out = _head(200, headers)
        if data:
            out += f"{len(data):x}\r\n".encode() + data + b"\r\n"
        self._w.write(out)
        await self._w.drain()

    async def write_eof(self) -> None:
        if not self._started:
            await self.write(b"")
        self._w.write(b"0\r\n\r\n")
        await self._w.drain()


class HTTPProxyActor:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._host = host
        self._handles: Dict[str, Any] = {}
        self._admission = AdmissionController()
        # Admission waits get their OWN pool: a queued acquire() parks a
        # thread for up to queue_timeout_s, and on a small box the
        # shared default executor (min(32, cpu+4) threads) would fill
        # with waiters and starve the routing calls — including the
        # probe requests whose TTFT samples are the only way the gate
        # reopens. Waiters beyond the clamp queue for a pool thread
        # before their timeout clock starts; acquire() still sheds them
        # once the admission queue itself is full.
        from concurrent.futures import ThreadPoolExecutor

        self._gate_pool = ThreadPoolExecutor(
            max_workers=min(64, self._admission.queue_depth + 4),
            thread_name_prefix="serve-slo-gate")
        self.port = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop = asyncio.new_event_loop()
        started = threading.Event()
        boot_err: list = []

        def run_loop():
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(self._start(host, port))
            except BaseException as e:  # noqa: BLE001 — surfaced to caller
                boot_err.append(e)
                started.set()
                return
            started.set()
            self._loop.run_forever()

        threading.Thread(target=run_loop, daemon=True,
                         name="serve-http-loop").start()
        if not started.wait(30) or boot_err:
            raise RuntimeError(f"proxy failed to start: "
                               f"{boot_err[0] if boot_err else 'timeout'}")

    async def _start(self, host: str, port: int) -> None:
        self._server = await asyncio.start_server(self._serve_conn, host,
                                                  port)
        self.port = self._server.sockets[0].getsockname()[1]

    # ---------------------------------------------------------- the wire

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        """One client connection: requests in order, kept alive until the
        client closes it or asks to (``Connection: close``, HTTP/1.0)."""
        rd = _Reader(reader)
        try:
            while True:
                try:
                    req = await rd.request()
                except _BadRequest as e:
                    await self._send(writer, _Reply.json(
                        {"error": f"bad request: {e}"}, status=400), False)
                    return
                if req is None:
                    return
                method, target, version, headers, body = req
                conn = headers.get("connection", "").lower()
                keep = (version == "HTTP/1.1" and conn != "close") or (
                    version == "HTTP/1.0" and conn == "keep-alive")
                reply = await self._dispatch(method, target, headers, body,
                                             rd, writer, keep)
                if reply is not None:
                    await self._send(writer, reply, keep)
                if not keep or rd.eof:
                    return
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            return
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001 — the socket is gone
                pass

    @staticmethod
    async def _send(writer: asyncio.StreamWriter, reply: _Reply,
                    keep: bool) -> None:
        headers = {"Content-Type": reply.content_type,
                   "Content-Length": str(len(reply.body))}
        if not keep:
            headers["Connection"] = "close"
        writer.write(_head(reply.status, headers) + reply.body)
        await writer.drain()

    async def _dispatch(self, method: str, target: str,
                        headers: Dict[str, str], body: bytes, rd: _Reader,
                        writer: asyncio.StreamWriter,
                        keep: bool) -> Optional[_Reply]:
        url = urlsplit(target)
        path = unquote(url.path) or "/"
        if method == "GET":
            if path == "/-/healthz":
                return _Reply.json({"status": "ok"})
            if path == "/-/slo":
                return _Reply.json(self._admission.snapshot())
            if path == "/-/routes":
                return await self._routes()
            return _Reply.text(405)
        if method != "POST":
            return _Reply.text(405)
        query = {k: v[-1] for k, v in parse_qs(url.query).items()}
        return await self._post(path, query, headers, body, rd, writer,
                                keep)

    # ------------------------------------------------------------ handlers

    async def _routes(self) -> _Reply:
        from ray_tpu_torch.serve import api as serve_api

        try:
            # status() RPCs the controller — run off-loop.
            payload = await asyncio.get_event_loop().run_in_executor(
                None, serve_api.status)
            return _Reply.json(payload)
        except Exception as e:  # noqa: BLE001 — surfaced as 500
            return _Reply.json({"error": str(e)}, status=500)

    def _get_handle(self, name: str):
        from ray_tpu_torch.serve import api as serve_api

        h = self._handles.get(name)
        if h is None:
            h = self._handles[name] = serve_api.get_deployment_handle(name)
        return h

    @staticmethod
    def _attached(fn, trace_ctx):
        """Run ``fn`` with the request's trace context attached: executor
        threads don't inherit the event loop's ContextVars, so the
        handle's route span would otherwise detach from the request
        root. No-op (plain call) when tracing is off."""
        from ray_tpu_torch.util import tracing

        with tracing.attach(trace_ctx):
            return fn()

    async def _post(self, path: str, query: Dict[str, str],
                    headers: Dict[str, str], body: bytes, rd: _Reader,
                    writer: asyncio.StreamWriter,
                    keep: bool) -> Optional[_Reply]:
        from ray_tpu_torch.util import tracing

        parts = [p for p in path.split("/") if p]
        name = parts[0] if parts else ""
        method = parts[1] if len(parts) > 1 else "__call__"
        stream = query.get("stream") == "1"
        if not name:
            return _Reply.json({"error": "no deployment in path"},
                               status=404)
        try:
            payload = json.loads(body or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            return _Reply.json({"error": f"bad json: {e}"}, status=400)
        # Tenant attribution for WFQ/budget admission (qos.py): the
        # x-tenant header wins, else a "tenant" field in the JSON body;
        # unattributed traffic shares the default tenant. Cost is the
        # request's LLM-token footprint — the unit tenant budgets are
        # denominated in.
        tenant = headers.get("x-tenant")
        cost = 1.0
        if isinstance(payload, dict):
            if tenant is None:
                t = payload.get("tenant")
                tenant = t if isinstance(t, str) else None
            ids = payload.get("prompt_ids")
            try:
                cost = max(1.0, (len(ids) if isinstance(ids, (list, tuple))
                                 else 0)
                           + float(payload.get("max_new_tokens", 32)))
            except (TypeError, ValueError):
                cost = 1.0
        loop = asyncio.get_event_loop()
        # Request-lifecycle trace: serve.request roots the tree; every
        # downstream span (admission, route, replica, engine phases,
        # delivery) parents under it. All None when tracing is off.
        root = tracing.start_span(
            "serve.request", attrs={"deployment": name, "method": method,
                                    "stream": stream})
        root_ctx = tracing.ctx_of(root)
        root_ok = False
        t_adm0w = time.time() if root is not None else 0.0
        # SLO gate first (off-loop on the dedicated gate pool: a queued
        # admission parks up to the queue timeout). A shed request
        # never touches the router.
        try:
            if not self._admission.may_block():
                # Gating disabled (the default): acquire() cannot park,
                # so the hot path skips the executor round-trip.
                self._admission.acquire(name, tenant, cost)
            else:
                await loop.run_in_executor(self._gate_pool,
                                           self._admission.acquire,
                                           name, tenant, cost)
        except DeploymentOverloadedError as e:
            if root is not None:
                tracing.emit_span(
                    "serve.admission", t_adm0w, time.time(),
                    parent=root_ctx, attrs={"shed": True}, ok=False)
                tracing.end_span(root, ok=False)
                # Off-loop: flush() is a blocking socket send to the
                # head — a stalled head must not freeze the event loop.
                loop.run_in_executor(None, tracing.flush)
            return _Reply.json(
                {"error": "overloaded", "deployment": name,
                 "detail": str(e)}, status=503)
        t_admit = time.perf_counter()
        if root is not None:
            # SLO queue wait (0 on the unparked fast path) — the first
            # TTFT component of the request timeline.
            t_now = time.time()
            tracing.emit_span(
                "serve.admission", t_adm0w, t_now, parent=root_ctx,
                attrs={"queued_ms": round((t_now - t_adm0w) * 1e3, 3)})
        unknown = False
        try:
            h = self._get_handle(name)
            if stream:
                await self._stream(rd, writer, keep, h, method, payload,
                                   name, t_admit, root_ctx, tenant)
                root_ok = True
                return None
            # Routing runs in the executor: choose() is normally a dict
            # pick, but the first call (or an unknown/scaled-to-zero
            # deployment) does a synchronous controller fetch that must
            # not stall the loop. The await then multiplexes the
            # in-flight request on the loop.
            resp = await loop.run_in_executor(
                None, lambda: self._attached(
                    lambda: h.options(method).remote(payload), root_ctx))
            t_del0 = time.time() if root is not None else 0.0
            result = await resp.result_async(timeout=120)
            if root is not None:
                tracing.emit_span("serve.delivery", t_del0, time.time(),
                                  parent=root_ctx)
            # Full-result latency stands in for TTFT on the unary path
            # (first byte == last byte here); the stream path records
            # true first-chunk time.
            self._admission.record_ttft(
                name, (time.perf_counter() - t_admit) * 1e3, tenant)
            root_ok = True
            return _Reply.json({"result": result})
        except Exception as e:  # noqa: BLE001 — surfaced as 500
            # The controller's KeyError arrives wrapped as a remote
            # TaskError; match it by message for the 404.
            if "no deployment named" in str(e) or isinstance(e, KeyError):
                self._handles.pop(name, None)
                unknown = True
                return _Reply.json(
                    {"error": f"no deployment {name!r}"}, status=404)
            return _Reply.json({"error": str(e)}, status=500)
        finally:
            self._admission.release(name, tenant)
            if root is not None:
                tracing.end_span(root, ok=root_ok)
                # Off-loop (see the shed path): the span ship must never
                # park the proxy's event loop on a slow head socket.
                loop.run_in_executor(None, tracing.flush)
            if unknown:
                # acquire() ran before the deployment lookup, so a 404
                # leaves behind admission state for a name that does
                # not exist — drop it or scanners grow the dict forever.
                self._admission.forget(name)

    async def _stream(self, rd: _Reader, writer: asyncio.StreamWriter,
                      keep: bool, h, method, payload, name=None,
                      t_admit=None, trace_ctx=None, tenant=None) -> None:
        """Chunked transfer: one JSON line per streamed item (reference:
        proxy_response_generator.py writes streaming responses the same
        incremental way over ASGI)."""
        from ray_tpu_torch.util import tracing

        loop = asyncio.get_event_loop()
        # Routing/stream setup failures (unknown deployment, no replicas)
        # happen BEFORE the response starts — let them propagate to
        # _post's JSON error mapping. Setup runs off-loop: it does a
        # blocking handle_request_streaming round-trip.
        gen = await loop.run_in_executor(
            None, lambda: self._attached(
                lambda: h.options(method, stream=True).remote(payload),
                trace_ctx))
        resp = _Stream(writer, keep)
        # The client's side of the socket is watched while items are
        # awaited: a hang-up cancels the replica-side generator even
        # when no item is due (bytes read ahead stay in rd's buffer).
        hangup = loop.create_task(self._watch_hangup(rd))
        first = True
        t_del0 = time.time() if trace_ctx is not None else 0.0
        items = 0
        it = gen.__aiter__()
        try:
            while True:
                nxt = loop.create_task(it.__anext__())
                done, _ = await asyncio.wait(
                    {nxt, hangup}, return_when=asyncio.FIRST_COMPLETED)
                if nxt not in done:
                    nxt.cancel()
                    raise ConnectionResetError("client hung up")
                try:
                    item = nxt.result()
                except StopAsyncIteration:
                    break
                if first and t_admit is not None:
                    self._admission.record_ttft(
                        name, (time.perf_counter() - t_admit) * 1e3,
                        tenant)
                first = False
                items += 1
                await resp.write(
                    (json.dumps({"item": item}) + "\n").encode())
        except asyncio.CancelledError:
            gen.cancel()
            raise
        except (ConnectionResetError, OSError):
            # Client hung up mid-stream (routine for LLM streams): stop
            # the replica-side generator; nothing more can be written.
            gen.cancel()
            rd.eof = True
            return
        except Exception as e:  # noqa: BLE001 -> terminal record
            gen.cancel()
            try:
                await resp.write(
                    (json.dumps({"error": str(e)}) + "\n").encode())
            except (ConnectionResetError, OSError):
                rd.eof = True
                return
        finally:
            # Wait the watcher out: its pending read must be gone before
            # the connection reads the next request.
            hangup.cancel()
            try:
                await hangup
            except (asyncio.CancelledError, OSError):
                pass
        try:
            await resp.write_eof()
        except (ConnectionResetError, OSError):
            rd.eof = True
        if trace_ctx is not None:
            # serve.delivery: first write through eof — the stream's
            # client-facing half of the timeline.
            tracing.emit_span("serve.delivery", t_del0, time.time(),
                              parent=trace_ctx, attrs={"items": items})

    @staticmethod
    async def _watch_hangup(rd: _Reader) -> None:
        """Returns once the client has closed its side of the socket."""
        while await rd.fill():
            pass

    # ----------------------------------------------------------- actor API

    def configure_qos(self, tenants: Dict[str, Dict[str, Any]]) -> bool:
        """Push per-tenant QoS contracts to this proxy's admission gate:
        ``{tenant: {weight, priority, tokens_per_s, burst_tokens}}``.
        Idempotent (safe to re-push the same map to every proxy)."""
        for tenant, kw in tenants.items():
            self._admission.configure_tenant(tenant, **kw)
        return True

    def address(self) -> str:
        import socket

        for _ in range(100):
            if self.port is not None:
                break
            time.sleep(0.1)
        return f"{socket.gethostbyname('localhost')}:{self.port}"

    def healthy(self) -> bool:
        return self._loop.is_running()

    def stop(self) -> bool:
        """Close the listening socket and stop the event loop."""
        def _close():
            if self._server is not None:
                self._server.close()
            self._loop.stop()

        self._loop.call_soon_threadsafe(_close)
        return True
