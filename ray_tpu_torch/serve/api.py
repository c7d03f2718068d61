"""Public Serve API: deployments, handles, run/shutdown
(``ray_tpu/serve/api.py``).

Parity target: reference python/ray/serve/api.py (serve.deployment :306,
serve.run :499) + handle.py (DeploymentHandle). The controller is a named
actor; handles route over its replica sets with the scored router (pow-2
without fresh load snapshots); a deployment with an ``autoscaling_config``
is resized by the controller's autoscaling policy.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve._private.router import Router

_TIMEOUT_UNSET = object()


_lock = threading.Lock()


def _get_or_start_controller():
    with _lock:
        try:
            return ray_tpu_torch.get_actor(CONTROLLER_NAME)
        except Exception:
            pass
        actor_cls = ray_tpu_torch.remote(ServeController)
        # Generous concurrency: every router in every process holds one
        # listen_for_change long-poll slot open against this actor.
        return actor_cls.options(
            name=CONTROLLER_NAME, get_if_exists=True, max_concurrency=128,
            num_cpus=1).remote()


# One router (and its long-poll thread) per deployment per process —
# handles share them; creating a handle is cheap and leak-free.
_routers: Dict[str, Router] = {}


def _get_router(deployment_name: str, controller) -> Router:
    with _lock:
        r = _routers.get(deployment_name)
        if r is None:
            r = _routers[deployment_name] = Router(controller,
                                                   deployment_name)
        return r


class DeploymentResponse:
    """Future for one routed request (reference: DeploymentResponse)."""

    def __init__(self, ref, router: Router, replica,
                 retry: Optional[Callable[[], "DeploymentResponse"]] = None):
        self._ref = ref
        self._router = router
        self._replica = replica
        self._retry = retry
        self._done = False

    def result(self, timeout: Any = _TIMEOUT_UNSET):
        """``timeout`` defaults to the serve_handle_timeout_s flag; an
        explicit ``timeout=None`` waits without a deadline."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
        from ray_tpu_torch.exceptions import ActorDiedError

        if timeout is _TIMEOUT_UNSET:
            timeout = cfg.serve_handle_timeout_s

        try:
            return ray_tpu_torch.get(self._ref, timeout=timeout)
        except ActorDiedError:
            # The routed replica died under us: refresh the set and replay
            # ONCE on a live replica (reference routers reroute the same
            # way; a dead-actor error never raises at .remote() time in
            # this runtime, only here).
            self._router.invalidate()
            if self._retry is None:
                raise
            retry, self._retry = self._retry, None
            return retry().result(timeout=timeout)
        finally:
            if not self._done:
                self._done = True
                self._router.done(self._replica)

    async def result_async(self, timeout: Optional[float] = 120.0):
        """Awaitable result — the asyncio proxy's path: the event loop
        multiplexes thousands of in-flight requests over these futures
        instead of parking one thread per request. Blocking recovery steps
        (replica-set re-fetch, re-route) run in the default executor so
        one dead replica never stalls the loop."""
        import asyncio

        from ray_tpu_torch.exceptions import ActorDiedError

        try:
            return await asyncio.wait_for(
                asyncio.wrap_future(self._ref.future()), timeout)
        except ActorDiedError:
            loop = asyncio.get_event_loop()
            await loop.run_in_executor(None, self._router.invalidate)
            if self._retry is None:
                raise
            retry, self._retry = self._retry, None
            next_resp = await loop.run_in_executor(None, retry)
            return await next_resp.result_async(timeout=timeout)
        finally:
            if not self._done:
                self._done = True
                self._router.done(self._replica)

    # Allow passing responses straight into downstream .remote() calls.
    def ref(self):
        return self._ref


class DeploymentResponseGenerator:
    """Iterator over a streaming deployment response (reference:
    DeploymentResponseGenerator over ObjectRefGenerators; here chunks ride
    a cursor-poll over the actor plane)."""

    def __init__(self, replica, sid, router):
        self._replica = replica
        self._sid = sid
        self._router = router
        self._buf: list = []
        self._done = False

    def __iter__(self):
        return self

    def __next__(self):
        while not self._buf:
            if self._done:
                raise StopIteration
            try:
                items, done = ray_tpu_torch.get(
                    self._replica.next_chunks.remote(self._sid),
                    timeout=120)
            except BaseException:
                self._done = True
                self._router.done(self._replica)
                raise
            self._buf.extend(items)
            if done:
                self._done = True
                self._router.done(self._replica)
        return self._buf.pop(0)

    def cancel(self) -> None:
        if not self._done:
            self._done = True
            self._replica.cancel_stream.remote(self._sid)
            self._router.done(self._replica)

    def __aiter__(self):
        return self

    async def __anext__(self):
        """Async iteration for the asyncio proxy: the cursor poll is an
        awaited ref, so one stalled stream never parks a thread."""
        import asyncio

        while not self._buf:
            if self._done:
                raise StopAsyncIteration
            # The ref is held across the await: dropped at once, the
            # owner would free the reply before it lands and the future
            # would never resolve.
            ref = self._replica.next_chunks.remote(self._sid)
            try:
                items, done = await asyncio.wait_for(
                    asyncio.wrap_future(ref.future()), 120)
            except asyncio.CancelledError:
                # Client disconnected while we were suspended here (the
                # dominant state): tell the replica NOW — the caller's
                # later gen.cancel() would no-op once _done is set, and
                # the replica's drain thread would keep computing into an
                # unbounded buffer.
                if not self._done:
                    self._done = True
                    self._replica.cancel_stream.remote(self._sid)
                    self._router.done(self._replica)
                raise
            except BaseException:
                self._done = True
                self._router.done(self._replica)
                raise
            self._buf.extend(items)
            if done:
                self._done = True
                self._router.done(self._replica)
        return self._buf.pop(0)


class DeploymentHandle:
    """Routes calls to a deployment's replicas (pow-2 choices, model
    multiplexing affinity, optional streaming)."""

    def __init__(self, deployment_name: str, method_name: str = "__call__",
                 stream: bool = False,
                 multiplexed_model_id: Optional[str] = None):
        self._name = deployment_name
        self._method = method_name
        self._stream = stream
        self._model_id = multiplexed_model_id
        self._controller = _get_or_start_controller()
        self._router = _get_router(deployment_name, self._controller)

    def options(self, method_name: Optional[str] = None, *,
                stream: Optional[bool] = None,
                multiplexed_model_id: Optional[str] = None
                ) -> "DeploymentHandle":
        h = DeploymentHandle.__new__(DeploymentHandle)
        h._name = self._name
        h._method = method_name if method_name is not None else self._method
        h._stream = stream if stream is not None else self._stream
        h._model_id = (multiplexed_model_id
                       if multiplexed_model_id is not None
                       else self._model_id)
        h._controller = self._controller
        h._router = self._router
        return h

    def __getattr__(self, item: str):
        if item.startswith("_"):
            raise AttributeError(item)
        return self.options(item)

    def _context(self, trace_ctx: Optional[Dict[str, str]] = None
                 ) -> Optional[Dict[str, Any]]:
        ctx: Optional[Dict[str, Any]] = None
        if self._model_id is not None:
            ctx = {"multiplexed_model_id": self._model_id}
        if trace_ctx is not None:
            ctx = dict(ctx or ())
            ctx["trace"] = trace_ctx
        return ctx

    def _route(self, args, kwargs):
        """Router choice wrapped in the ``serve.route`` span + the
        ``route`` TTFT-breakdown sample. Returns (replica, wire trace
        context to ship to the replica — None when tracing is off)."""
        import time as _time

        from ray_tpu_torch.serve.engine.metrics import \
            SERVE_TTFT_BREAKDOWN_MS
        from ray_tpu_torch.util import tracing

        traced = tracing.enabled()
        decision: Optional[Dict[str, Any]] = {} if traced else None
        t0 = _time.perf_counter()
        t0w = _time.time() if traced else 0.0
        replica = self._router.choose(
            model_id=self._model_id,
            prefix_tokens=self._prefix_hint(args, kwargs),
            decision=decision,
            session_key=self._session_hint(args, kwargs))
        SERVE_TTFT_BREAKDOWN_MS.observe(
            (_time.perf_counter() - t0) * 1e3,
            labels={"component": "route"})
        if not traced:
            return replica, None
        parent = tracing.current()
        decision["deployment"] = self._name
        route_ctx = tracing.emit_span("serve.route", t0w, _time.time(),
                                      parent=parent, attrs=decision)
        # With an enclosing request span (the proxy) the replica parents
        # there; a bare traced handle call roots its tree at the route
        # span so the request still forms one connected trace.
        return replica, (parent if parent is not None else route_ctx)

    @staticmethod
    def _prefix_hint(args, kwargs) -> Optional[list]:
        """Routing hint for prefix-affinity scoring: LLM payloads carry
        token ids as ``{"prompt_ids": [...]}`` (the HTTP proxy's JSON
        body arrives here verbatim, so ingress traffic threads its
        prefix hashes to the router with no proxy-side parsing)."""
        payload = args[0] if args else kwargs.get("request")
        if isinstance(payload, dict):
            ids = payload.get("prompt_ids")
            if isinstance(ids, (list, tuple)) and ids \
                    and isinstance(ids[0], int):
                return list(ids)
        return None

    @staticmethod
    def _session_hint(args, kwargs) -> Optional[str]:
        """Session-affinity key: ``{"session": "..."}`` in the payload
        pins a multi-turn conversation back onto the replica already
        holding its prefix blocks (router LRU pin; falls through to
        scoring when the pinned replica disappears)."""
        payload = args[0] if args else kwargs.get("request")
        if isinstance(payload, dict):
            sk = payload.get("session")
            if isinstance(sk, str) and sk:
                return sk
        return None

    def remote(self, *args, **kwargs):
        replica, trace_ctx = self._route(args, kwargs)
        if self._stream:
            try:
                sid, items, done = ray_tpu_torch.get(
                    replica.handle_request_streaming.remote(
                        self._method, args, kwargs,
                        self._context(trace_ctx)),
                    timeout=60)
            except BaseException:
                # The choose() above counted us in-flight; a failed stream
                # setup must not permanently bias pow-2 away from the
                # replica.
                self._router.done(replica)
                raise
            gen = DeploymentResponseGenerator(replica, sid, self._router)
            # First chunk piggybacked on the start RPC: streaming TTFT
            # is one round trip, same as a non-streaming call.
            gen._buf.extend(items)
            if done:
                gen._done = True
                self._router.done(replica)
            return gen
        ref = replica.handle_request.remote(self._method, args, kwargs,
                                            self._context(trace_ctx))
        # One replay budget for a dead-replica result (submission itself
        # never raises for dead actors in this runtime).
        return DeploymentResponse(
            ref, self._router, replica,
            retry=lambda: self._route_once(args, kwargs))

    def _route_once(self, args, kwargs) -> DeploymentResponse:
        replica, trace_ctx = self._route(args, kwargs)
        ref = replica.handle_request.remote(self._method, args, kwargs,
                                            self._context(trace_ctx))
        return DeploymentResponse(ref, self._router, replica)

    def __reduce__(self):
        return (DeploymentHandle,
                (self._name, self._method, self._stream, self._model_id))


class Deployment:
    """The object @serve.deployment produces; .bind() attaches init args."""

    def __init__(self, cls: type, name: str, config: Dict[str, Any]):
        self._cls = cls
        self.name = name
        self._config = config
        self._init_args: tuple = ()
        self._init_kwargs: Dict[str, Any] = {}

    def options(self, **overrides) -> "Deployment":
        d = Deployment(self._cls, overrides.pop("name", self.name),
                       {**self._config, **overrides})
        d._init_args = self._init_args
        d._init_kwargs = self._init_kwargs
        return d

    def bind(self, *args, **kwargs) -> "Deployment":
        d = Deployment(self._cls, self.name, dict(self._config))
        d._init_args = args
        d._init_kwargs = kwargs
        return d


def deployment(_cls: Optional[type] = None, *, name: Optional[str] = None,
               num_replicas: int = 1,
               max_ongoing_requests: int = 8,
               autoscaling_config: Optional[Dict[str, Any]] = None,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               user_config: Any = None):
    """@serve.deployment decorator (class-based deployments)."""

    def wrap(cls: type) -> Deployment:
        cfg = {
            "num_replicas": num_replicas,
            "max_ongoing_requests": max_ongoing_requests,
            "autoscaling_config": autoscaling_config,
            "ray_actor_options": ray_actor_options or {},
            "user_config": user_config,
        }
        return Deployment(cls, name or cls.__name__, cfg)

    if _cls is not None:
        return wrap(_cls)
    return wrap


def run(target: Deployment, *, name: Optional[str] = None,
        _blocking: bool = True,
        _local_testing_mode: bool = False) -> "DeploymentHandle":
    """Deploy (or update) and return a handle (reference serve.run :499).

    Composition: bound Deployments may appear in another deployment's
    ``.bind(...)`` args — each is deployed and replaced by a
    DeploymentHandle before the parent's replicas construct (reference:
    deployment graphs via DeploymentNode/handle injection), so deployments
    call deployments through ordinary handles.

    ``_local_testing_mode`` (reference: serve/_private/local_testing_mode
    .py): construct the app IN-PROCESS — no cluster, controller, replicas
    or RPC — returning handles with the same .remote()/.result() surface.
    For unit-testing deployment logic with zero infrastructure."""
    if not isinstance(target, Deployment):
        raise TypeError("serve.run expects a Deployment "
                        "(apply @serve.deployment and .bind() first)")
    if _local_testing_mode:
        return _build_local(target)
    controller = _get_or_start_controller()
    return _deploy_graph(controller, target, name or target.name)


class _LocalResponse:
    """Matches DeploymentResponse's surface for local-mode calls. Each
    call runs on its OWN thread: composed deployments block a calling
    thread in .result() while the sub-call runs, so a shared bounded pool
    would deadlock under fan-out (all threads waiting on work queued
    behind them)."""

    def __init__(self, fn, args, kwargs):
        import concurrent.futures as _f

        self._fut: "_f.Future" = _f.Future()

        def run():
            try:
                self._fut.set_result(fn(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001 — delivered to result()
                self._fut.set_exception(e)

        threading.Thread(target=run, daemon=True,
                         name="serve-local-call").start()

    def result(self, timeout: Any = _TIMEOUT_UNSET):
        """Same default-deadline contract as the real handle."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

        if timeout is _TIMEOUT_UNSET:
            timeout = cfg.serve_handle_timeout_s
        return self._fut.result(timeout=timeout)

    async def result_async(self, timeout: Optional[float] = None):
        import asyncio

        return await asyncio.wait_for(asyncio.wrap_future(self._fut),
                                      timeout)


class _LocalMethod:
    def __init__(self, fn, stream: bool = False):
        self._fn = fn
        self._stream = stream

    def remote(self, *args, **kwargs):
        if self._stream:
            return iter(self._fn(*args, **kwargs))
        return _LocalResponse(self._fn, args, kwargs)


class LocalDeploymentHandle:
    """In-process handle: calls hit the instance directly (one thread per
    call, so .remote() stays non-blocking like the real handle)."""

    def __init__(self, instance: Any, method_name: str = "__call__",
                 stream: bool = False):
        self._instance = instance
        self._method = method_name
        self._stream = stream

    def __getattr__(self, item: str) -> "LocalDeploymentHandle":
        # Mirror the real DeploymentHandle: attribute access routes
        # through options() so the handle's _stream flag survives —
        # handle.options(stream=True).method.remote() must stream in
        # local testing mode exactly as it does in production.
        if item.startswith("_"):
            raise AttributeError(item)
        return self.options(method_name=item)

    def remote(self, *args, **kwargs):
        return _LocalMethod(getattr(self._instance, self._method),
                            self._stream).remote(*args, **kwargs)

    def options(self, *, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                **_ignored) -> "LocalDeploymentHandle":
        """Honors the routing options the real handle honors (a local
        handle that silently called __call__ for options(method_name=...)
        would defeat the mode's emulate-production purpose)."""
        return LocalDeploymentHandle(
            self._instance,
            method_name=self._method if method_name is None else method_name,
            stream=self._stream if stream is None else stream)


def _build_local(dep: Deployment) -> LocalDeploymentHandle:
    def resolve(v):
        if isinstance(v, Deployment):
            return _build_local(v)
        return v

    args = tuple(resolve(a) for a in dep._init_args)
    kwargs = {k: resolve(v) for k, v in dep._init_kwargs.items()}
    return LocalDeploymentHandle(dep._cls(*args, **kwargs))


def _deploy_graph(controller, dep: Deployment,
                  dep_name: str) -> DeploymentHandle:
    """Deploy ``dep`` (recursively deploying bound sub-Deployments in its
    init args first, substituting their handles); returns dep's handle."""

    def resolve(v):
        if isinstance(v, Deployment):
            return _deploy_graph(controller, v, v.name)
        return v

    init_args = tuple(resolve(a) for a in dep._init_args)
    init_kwargs = {k: resolve(v) for k, v in dep._init_kwargs.items()}
    ray_tpu_torch.get(controller.deploy.remote(
        dep_name, dep._cls, init_args, init_kwargs, dep._config),
        timeout=180)
    return DeploymentHandle(dep_name)


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def get_multiplexed_model_id() -> str:
    """Inside a deployment: the model id the current request targeted
    (reference: serve.get_multiplexed_model_id)."""
    from ray_tpu_torch.serve._private.replica import get_request_context

    return get_request_context().get("multiplexed_model_id", "")


def multiplexed(max_num_models_per_replica: int = 3):
    """Per-replica LRU model cache decorator (reference:
    serve.multiplexed, python/ray/serve/multiplex.py): decorate a
    ``load_model(self, model_id)`` method; calls are cached per replica,
    least-recently-used models evicted beyond the cap (a model with a
    ``__del__`` releases its resources on eviction)."""
    import collections
    import functools

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(self, model_id: str):
            # Cache + lock live ON THE INSTANCE (per replica), created
            # lazily: a closure-held lock would make the deployment class
            # unpicklable when it ships to replicas. Per-model in-progress
            # events serialize concurrent loads of the SAME model (an
            # expensive load must run once, and the replica must never
            # transiently exceed the model cap by racing loaders).
            state = getattr(self, "_rtpu_mux_state", None)
            if state is None:
                state = (collections.OrderedDict(), threading.Lock(), {})
                self._rtpu_mux_state = state
            cache, lock, loading = state
            while True:
                with lock:
                    if model_id in cache:
                        cache.move_to_end(model_id)
                        return cache[model_id]
                    ev = loading.get(model_id)
                    if ev is None:
                        loading[model_id] = threading.Event()
                        break
                ev.wait(600)
            try:
                model = fn(self, model_id)
                with lock:
                    cache[model_id] = model
                    cache.move_to_end(model_id)
                    while len(cache) > max_num_models_per_replica:
                        cache.popitem(last=False)
                return model
            finally:
                with lock:
                    loading.pop(model_id).set()

        wrapper._rtpu_multiplexed = True
        return wrapper

    return decorate


def status() -> Dict[str, Any]:
    controller = _get_or_start_controller()
    return ray_tpu_torch.get(controller.list_deployments.remote(), timeout=30)


def delete(name: str) -> None:
    controller = _get_or_start_controller()
    ray_tpu_torch.get(controller.delete.remote(name), timeout=60)
    # Stop this process's router for the deleted deployment: a parked
    # long-poll thread would otherwise pin a controller concurrency slot
    # until redeploy. (A later handle re-creates a fresh router.)
    with _lock:
        r = _routers.pop(name, None)
    if r is not None:
        r.stop()


def shutdown() -> None:
    """Stop every deployment, the controller and this process's routers.
    Returns once their threads are gone (a router's long-poll thread leaves
    at the controller's shutdown push)."""
    with _lock:
        routers = list(_routers.values())
        _routers.clear()
        for r in routers:
            r.stop(timeout=0)  # flag only: exit at the controller's push
        try:
            controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        except Exception:
            controller = None
        if controller is not None:
            try:
                ray_tpu_torch.get(controller.shutdown.remote(), timeout=120)
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(controller)
            except Exception:
                pass
        for r in routers:
            r.stop()
