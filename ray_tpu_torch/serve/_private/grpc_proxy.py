"""gRPC ingress: JSON-over-gRPC routed to deployment handles
(``ray_tpu/serve/_private/grpc_proxy.py``).

Parity target: the reference's gRPC proxy tier
(reference: python/ray/serve/_private/proxy.py gRPCProxy + grpc_util.py
gRPCGenericServer — user requests enter over gRPC and route through the
same handle/replica path as HTTP). Generic method handlers (no protoc
step): any method path ``/ray_tpu.serve/<deployment>[.<method>]`` is
served; request/response payloads are JSON bytes, streaming calls return
one JSON frame per yielded item. Typed protos compile down to exactly
these generic handlers, so a user's own stubs interoperate by pointing at
this service name.
"""

from __future__ import annotations

import json
from typing import Any, Dict

SERVICE = "ray_tpu.serve"


class GrpcProxyActor:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 64):
        import grpc
        from concurrent import futures

        outer = self
        self._host = host
        self._handles: Dict[str, Any] = {}

        class Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                parts = handler_call_details.method.strip("/").split("/")
                if len(parts) != 2 or parts[0] != SERVICE:
                    return None
                target = parts[1]
                name, _, method = target.partition(".")
                method = method or "__call__"
                if handler_call_details.invocation_metadata and any(
                        k == "rtpu-stream" and v == "1" for k, v in
                        handler_call_details.invocation_metadata):
                    return grpc.unary_stream_rpc_method_handler(
                        outer._make_stream(name, method),
                        request_deserializer=bytes,
                        response_serializer=bytes)
                return grpc.unary_unary_rpc_method_handler(
                    outer._make_unary(name, method),
                    request_deserializer=bytes,
                    response_serializer=bytes)

        # Streaming RPCs park one worker each for their whole lifetime:
        # size the pool for stream fan-out (grpc.aio would remove the
        # ceiling entirely; sized threads are the pragmatic middle until
        # the ingress hot path demands it).
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=[("grpc.so_reuseport", 0)])
        self._server.add_generic_rpc_handlers((Handler(),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self._server.start()

    # ------------------------------------------------------------- routing

    def _get_handle(self, name: str):
        from ray_tpu_torch.serve import api as serve_api

        h = self._handles.get(name)
        if h is None:
            h = self._handles[name] = serve_api.get_deployment_handle(name)
        return h

    def _make_unary(self, name: str, method: str):
        import grpc

        def handler(request: bytes, context):
            try:
                payload = json.loads(request or b"{}")
            except json.JSONDecodeError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              f"bad json: {e}")
            try:
                h = self._get_handle(name)
                result = h.options(method).remote(payload).result(
                    timeout=120)
                return json.dumps({"result": result}).encode()
            except Exception as e:  # noqa: BLE001 -> status mapping
                if "no deployment named" in str(e):
                    self._handles.pop(name, None)
                    context.abort(grpc.StatusCode.NOT_FOUND,
                                  f"no deployment {name!r}")
                context.abort(grpc.StatusCode.INTERNAL, str(e))

        return handler

    def _make_stream(self, name: str, method: str):
        import grpc

        def handler(request: bytes, context):
            try:
                payload = json.loads(request or b"{}")
            except json.JSONDecodeError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              f"bad json: {e}")
                return
            try:
                h = self._get_handle(name)
                gen = h.options(method, stream=True).remote(payload)
            except Exception as e:  # noqa: BLE001
                if "no deployment named" in str(e):
                    self._handles.pop(name, None)
                    context.abort(grpc.StatusCode.NOT_FOUND,
                                  f"no deployment {name!r}")
                context.abort(grpc.StatusCode.INTERNAL, str(e))
                return
            done = False
            try:
                for item in gen:
                    if not context.is_active():
                        return
                    yield json.dumps({"item": item}).encode()
                done = True
            except Exception as e:  # noqa: BLE001 -> terminal status
                done = True
                gen.cancel()
                context.abort(grpc.StatusCode.INTERNAL, str(e))
            finally:
                # Client disconnect closes this generator (GeneratorExit
                # lands at the yield): the replica-side stream must stop
                # computing — cancel unless it ran to completion.
                if not done:
                    gen.cancel()

        return handler

    # ----------------------------------------------------------- actor API

    def address(self) -> str:
        return f"{self._host}:{self.port}"

    def healthy(self) -> bool:
        return True

    def stop(self) -> bool:
        self._server.stop(grace=0.5)
        return True
