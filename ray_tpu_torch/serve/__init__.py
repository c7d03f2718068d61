"""ray_tpu_torch.serve: model serving — deployments, routing, batching, the
LLM deployment, and the HTTP/gRPC ingress (``ray_tpu/serve/__init__.py``).

Parity target: the reference Ray Serve surface (python/ray/serve/__init__
— deployment/run/get_deployment_handle/batch) over this runtime's actors:
a reconciling controller with autoscaling, scored or pow-2 routed replica
sets, streaming handles, dynamic request batching, an HTTP ingress with
SLO admission and tenant QoS, and the continuous-batching LLM engine
(serve/llm.py).
"""

from ray_tpu_torch.serve._private.slo import DeploymentOverloadedError
from ray_tpu_torch.serve.api import (Deployment, DeploymentHandle,
                                     DeploymentResponse,
                                     DeploymentResponseGenerator, delete,
                                     deployment, get_deployment_handle,
                                     get_multiplexed_model_id, multiplexed,
                                     run, shutdown, status)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.schema import deploy_config

__all__ = [
    "Deployment", "DeploymentHandle", "DeploymentOverloadedError",
    "DeploymentResponse",
    "DeploymentResponseGenerator", "batch", "delete", "deployment",
    "get_deployment_handle", "get_multiplexed_model_id", "multiplexed",
    "run", "shutdown", "status", "start_http", "start_grpc",
    "start_http_per_node", "deploy_config",
]


def _start_ingress(actor_cls, host: str, port: int):
    """Shared ingress-actor bootstrap: spawn, fetch the bound port."""
    import ray_tpu_torch

    actor = ray_tpu_torch.remote(actor_cls).options(
        max_concurrency=16).remote(host, port)
    addr = ray_tpu_torch.get(actor.address.remote(), timeout=60)
    return actor, int(addr.rsplit(":", 1)[1])


def start_http(host: str = "127.0.0.1", port: int = 0):
    """Start one asyncio HTTP ingress actor; returns (handle, port)."""
    from ray_tpu_torch.serve._private.proxy import HTTPProxyActor

    return _start_ingress(HTTPProxyActor, host, port)


def start_grpc(host: str = "127.0.0.1", port: int = 0):
    """Start a gRPC ingress actor; returns (handle, port). Method path:
    /ray_tpu.serve/<deployment>[.<method>], JSON payloads; metadata
    rtpu-stream=1 selects server streaming. Needs the ``grpc`` package
    (``grpcio``) in this process; raises ``ImportError`` without it."""
    try:
        import grpc  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "serve.start_grpc needs the 'grpc' package (grpcio), which "
            "this Python does not have") from e
    from ray_tpu_torch.serve._private.grpc_proxy import GrpcProxyActor

    return _start_ingress(GrpcProxyActor, host, port)


def start_http_per_node(host: str = "127.0.0.1"):
    """One proxy actor per alive node, reconciled by the controller
    (new nodes get proxies, dead proxies respawn — reference:
    ProxyStateManager). Returns {node_id: \"host:port\"}."""
    import ray_tpu_torch
    from ray_tpu_torch.serve.api import _get_or_start_controller

    controller = _get_or_start_controller()
    return ray_tpu_torch.get(controller.start_http_proxies.remote(host),
                             timeout=120)
