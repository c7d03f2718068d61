"""ray_tpu_torch.serve: model serving — deployments, routing, the LLM
deployment (``ray_tpu/serve/__init__.py``, without the HTTP/gRPC ingress,
the SLO gate and ``@serve.batch``: ROADMAP.md, queue 1, items 9g and 9h).

Parity target: the reference Ray Serve surface (python/ray/serve/__init__
— deployment/run/get_deployment_handle) over this runtime's actors: a
reconciling controller, scored or pow-2 routed replica sets, streaming
handles, and the continuous-batching LLM engine (serve/llm.py).
"""

from ray_tpu_torch.serve.api import (Deployment, DeploymentHandle,
                                     DeploymentResponse,
                                     DeploymentResponseGenerator, delete,
                                     deployment, get_deployment_handle,
                                     get_multiplexed_model_id, multiplexed,
                                     run, shutdown, status)

__all__ = [
    "Deployment", "DeploymentHandle", "DeploymentResponse",
    "DeploymentResponseGenerator", "delete", "deployment",
    "get_deployment_handle", "get_multiplexed_model_id", "multiplexed",
    "run", "shutdown", "status",
]
