"""Demand-driven autoscaling over pluggable node providers
(``ray_tpu/autoscaler``; GCE GPU machines in place of TPU slices)."""

from ray_tpu_torch.autoscaler.autoscaler import Autoscaler, AutoscalerConfig
from ray_tpu_torch.autoscaler.gce import (FakeGceApi, GceGpuApi,
                                          GceGpuNodeProvider, RestGceGpuApi)
from ray_tpu_torch.autoscaler.node_provider import (GkeGpuNodePoolProvider,
                                                    LocalNodeProvider,
                                                    NodeProvider)

__all__ = ["Autoscaler", "AutoscalerConfig", "FakeGceApi", "GceGpuApi",
           "GceGpuNodeProvider", "GkeGpuNodePoolProvider",
           "LocalNodeProvider", "NodeProvider", "RestGceGpuApi"]
