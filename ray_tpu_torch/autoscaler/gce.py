"""GCE GPU node provider: the autoscaler's cloud arm
(``ray_tpu/autoscaler/gce.py`` for GPU machines in place of TPU slices).

Parity target: the reference's GCP provider (reference:
python/ray/autoscaler/_private/gcp/node_provider.py and the VM creation
path in _private/gcp/node.py; machine shapes from
python/ray/_private/accelerators/nvidia_gpu.py's card models). Design:

- ``GceGpuApi`` is the narrow surface of the GCE compute API actually
  used (create/list/delete one GPU VM). Production binds
  ``RestGceGpuApi`` (a stub: this package makes no network call); tests
  bind ``FakeGceApi`` — an in-memory cloud whose "VMs" are real local node
  processes that self-register with the head, carrying the cards and the
  model their machine type gives (``machine_node_resources``), so
  autoscaler tests exercise the REAL end-to-end loop (demand -> provider -> node
  joins -> demand met) exactly like the reference's fake_multinode
  provider tests (tests/test_autoscaler_fake_multinode.py).
- One ``create_node`` call provisions ONE VM, one host with the cards of
  its machine type (``core/accelerators.py``'s shapes). ``ray_tpu``'s TPU
  provider creates whole multi-host slices with a ``-head`` resource; a
  GPU machine is never more than one host, so neither exists here.
"""

from __future__ import annotations

import inspect
import threading
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider
from ray_tpu_torch.core.accelerators import machine_node_resources


class GceGpuApi:
    """The GCE compute API surface the provider consumes."""

    def create_vm(self, name: str, machine_type: str) -> None:
        """Provision one GPU VM; it boots and self-registers."""
        raise NotImplementedError

    def list_vms(self) -> List[Dict[str, Any]]:
        """[{"name", "machine_type", "state", "node_ids": [...]}]"""
        raise NotImplementedError

    def delete_vm(self, name: str) -> None:
        raise NotImplementedError


class RestGceGpuApi(GceGpuApi):  # pragma: no cover — requires cloud creds
    """Real API shape (compute.googleapis.com v1 instances REST calls —
    the reference drives the same endpoints through googleapiclient in
    autoscaler/_private/gcp/node.py). Kept as the production binding
    point; it makes no call."""

    def __init__(self, project: str, zone: str, image: str,
                 startup_script: str):
        self.project, self.zone = project, zone
        self.image = image
        self.startup_script = startup_script

    def _call(self, method: str, path: str, body=None):
        raise NotImplementedError(
            "no network access: POST https://compute.googleapis.com/compute/"
            f"v1/projects/{self.project}/zones/{self.zone}/instances ...")

    def create_vm(self, name, machine_type):
        self._call("POST", "instances", {
            "name": name,
            "machineType": f"zones/{self.zone}/machineTypes/{machine_type}",
            "scheduling": {"onHostMaintenance": "TERMINATE"},
            "disks": [{"boot": True, "initializeParams": {
                "sourceImage": self.image}}],
            "metadata": {"items": [{"key": "startup-script",
                                    "value": self.startup_script}]},
        })

    def list_vms(self):
        return self._call("GET", "instances")

    def delete_vm(self, name):
        self._call("DELETE", f"instances/{name}")


class FakeGceApi(GceGpuApi):
    """In-memory GCE: each VM is a local node-manager process with its
    machine type's mocked cards (the reference's mocked-accelerator test
    pattern)."""

    def __init__(self, cluster_runtime):
        self._rt = cluster_runtime
        self._vms: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()

    def create_vm(self, name: str, machine_type: str,
                  extra_labels=None) -> None:
        res, labels = machine_node_resources(machine_type)
        # Record CREATING before the host boots (like the real API: the
        # instance exists at once, RUNNING once it is up) — a lister
        # mid-boot must see the VM, not nothing.
        with self._lock:
            self._vms[name] = {"name": name, "machine_type": machine_type,
                               "state": "CREATING", "node": None}
        node = self._rt.add_node(
            num_cpus=8.0, resources=res,
            labels={**labels, **(extra_labels or {}), "gce-vm": name})
        with self._lock:
            vm = self._vms.get(name)
            if vm is None:
                # Deleted mid-create: tear the host back down.
                try:
                    node.proc.terminate()
                except Exception:
                    pass
                return
            vm.update(state="RUNNING", node=node)

    def list_vms(self) -> List[Dict[str, Any]]:
        with self._lock:
            out = []
            for vm in self._vms.values():
                node = vm["node"]
                if node is None:
                    out.append({"name": vm["name"],
                                "machine_type": vm["machine_type"],
                                "state": "CREATING", "node_ids": []})
                    continue
                alive = node.proc.poll() is None
                out.append({"name": vm["name"],
                            "machine_type": vm["machine_type"],
                            "state": "RUNNING" if alive else "TERMINATED",
                            "node_ids": [node.node_id] if alive else []})
            return out

    def delete_vm(self, name: str) -> None:
        with self._lock:
            vm = self._vms.pop(name, None)
        if vm is None or vm["node"] is None:
            return
        try:
            vm["node"].proc.terminate()
        except Exception:
            pass


class GceGpuNodeProvider(NodeProvider):
    """NodeProvider over the GCE compute API. A provider "node" is one
    VM; ``cluster_node_ids`` maps it to the cluster node it registered
    as, which the autoscaler uses for idleness and drain decisions."""

    def __init__(self, api: GceGpuApi,
                 node_types: Optional[Dict[str, Dict[str, Any]]] = None):
        self._api = api
        #: name -> {"machine_type": ..., plus the resources one machine
        #: advertises (what the bin-packer matches demands to)}
        self.node_types = node_types or {
            "gpu-a3-1g": {"CPU": 8.0, "GPU": 1.0,
                          "machine_type": "a3-highgpu-1g"},
        }

    def create_node(self, node_type: str) -> str:
        spec = self.node_types[node_type]
        name = f"{node_type}-{uuid.uuid4().hex[:8]}"
        # Signature probe, not try/except TypeError: catching the live
        # call would mask real TypeErrors AND silently drop labels (an
        # unlabeled VM can never satisfy a label demand — launch loop).
        params = inspect.signature(self._api.create_vm).parameters
        if "extra_labels" in params:
            self._api.create_vm(name, spec["machine_type"],
                                dict(spec.get("_labels", {})))
        else:
            self._api.create_vm(name, spec["machine_type"])
        return name

    def terminate_node(self, provider_node_id: str) -> None:
        self._api.delete_vm(provider_node_id)

    def non_terminated_nodes(self) -> List[str]:
        return [vm["name"] for vm in self._api.list_vms()
                if vm["state"] != "TERMINATED"]

    def cluster_node_ids(self, provider_node_id: str) -> List[str]:
        return self.cluster_node_map().get(provider_node_id, [])

    def cluster_node_map(self) -> Dict[str, List[str]]:
        """One cloud list call covering every VM — the autoscaler
        snapshots this once per reconcile pass."""
        return {vm["name"]: list(vm["node_ids"])
                for vm in self._api.list_vms()}
