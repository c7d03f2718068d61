"""The GPU accelerator manager and the GCE GPU provider
(``ray_tpu_torch/core/accelerators.py``, ``autoscaler/gce.py``), as
``tests/test_autoscaler_gce.py`` holds ``ray_tpu``'s TPU manager and
slice provider: machine shapes in place of slice shapes, the manager's
env probing and isolation, a fake-GCE VM provisioned end to end for a GPU
demand, and one create_node booting one host with its cards and model.
"""

import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import Autoscaler, AutoscalerConfig
from ray_tpu_torch.autoscaler.gce import FakeGceApi, GceGpuNodeProvider
from ray_tpu_torch.core.accelerators import (GPUAcceleratorManager,
                                             gpu_name_to_accelerator_type,
                                             machine_node_resources,
                                             parse_machine_shape)
from ray_tpu_torch.core.resources import LABEL_ACCELERATOR_TYPE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cluster():
    rt = ray_tpu_torch.init(num_cpus=2, object_store_memory=128 << 20)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


# ----------------------------------------------------------- shape math


def test_parse_machine_shape():
    assert parse_machine_shape("a3-highgpu-8g") == ("H100", 8)
    assert parse_machine_shape("a3-highgpu-1g") == ("H100", 1)
    assert parse_machine_shape("a2-highgpu-4g") == ("A100", 4)
    assert parse_machine_shape("g2-standard-4") == ("L4", 1)
    with pytest.raises(ValueError):
        parse_machine_shape("v5p-8")
    with pytest.raises(ValueError):
        parse_machine_shape("n2-standard-8")


def test_machine_node_resources_and_card_models():
    """One host's cards as ``GPU`` and the model as its label; no
    ``-head`` resource (a GPU machine is never a multi-host slice)."""
    res, labels = machine_node_resources("a3-highgpu-4g")
    assert res == {"GPU": 4.0}
    assert labels == {"accelerator-type": "H100",
                      LABEL_ACCELERATOR_TYPE: "H100",
                      "machine-type": "a3-highgpu-4g"}
    assert not any(k.endswith("-head") for k in res)
    assert gpu_name_to_accelerator_type("NVIDIA H100 80GB HBM3") == "H100"
    assert gpu_name_to_accelerator_type("NVIDIA A100-SXM4-80GB") == "A100"
    assert gpu_name_to_accelerator_type("Tesla V100-SXM2-16GB") == "V100"
    assert gpu_name_to_accelerator_type("H100") == "H100"
    assert gpu_name_to_accelerator_type(None) is None


def test_accelerator_manager_env_probing(monkeypatch):
    monkeypatch.setenv("RTPU_GPUS", "4")
    monkeypatch.setenv("RTPU_GPU_ACCELERATOR_TYPE", "NVIDIA H100 80GB HBM3")
    m = GPUAcceleratorManager
    assert m.get_resource_name() == "GPU"
    assert m.get_current_node_num_accelerators() == 4
    assert m.get_current_node_accelerator_name() == "NVIDIA H100 80GB HBM3"
    assert m.get_current_node_accelerator_type() == "H100"
    env = {}
    m.set_visible_accelerators([0, 2], env)
    assert env == {"CUDA_VISIBLE_DEVICES": "0,2"}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5")
    m.set_visible_accelerators([1])
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "1"
    # The node's detection goes through the manager: the model labels it.
    from ray_tpu_torch.core.resources import detect_node_resources

    nr = detect_node_resources(num_cpus=1)
    assert nr.total.to_dict()["GPU"] == 4.0
    assert nr.labels[LABEL_ACCELERATOR_TYPE] == "H100"


@pytest.mark.parametrize("gpus,name,want", [
    ("2", "NVIDIA H100 80GB HBM3", (2.0, {LABEL_ACCELERATOR_TYPE: "H100"})),
    ("8", "NVIDIA A100-SXM4-80GB", (8.0, {LABEL_ACCELERATOR_TYPE: "A100"})),
    ("1", "", (1.0, {LABEL_ACCELERATOR_TYPE: "GPU"})),
    ("0", "NVIDIA H100 80GB HBM3", (0.0, {})),
    ("x", "NVIDIA H100 80GB HBM3", (0.0, {})),
])
def test_detect_gpu_reads_the_manager_env_overrides(monkeypatch, gpus, name,
                                                    want):
    """``_detect_gpu``, which labels every node, counts the cards from
    ``RTPU_GPUS`` and names their model from ``RTPU_GPU_ACCELERATOR_TYPE``;
    an unreadable name labels the cards ``GPU``, and no card no label."""
    from ray_tpu_torch.core.resources import _detect_gpu

    monkeypatch.setenv("RTPU_GPUS", gpus)
    monkeypatch.setenv("RTPU_GPU_ACCELERATOR_TYPE", name)
    assert _detect_gpu() == want


def test_detection_reads_no_card_through_cuda():
    """In a fresh process, the manager's count and model leave CUDA
    uninitialised (no context in a node manager); on this host, without
    a card, the count is 0 and the model None."""
    code = (
        "import json, sys\n"
        "from ray_tpu_torch.core.accelerators import GPUAcceleratorManager"
        " as m\n"
        "n = m.get_current_node_num_accelerators()\n"
        "t = m.get_current_node_accelerator_type()\n"
        "import torch\n"
        "print(json.dumps([n, t, torch.cuda.is_initialized()]))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RTPU_GPUS", "RTPU_GPU_ACCELERATOR_TYPE")}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    import json

    n, model, initialised = json.loads(out.stdout.strip().splitlines()[-1])
    assert initialised is False
    import torch

    if not torch.cuda.is_available():
        assert n == 0.0


# ------------------------------------------------------- fake-GCE scaling


def test_autoscaler_provisions_gpu_vm_end_to_end(cluster):
    """GPU demand -> the autoscaler creates a fake-GCE a3-highgpu-1g VM ->
    its host registers the card and model of its machine type -> the
    queued GPU task runs on it; the idle VM is reaped
    through the cloud API."""
    api = FakeGceApi(cluster)
    provider = GceGpuNodeProvider(api, node_types={
        "gpu-a3-1g": {"CPU": 8.0, "GPU": 1.0,
                      "machine_type": "a3-highgpu-1g"}})
    scaler = Autoscaler(cluster, provider, AutoscalerConfig(
        max_nodes=4, idle_timeout_s=3.0))

    @ray_tpu_torch.remote(num_cpus=0, num_gpus=1)
    def gpu_task():
        return ray_tpu_torch.get_runtime_context().node_id

    ref = gpu_task.remote()
    deadline = time.monotonic() + 30
    did = {"launched": []}
    while time.monotonic() < deadline and not did["launched"]:
        time.sleep(1.0)
        did = scaler.step()
    assert did["launched"] == ["gpu-a3-1g"], did
    node_id = ray_tpu_torch.get(ref, timeout=120)
    vms = api.list_vms()
    assert len(vms) == 1 and vms[0]["state"] == "RUNNING"
    assert node_id in vms[0]["node_ids"], "task ran off the VM"

    from ray_tpu_torch.util import state as state_api

    nodes = {n["node_id"]: n for n in state_api.list_nodes()}
    vm_node = nodes[node_id]
    assert vm_node["resources"].get("GPU") == 1.0
    assert vm_node["labels"]["accelerator-type"] == "H100"
    assert vm_node["labels"][LABEL_ACCELERATOR_TYPE] == "H100"
    # The demand stays in the head's window for a while, so a pass may
    # launch a second VM before the first is seen idle: poll until the
    # provider is empty, not until the first reap.
    deadline = time.monotonic() + 60
    reaped = []
    while time.monotonic() < deadline and provider.non_terminated_nodes():
        time.sleep(1.0)
        reaped += scaler.step()["reaped"]
    assert reaped and not provider.non_terminated_nodes()
    assert not [vm for vm in api.list_vms() if vm["state"] != "TERMINATED"]


def test_one_create_node_boots_one_host_with_its_cards(cluster):
    """create_node("a3-highgpu-8g") boots ONE host carrying 8 cards, its
    model and its machine type; delete terminates it."""
    api = FakeGceApi(cluster)
    provider = GceGpuNodeProvider(api, node_types={
        "gpu-a3-8g": {"CPU": 8.0, "GPU": 8.0,
                      "machine_type": "a3-highgpu-8g",
                      "_labels": {"pool": "train"}}})
    vm = provider.create_node("gpu-a3-8g")
    cids = provider.cluster_node_ids(vm)
    assert len(cids) == 1

    from ray_tpu_torch.util import state as state_api

    deadline = time.monotonic() + 60
    node = None
    while time.monotonic() < deadline and node is None:
        node = next((n for n in state_api.list_nodes()
                     if n["node_id"] == cids[0] and n["alive"]), None)
        time.sleep(0.2)
    assert node is not None, "the VM's host did not register"
    assert node["resources"]["GPU"] == 8.0
    assert node["labels"]["machine-type"] == "a3-highgpu-8g"
    assert node["labels"]["pool"] == "train"
    assert node["labels"]["gce-vm"] == vm
    assert not any(k.endswith("-head") for k in node["resources"])
    provider.terminate_node(vm)
    assert provider.non_terminated_nodes() == []
