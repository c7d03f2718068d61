"""Accelerator managers: detection, machine shapes, process isolation
(``ray_tpu/core/accelerators.py`` for CUDA cards).

Parity target: the reference's pluggable accelerator managers
(reference: python/ray/_private/accelerators/accelerator.py ABC;
nvidia_gpu.py NvidiaGPUAcceleratorManager — the card count, the card's
model from its name, ``CUDA_VISIBLE_DEVICES`` isolation). ``ray_tpu``'s
TPU manager becomes the GPU manager here; the ABC is kept.

Reading the card's model opens no CUDA context: the name comes from NVML
(``libnvidia-ml.so.1`` through ``ctypes``) or ``nvidia-smi``, never from
``torch.cuda.get_device_name``, which would initialise CUDA and hold a
context (and several hundred MB of the card) in the node manager.

All probing is env-mockable, as ``ray_tpu``'s is: set ``RTPU_GPUS`` and
``RTPU_GPU_ACCELERATOR_TYPE`` to simulate any machine on a host without
cards.

Machine shapes take the place of ``ray_tpu``'s slice shapes: a GPU
machine is one host with ``n`` cards of one model (GCE's accelerator-
optimized machine types), never a multi-host slice, so a shape has no
``-head`` resource and no slice strategy.
"""

from __future__ import annotations

import os
import re
import subprocess
from typing import Dict, List, MutableMapping, Optional, Tuple

from ray_tpu_torch.core.resources import LABEL_ACCELERATOR_TYPE

# Ray's NVIDIA manager maps a card's name to its model by this pattern
# (nvidia_gpu.py NVIDIA_GPU_NAME_PATTERN): "NVIDIA H100 80GB HBM3" -> "H100",
# "Tesla V100-SXM2-16GB" -> "V100".
_NVIDIA_GPU_NAME_PATTERN = re.compile(r"\w+\s+([A-Z0-9]+)")

# GCE accelerator-optimized machine types: (card model, cards)
# (cloud.google.com/compute/docs/accelerator-optimized-machines).
GCE_GPU_MACHINE_TYPES: Dict[str, Tuple[str, int]] = {
    "a2-highgpu-1g": ("A100", 1),
    "a2-highgpu-2g": ("A100", 2),
    "a2-highgpu-4g": ("A100", 4),
    "a2-highgpu-8g": ("A100", 8),
    "a2-megagpu-16g": ("A100", 16),
    "a3-highgpu-1g": ("H100", 1),
    "a3-highgpu-2g": ("H100", 2),
    "a3-highgpu-4g": ("H100", 4),
    "a3-highgpu-8g": ("H100", 8),
    "a3-megagpu-8g": ("H100", 8),
    "a3-ultragpu-8g": ("H200", 8),
    "g2-standard-4": ("L4", 1),
    "g2-standard-24": ("L4", 2),
    "g2-standard-48": ("L4", 4),
    "g2-standard-96": ("L4", 8),
}


class AcceleratorManager:
    """ABC (reference: accelerator.py): one per vendor."""

    @staticmethod
    def get_resource_name() -> str:
        raise NotImplementedError

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        raise NotImplementedError

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        raise NotImplementedError

    @staticmethod
    def set_visible_accelerators(
            ids: List, env: Optional[MutableMapping[str, str]] = None) -> None:
        """Restrict a process to the given accelerator ids: ``env`` (a
        spawn's environment) or this process's own."""
        raise NotImplementedError


def gpu_name_to_accelerator_type(name: Optional[str]) -> Optional[str]:
    """A card's name -> its short model ("NVIDIA H100 80GB HBM3" ->
    "H100"); a name the pattern does not take is returned as it is."""
    if not name:
        return None
    name = name.strip()
    m = _NVIDIA_GPU_NAME_PATTERN.match(name)
    return m.group(1) if m else name


def _first_visible_index() -> int:
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")[0].strip()
    return int(first) if first.isdigit() else 0


def _nvml_name(index: int) -> Optional[str]:
    """The card's name through NVML, which opens no CUDA context."""
    import ctypes

    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    nvml.nvmlInit_v2.argtypes = []
    nvml.nvmlShutdown.argtypes = []
    nvml.nvmlDeviceGetHandleByIndex_v2.argtypes = [
        ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
    nvml.nvmlDeviceGetName.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_uint]
    for fn in (nvml.nvmlInit_v2, nvml.nvmlShutdown,
               nvml.nvmlDeviceGetHandleByIndex_v2, nvml.nvmlDeviceGetName):
        fn.restype = ctypes.c_int  # nvmlReturn_t: 0 is success
    if nvml.nvmlInit_v2() != 0:
        return None
    try:
        handle = ctypes.c_void_p()
        if nvml.nvmlDeviceGetHandleByIndex_v2(
                ctypes.c_uint(index), ctypes.byref(handle)) != 0:
            return None
        buf = ctypes.create_string_buffer(96)
        if nvml.nvmlDeviceGetName(handle, buf, ctypes.c_uint(96)) != 0:
            return None
        return buf.value.decode(errors="replace") or None
    finally:
        nvml.nvmlShutdown()


def _smi_name(index: int) -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader",
             "-i", str(index)], capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    return lines[0] if out.returncode == 0 and lines else None


class GPUAcceleratorManager(AcceleratorManager):
    """CUDA card detection and isolation (reference: nvidia_gpu.py)."""

    @staticmethod
    def get_resource_name() -> str:
        return "GPU"

    @staticmethod
    def get_current_node_num_accelerators() -> float:
        """``RTPU_GPUS`` first, then ``torch.cuda.device_count()``, which
        opens no CUDA context."""
        env = os.environ.get("RTPU_GPUS")
        if env is not None:
            try:
                return float(env)
            except ValueError:
                return 0.0
        import torch

        return float(torch.cuda.device_count())

    @staticmethod
    def get_current_node_accelerator_name() -> Optional[str]:
        """The full name of this process's first visible card
        ("NVIDIA H100 80GB HBM3"): ``RTPU_GPU_ACCELERATOR_TYPE``, else
        NVML, else ``nvidia-smi``; None where none answers."""
        env = os.environ.get("RTPU_GPU_ACCELERATOR_TYPE")
        if env is not None:
            return env or None
        index = _first_visible_index()
        return _nvml_name(index) or _smi_name(index)

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        """The short model ("H100"), read without a CUDA context."""
        return gpu_name_to_accelerator_type(
            GPUAcceleratorManager.get_current_node_accelerator_name())

    @staticmethod
    def set_visible_accelerators(
            ids: List, env: Optional[MutableMapping[str, str]] = None) -> None:
        """Restrict a process to the given card ids: ``env`` (a spawn's
        environment) or this process's own."""
        target = os.environ if env is None else env
        target["CUDA_VISIBLE_DEVICES"] = ",".join(str(i) for i in ids)


def parse_machine_shape(machine_type: str) -> Tuple[str, int]:
    """"a3-highgpu-8g" -> (card model, cards) of that GCE machine type. One machine is one host: a shape never spans hosts."""
    try:
        return GCE_GPU_MACHINE_TYPES[machine_type]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown GPU machine type {machine_type!r} (expected one of "
            f"{sorted(GCE_GPU_MACHINE_TYPES)})") from None


def machine_node_resources(machine_type: str) -> Tuple[Dict[str, float],
                                                       Dict[str, str]]:
    """(resources, labels) one machine of this type contributes to the
    cluster: its cards as ``GPU``, and its model as ``accelerator-type``
    and as the label the GPU manager's detection gives such a host."""
    model, cards = parse_machine_shape(machine_type)
    return ({"GPU": float(cards)},
            {"accelerator-type": model, LABEL_ACCELERATOR_TYPE: model,
             "machine-type": machine_type})
