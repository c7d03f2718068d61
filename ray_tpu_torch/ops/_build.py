"""Build the port's CUDA sources with ``nvcc`` at first use; load them with
``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for Hopper only::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

No PyTorch headers are included, so a build takes seconds, not minutes.
The output name carries a hash of the sources (every file in ``csrc/``)
and the flags: a stale library is never loaded, and an unchanged one is
never rebuilt. Builds of all stale sources start together (one ``nvcc``
each) and every library is written under a temporary name and moved into
place with ``os.replace``, so processes that build at the same time never
load a partial file. ``ptxas``'s register and shared-memory report is kept
beside each library as ``<lib>.log``.

Nothing here runs at import time: the CPU test suite imports every module
on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("decode_attention", "flash_attention", "fused")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Storage-dtype codes of the C entry points (csrc/common.cuh: rtt::DType).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((str(Path(home) / "bin" / "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from ray_tpu_torch/csrc at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build(names: Sequence[str] = SOURCES) -> List[Path]:
    """Compile every source in ``names`` whose library is missing, all
    ``nvcc`` processes at once. Raises RuntimeError with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = [library_path(n) for n in names]
    jobs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        tmp = out.with_name(
            f".{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    errors = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        log_tmp = tmp.with_suffix(".log")
        log_tmp.write_text(log)
        os.replace(log_tmp, out.with_name(out.name + ".log"))
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            (path,) = build([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def build_log(name: str) -> str:
    """ptxas's report (registers, shared memory, spills) for a built
    library; empty when it was not built yet."""
    log = library_path(name).with_name(library_path(name).name + ".log")
    return log.read_text() if log.exists() else ""


def check(rc: int, what: str) -> None:
    """Raise on a C entry point's return code: -1 = shapes or dtype the
    kernel does not take, -2 = no TMA descriptor could be built (the
    driver's ``cuTensorMapEncodeTiled`` missing or refusing the tensor),
    otherwise a CUDA error from the launch."""
    if rc == -1:
        raise ValueError(f"{what}: unsupported shape or dtype")
    if rc == -2:
        raise RuntimeError(f"{what}: the driver could not build a TMA "
                           "descriptor for the operands")
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{rc}")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
