"""Shared pieces of the ``tests/test_torch_data*.py`` files.

The port's cluster ships a function or class by reference when its module
can be imported, so the transforms and train loops its workers run live
here, in a module that imports neither JAX nor ``ray_tpu`` at import time
(the runtime helpers below import both packages inside their bodies, in
the test process only).
"""

import contextlib
import os
import sys
import time

import numpy as np


def foreign_modules():
    """The jax*, jaxlib and ray_tpu modules loaded in this process."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))


# ------------------------------------------------------------ runtimes


@contextlib.contextmanager
def ray_tpu_local():
    """``ray_tpu`` on its in-process runtime with the pull executor: its
    streaming executor does not run there (both ends of a lane's queue
    are one object in one process), and pull and streaming are
    row-identical by design. Exchanges take the task path there."""
    import ray_tpu
    from ray_tpu.core.config import GLOBAL_CONFIG as jcfg

    old = jcfg.data_executor
    ray_tpu.init(local_mode=True)
    jcfg.set("data_executor", "pull")
    try:
        yield
    finally:
        jcfg.set("data_executor", old)
        ray_tpu.shutdown()


@contextlib.contextmanager
def port_cluster(**kw):
    """The port's cluster runtime (a head, a node manager and worker
    processes), shut down and its processes reaped on exit."""
    import ray_tpu_torch

    kw.setdefault("num_cpus", 4)
    kw.setdefault("object_store_memory", 256 << 20)
    rt = ray_tpu_torch.init(**kw)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()
        for p in rt._procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


@contextlib.contextmanager
def both(**kw):
    """``ray_tpu``'s in-process runtime and the port's cluster."""
    with ray_tpu_local(), port_cluster(**kw) as rt:
        yield rt


# ------------------------------------------------------------ comparing


def assert_same_value(got, want, what=""):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), (what, type(got))
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif isinstance(want, np.generic):
        assert type(got) is type(want), (what, type(got), type(want))
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif isinstance(want, float) and want != want:
        assert got != got, (what, got)
    elif hasattr(want, "equals"):           # a pyarrow array or scalar
        assert type(got) is type(want) and got.equals(want), (what, got)
    else:
        assert type(got) is type(want) and got == want, (what, got, want)


def assert_same_rows(got, want):
    """Row lists equal in order, keys, value types and values."""
    assert len(got) == len(want), (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert list(g) == list(w), (i, list(g), list(w))
        for k in w:
            assert_same_value(g[k], w[k], f"row {i} column {k!r}")


def assert_same_block(got, want):
    assert list(got) == list(want), (list(got), list(want))
    for k in want:
        if hasattr(want[k], "equals"):
            assert got[k].equals(want[k]), k
        else:
            assert_same_value(got[k], want[k], k)


def files_of(paths):
    """{basename: bytes} of written files."""
    out = {}
    for p in paths:
        with open(p, "rb") as f:
            out[os.path.basename(p)] = f.read()
    return out


# ------------------------------------------- shipped to the workers


class AddBias:
    def __init__(self, bias):
        self.bias = bias

    def __call__(self, batch):
        return {"id": batch["id"] + self.bias}


class Slowish:
    """Tags each row with its process (an autoscaled pool spreads rows
    over several)."""

    def __call__(self, b):
        time.sleep(0.05)
        return {"id": b["id"], "pid": np.full(len(b["id"]), os.getpid())}


def random_keys(i, n):
    """Read task of the out-of-core sort: ``n`` keys from seed ``i``."""
    rng = np.random.default_rng(i)
    return {"x": rng.integers(0, 1 << 30, n)}


def slow_triple(b):
    time.sleep(0.2)  # keep lanes mid-stream long enough to kill one
    return {"v": b["id"] * 3}


def feeds_trainer_loop(config):
    """``tests/test_data.py::test_dataset_feeds_trainer``'s loop on the
    port: the worker's shard through ``train.iter_device_batches`` on the
    CPU; writes the shard's type, the batches' sum and rows, whether every
    batch came as CPU tensors and the foreign modules of the worker to
    ``config["out"]/rank<r>.json``."""
    import json

    import torch

    from ray_tpu_torch import train

    rank = train.get_context().get_world_rank()
    shard = train.get_dataset_shard("train")
    total, nrows, tensors = 0, 0, True
    for batch in train.iter_device_batches("train", batch_size=8,
                                           device="cpu"):
        tensors &= (isinstance(batch["id"], torch.Tensor)
                    and batch["id"].device.type == "cpu")
        total += int(batch["id"].sum())
        nrows += len(batch["id"])
    with open(os.path.join(config["out"], f"rank{rank}.json"), "w") as f:
        json.dump({"total": total, "rows": nrows, "tensors": tensors,
                   "shard": f"{type(shard).__module__}."
                            f"{type(shard).__name__}",
                   "foreign": foreign_modules()}, f)
    train.report({"total": total})
