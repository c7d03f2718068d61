"""The port's device ingest (``ray_tpu_torch/data/_ingest.py``) on the CPU,
against ``ray_tpu``'s ``jax.device_put`` loader where both run.

``device_put="cpu"`` takes the loader thread and queue that a card's
batches take (pinning and the copy stream are the card's alone: the card
tests in ``tests/test_torch_cuda.py`` cover them). Held here: batches
equal to the host batches in order and values (to ``ray_tpu``'s device
batches too), a non-contiguous block slice staged contiguous, object
columns passed through; backpressure at ``depth`` (the loader pulls as
many host batches as ``ray_tpu``'s does); an early ``break`` stops the
loader, which closes the host generator from its own thread; an error in
the host pipeline or in a batch's conversion raises on the consumer;
``device_put="cuda"`` without a card raises. Both packages run on their
in-process runtimes: there the port keeps the pull executor (``ray_tpu``'s
streaming executor fails on its own in-process runtime), and a killed
actor-pool actor runs its transform's ``__del__``.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

import ray_tpu.data as jdata
import ray_tpu_torch
import ray_tpu_torch.data as tdata
from ray_tpu.data._ingest import device_batches as jdevice_batches
from ray_tpu_torch.data._executor import streaming_available
from ray_tpu_torch.data._ingest import device_batches
from tests.torch_data_common import AddBias, assert_same_rows, ray_tpu_local

JAX_CPU = jax.devices("cpu")[0]


@pytest.fixture(scope="module")
def runtimes():
    with ray_tpu_local():
        ray_tpu_torch.init(local_mode=True)
        try:
            yield
        finally:
            ray_tpu_torch.shutdown()


def _loader_threads():
    return [t for t in threading.enumerate() if t.name == "rtt-data-ingest"]


def _columns(n=64):
    rng = np.random.default_rng(0)
    return {
        "id": np.arange(n),
        # Fortran order: a block's row slice is not C-contiguous.
        "x": np.asfortranarray(rng.normal(size=(n, 3)).astype(np.float32)),
        "s": np.array([f"w{i}" for i in range(n)], dtype=object),
    }


def test_order_and_values_against_host_batches(runtimes):
    """(``ray_tpu``'s loader takes the numeric columns only: its
    ``jax.device_put`` refuses an object column.)"""
    def make(d, cols):
        return d.from_numpy(cols, parallelism=3)

    numeric = {k: v for k, v in _columns().items() if k != "s"}
    host = list(make(tdata, _columns()).iter_batches(batch_size=16))
    dev = list(make(tdata, _columns()).iter_batches(batch_size=16,
                                                    device_put="cpu"))
    jdev = list(make(jdata, numeric).iter_batches(batch_size=16,
                                                  device_put=JAX_CPU))
    assert [len(b["id"]) for b in dev] == [16, 16, 16, 16]
    assert len(dev) == len(host) == len(jdev)
    for d, h, j in zip(dev, host, jdev):
        for k in ("id", "x"):
            assert isinstance(d[k], torch.Tensor)
            assert d[k].is_contiguous() and d[k].device.type == "cpu"
            np.testing.assert_array_equal(d[k].numpy(), h[k])
            np.testing.assert_array_equal(d[k].numpy(), np.asarray(j[k]))
        assert d["s"] is not None and list(d["s"]) == list(h["s"])
        assert d["s"].dtype == object


def test_noncontiguous_slice_is_staged_contiguous():
    x = np.asfortranarray(np.arange(24, dtype=np.float32).reshape(8, 3))
    view = x[2:6]
    assert not view.flags.c_contiguous
    (batch,) = list(device_batches(iter([{"x": view}]), "cpu", 2))
    assert batch["x"].is_contiguous()
    np.testing.assert_array_equal(batch["x"].numpy(), view)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_backpressure_at_depth(depth):
    """A consumer holding its first batch: the loader pulls ``depth`` + 2
    host batches (the consumer's, ``depth`` queued, one in the loader's
    hand) and no more, as ``ray_tpu``'s loader does."""

    def counted(device_batches_fn, device):
        pulled = []

        def host():
            for i in range(32):
                pulled.append(i)
                yield {"i": np.array([i])}

        it = device_batches_fn(host(), device, depth)
        first = next(it)
        deadline = time.monotonic() + 10.0
        n = -1
        while time.monotonic() < deadline:    # wait for the loader to stall
            time.sleep(0.2)
            if len(pulled) == n:
                break
            n = len(pulled)
        it.close()
        return int(np.asarray(first["i"])[0]), n

    assert counted(device_batches, "cpu") == (0, depth + 2)
    assert counted(jdevice_batches, JAX_CPU) == (0, depth + 2)
    assert _loader_threads() == []


def test_early_break_stops_loader_and_closes_host_generator():
    closed = []

    def host():
        try:
            for i in range(1000):
                yield {"i": np.array([i])}
        finally:
            closed.append(threading.current_thread().name)

    it = device_batches(host(), "cpu", 2)
    for batch in it:
        if int(batch["i"][0]) == 3:
            break
    it.close()
    assert closed == ["rtt-data-ingest"]
    assert _loader_threads() == []


def test_early_break_from_a_dataset_runs_the_pipeline_finalizers(runtimes):
    ds = tdata.range(4000, parallelism=8).map_batches(
        lambda b: {"id": b["id"] * 2})
    it = ds.iter_batches(batch_size=10, device_put="cpu")
    first = next(it)
    np.testing.assert_array_equal(first["id"].numpy(), np.arange(10) * 2)
    it.close()
    assert _loader_threads() == []


def test_error_in_the_host_pipeline_raises_on_the_consumer():
    def host():
        yield {"i": np.array([0])}
        yield {"i": np.array([1])}
        raise ValueError("host pipeline broke")

    got = []
    with pytest.raises(ValueError, match="host pipeline broke"):
        for batch in device_batches(host(), "cpu", 2):
            got.append(int(batch["i"][0]))
    assert got == [0, 1]
    assert _loader_threads() == []


def test_error_in_a_conversion_raises_on_the_consumer():
    """A column torch cannot hold (float128) fails its batch's
    conversion in the loader; the consumer gets the error after the
    batches before it."""
    batches = [{"x": np.zeros(2)}, {"x": np.zeros(2, dtype=np.longdouble)}]
    got = []
    with pytest.raises(TypeError):
        for batch in device_batches(iter(batches), "cpu", 2):
            got.append(batch)
    assert len(got) == 1
    assert _loader_threads() == []


def test_error_in_a_transform_raises_on_the_consumer(runtimes):
    def boom(b):
        if b["id"][0] >= 20:
            raise RuntimeError("transform broke")
        return b

    ds = tdata.range(40, parallelism=4).map_batches(boom)
    with pytest.raises(Exception, match="transform broke"):
        list(ds.iter_batches(batch_size=5, device_put="cpu"))
    assert _loader_threads() == []


def test_cuda_without_a_card_raises(runtimes):
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py covers it")
    ds = tdata.range(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(ds.iter_batches(batch_size=4, device_put="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(device_batches(iter([{"x": np.zeros(1)}]), "cuda:0", 2))
    with pytest.raises(ValueError, match="a CUDA device or the CPU"):
        next(device_batches(iter([{"x": np.zeros(1)}]), "meta", 2))
    assert _loader_threads() == []


def test_in_process_runtime_keeps_the_pull_executor(runtimes):
    """``ray_tpu``'s streaming check admits its in-process runtime, whose
    first map stage then fails ("already a reader"); the port keeps the
    pull executor there, and the rows are ``ray_tpu``'s."""
    from ray_tpu.core.config import GLOBAL_CONFIG as jcfg

    def make(d):
        return d.range(40, parallelism=4).map_batches(
            lambda b: {"id": b["id"] * 2}).map_batches(
            AddBias, fn_constructor_kwargs={"bias": 1}, concurrency=2)

    assert not streaming_available()
    assert_same_rows(make(tdata).take_all(), make(jdata).take_all())
    jcfg.set("data_executor", "streaming")
    try:
        with pytest.raises(RuntimeError, match="already a reader"):
            make(jdata).take_all()
    finally:
        jcfg.set("data_executor", "pull")


class _Closing:
    """A transform whose ``__del__`` says so (the LLM processor's stage
    closes its engine there)."""

    closed = []

    def __call__(self, b):
        return b

    def __del__(self):
        type(self).closed.append(True)


def test_killed_pool_actor_runs_the_transforms_del(runtimes):
    _Closing.closed.clear()
    rows = tdata.range(12, parallelism=3).map_batches(
        _Closing, concurrency=2).take_all()
    assert [r["id"] for r in rows] == list(range(12))
    assert len(_Closing.closed) >= 2
