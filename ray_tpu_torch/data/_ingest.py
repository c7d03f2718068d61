"""Double-buffered device ingest: overlap host loading with device steps.

The port of ``ray_tpu/data/_ingest.py``, whose loader thread issues
``jax.device_put``; here the loader stages each batch in pinned host
memory and copies it to the card on a side stream.

:func:`device_batches` moves the whole host pipeline (block fetch,
concat, re-chunk, the host-to-device copy) onto a background loader
thread that feeds a bounded :class:`~ray_tpu_torch.data._queues.LocalQueue`
of batches already on their way to the card:

- every numeric numpy column becomes a tensor
  (``torch.from_numpy(np.ascontiguousarray(v))``: a block slice may be a
  view that is not contiguous), is copied into pinned host memory, and is
  copied to the device with ``non_blocking=True`` on a ``torch.cuda.Stream``
  of that device owned by this call; an event is recorded after the
  batch's copies. The pinned staging tensor is dropped at once: PyTorch's
  caching host allocator records the copy's event on it and hands the
  block out again only once that copy has completed;
- before the consumer's thread gets a batch, its current stream waits on
  that event, and every tensor of the batch is ``record_stream``-ed on it,
  so the caching allocator never gives a batch's memory to a later copy
  while the consumer's stream may still read it;
- object and string columns pass through untouched, as in
  ``Dataset.iter_torch_batches``.

``device_put="cpu"`` (or ``torch.device("cpu")``) takes the same path and
yields CPU tensors (no pinning, no stream). A ``cuda`` device without a
card raises; an error in the host pipeline or in a copy raises on the
consumer's thread. Nothing falls back to the CPU.

The queue bound is the device-memory bound: at most ``depth + 1`` batches
wait on the device at once (``depth`` in the queue and the one the loader
holds while the queue is full), and a slow consumer blocks the loader
(backpressure, not unbounded device allocation).

Early close (``break`` out of the train loop) shuts the queue down, which
frees the batches in it and unblocks and ends the loader thread; the
loader closes the host generator from its own thread on its way out, so
the streaming executor's finalizers run too.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator

import numpy as np

from ray_tpu_torch.data._queues import LocalQueue, QueueStopped

__all__ = ["device_batches"]

_BATCH, _ERR = 0, 1


def _numeric(v) -> bool:
    return isinstance(v, np.ndarray) and v.dtype.kind in "biufc"


def device_batches(host_batches: Iterator[Dict[str, Any]],
                   device_put: Any,
                   depth: int,
                   ) -> Iterator[Dict[str, Any]]:
    """Yield ``host_batches`` with their numeric columns as tensors on the
    device ``device_put``, ``depth``-deep double-buffered: a loader thread
    pulls host batches and issues their copies ahead of the consumer."""
    import torch

    device = torch.device(device_put)
    stream = None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device_put={device_put!r}: no CUDA device is visible to "
                "this process")
        if device.index is None:
            # The consumer thread's card (a GPU worker's own, cuda:0).
            device = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.Stream(device=device)
    elif device.type != "cpu":
        raise ValueError(f"device_put={device_put!r}: a CUDA device or the "
                         "CPU")

    def to_device(hb: Dict[str, Any]):
        if stream is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    if _numeric(v) else v for k, v in hb.items()}, None
        out = {}
        with torch.cuda.stream(stream):
            for k, v in hb.items():
                if _numeric(v):
                    staged = torch.from_numpy(
                        np.ascontiguousarray(v)).pin_memory()
                    out[k] = staged.to(device, non_blocking=True)
                else:
                    out[k] = v
            copied = torch.cuda.Event()
            copied.record(stream)
        return out, copied

    depth = max(1, int(depth))
    q = LocalQueue(depth, name="device_ingest")
    stop = threading.Event()

    def load():
        try:
            # The loader thread has no current device until it sets one.
            with (torch.cuda.device(device) if stream is not None
                  else contextlib.nullcontext()):
                for hb in host_batches:
                    if stop.is_set():
                        break
                    q.put((_BATCH, to_device(hb)))
        except Exception as e:  # surfaced on the consumer thread
            try:
                q.put((_ERR, e), timeout=60.0)
            except Exception:  # rtpu-lint: disable=swallowed-exception — best-effort error forwarding to a possibly-gone consumer
                pass
        finally:
            q.put_stop()
            # Close the host generator from THIS thread (the one
            # iterating it) so upstream finalizers run on early break.
            close = getattr(host_batches, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # rtpu-lint: disable=swallowed-exception — best-effort generator close in teardown
                    pass

    loader = threading.Thread(target=load, name="rtt-data-ingest",
                              daemon=True)
    loader.start()
    try:
        while True:
            try:
                kind, item = q.get(timeout=600.0)
            except QueueStopped:
                return
            if kind == _ERR:
                raise item
            batch, copied = item
            if copied is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(copied)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(consumer)
            yield batch
    finally:
        # Consumer gone (exhaustion or early break): stop + unblock the
        # loader (the queue drops the batches it holds); it closes the
        # host generator on its way out.
        stop.set()
        q.shutdown()
        loader.join(timeout=30.0)

