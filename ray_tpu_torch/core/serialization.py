"""Object serialization with a zero-copy numpy and torch tensor path.

Equivalent of the reference's SerializationContext
(reference: python/ray/_private/serialization.py): encoding uses pickle
protocol 5 with out-of-band buffers, so large numpy arrays and tensors are
written into shared memory (or a socket) without an intermediate copy and
decoded as views directly over the mapped store memory.

Torch tensors (``ray_tpu``'s jax branch, rewritten):

- a CPU tensor travels as its bytes, out of band from 512 bytes on. Torch
  has no read-only tensors, so each decoded tensor owns what it may write:
  over the shm store it is a private copy-on-write mapping of the store's
  pages (no copy; an in-place op copies the pages it touches, and the
  sealed object never changes for its other readers); over a caller's
  writable buffer it is a view; over read-only bytes (an inline payload)
  it is a copy. Dtypes numpy lacks (bf16, the fp8 types) travel as
  unsigned integers of their width with the dtype's name beside them;
- a CUDA tensor is staged through the host and restored onto the getter's
  card (``cuda``, the current device); a getter without a card raises,
  it never hands back a CPU tensor.

Only exact ``torch.Tensor`` objects take this path; subclasses (such as
``nn.Parameter``) pickle as torch pickles them, their data tensor through
this path.

Flat wire layout (little-endian), used for shm store slots and sockets,
byte for byte ``ray_tpu``'s:
    u32 magic | u32 header_len | header bytes (cloudpickle, protocol 5)
    u64 nbufs | (u64 len, buf bytes)*          -- 8-byte aligned each
"""

from __future__ import annotations

import io
import pickle
import struct
import sys
import traceback
import warnings
from typing import Any, List, Tuple

import cloudpickle
import numpy as np

from ray_tpu_torch.exceptions import TaskError

_MAGIC = 0x52545055  # "RTPU"
_ALIGN = 8

# Buffers below this stay inline in the pickle stream; frame overhead wins.
_OOB_MIN_BYTES = 512

# Unsigned integer dtypes that carry a tensor whose dtype numpy lacks,
# by element size.
_BITS_DTYPES = {1: "uint8", 2: "uint16"}


def _is_tensor(value) -> bool:
    # No tensor can exist in a process that never imported torch.
    torch = sys.modules.get("torch")
    return torch is not None and type(value) is torch.Tensor


class NoCardError(RuntimeError):
    """A CUDA tensor reached a process without a card."""


def _restore_tensor(host: np.ndarray, dtype: str, requires_grad: bool,
                    on_cuda: bool):
    import torch

    if on_cuda and not torch.cuda.is_available():
        raise NoCardError(
            "received a CUDA tensor in a process without a card: ask for "
            "a GPU (num_gpus= or resources={'GPU': ...}) where it is got")
    if on_cuda:
        with warnings.catch_warnings():
            # Read once, by the copy to the card below, and never written.
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(host)
    else:
        t = torch.from_numpy(_writable(host))
    want = getattr(torch, dtype)
    if t.dtype != want:
        t = t.view(want)
    if on_cuda:
        t = t.to("cuda")
    if requires_grad:
        t.requires_grad_(True)
    return t


def _writable(host: np.ndarray) -> np.ndarray:
    """``host`` over memory a tensor may write without changing the object
    for anyone else (see the module's docstring)."""
    if host.nbytes == 0:
        return host
    store = sys.modules.get("ray_tpu_torch.core.shm_store")
    mine = store.private_pages(host) if store is not None else None
    if mine is not None:
        return mine
    return host if host.flags.writeable else host.copy()


def _tensor_reduce(t):
    """Reduces a tensor to its host bytes (a numpy array, possibly out of
    band) and what restores it."""
    import torch

    host = t.detach()
    if t.is_cuda:
        host = host.cpu()
    host = host.contiguous()
    try:
        arr = host.numpy()
    except TypeError:  # bf16, fp8: no numpy dtype, so travel as bits
        arr = host.view(getattr(torch, _BITS_DTYPES[host.element_size()])
                        ).numpy()
    return (_restore_tensor, (arr, str(t.dtype).removeprefix("torch."),
                              t.requires_grad, t.is_cuda))


class _NoCardUnpickler(pickle.Unpickler):
    """Restores every CUDA tensor as None: what ``decode_or_error`` reads a
    task's metadata with when its arguments cannot be restored here."""

    def find_class(self, module, name):
        if module == __name__ and name == "_restore_tensor":
            return _restore_or_none
        return super().find_class(module, name)


def _restore_or_none(*args):
    try:
        return _restore_tensor(*args)
    except NoCardError:
        return None


class _NeedsCloudpickle(Exception):
    """Raised inside the fast path to force the cloudpickle fallback."""


class _FastPickler(pickle.Pickler):
    """C-speed pickler for the common case (control frames, numpy, plain
    data). reducer_override keeps the tensor host-bytes path; everything
    else runs the C fast paths (~10-20x cheaper per frame than cloudpickle,
    whose Python-level reducer_override is invoked per object).

    __main__-defined classes/functions (driver scripts, REPLs) MUST go
    by-value: stock pickle would happily encode them by reference
    ("__main__.Foo"), which decodes to the WRONG (or missing) attribute in
    a worker whose __main__ is worker_main — so seeing one aborts to the
    cloudpickle path."""

    def reducer_override(self, obj):
        if _is_tensor(obj):
            return _tensor_reduce(obj)
        if isinstance(obj, type) or callable(obj):
            if getattr(obj, "__module__", None) == "__main__":
                raise _NeedsCloudpickle
        elif type(obj).__module__ == "__main__":
            raise _NeedsCloudpickle
        return NotImplemented


class Serializer:
    """Stateless encode/decode; one instance per worker."""

    def serialize(self, value: Any) -> Tuple[bytes, List[memoryview]]:
        """Returns (header_bytes, out_of_band_buffers)."""
        buffers: List[memoryview] = []

        def buffer_callback(pb: pickle.PickleBuffer) -> bool:
            view = pb.raw()
            if view.nbytes < _OOB_MIN_BYTES:
                return True  # keep small buffers inline
            buffers.append(view)
            return False  # emitted out-of-band

        sio = io.BytesIO()
        try:
            _FastPickler(sio, protocol=5,
                         buffer_callback=buffer_callback).dump(value)
            return sio.getvalue(), buffers
        except Exception:
            # Functions / local classes / anything stock pickle rejects:
            # retry with cloudpickle's by-value machinery.
            buffers.clear()

        class _Pickler(cloudpickle.CloudPickler):
            def reducer_override(self, obj):
                if _is_tensor(obj):
                    return _tensor_reduce(obj)
                # Delegate: CloudPickler's own reducer_override implements
                # by-value pickling of __main__/unimportable functions.
                return super().reducer_override(obj)

        sio = io.BytesIO()
        _Pickler(sio, protocol=5, buffer_callback=buffer_callback).dump(value)
        return sio.getvalue(), buffers

    def deserialize(self, header: bytes, buffers: List[memoryview]) -> Any:
        return pickle.loads(header, buffers=buffers)

    def decode_or_error(self, data) -> Tuple[Any, Any]:
        """``(decode(data), None)``; or, when a CUDA tensor inside cannot
        be restored in this process, the value with None in each such
        tensor's place and the ``NoCardError``: a worker then still reads
        the task's owner and return ids, and reports the error there
        instead of losing the task."""
        try:
            return self.decode(data), None
        except NoCardError as e:
            header, buffers = _split_flat(data)
            return _NoCardUnpickler(io.BytesIO(header),
                                    buffers=buffers).load(), e

    # --- flat wire form (for shm / sockets) ---

    def encode_total_size(self, header: bytes, buffers: List[memoryview]) -> int:
        total = 8 + _pad(len(header)) + 8
        for b in buffers:
            total += 8 + _pad(b.nbytes)
        return total

    def encode_into(self, dest: memoryview, header: bytes, buffers: List[memoryview]) -> int:
        """Writes the flat wire form into dest; returns bytes written."""
        off = 0
        struct.pack_into("<II", dest, off, _MAGIC, len(header))
        off += 8
        dest[off : off + len(header)] = header
        off += _pad(len(header))
        struct.pack_into("<Q", dest, off, len(buffers))
        off += 8
        for b in buffers:
            flat = b.cast("B") if b.ndim != 1 or b.format != "B" else b
            struct.pack_into("<Q", dest, off, flat.nbytes)
            off += 8
            stream_copy(dest[off : off + flat.nbytes], flat)
            off += _pad(flat.nbytes)
        return off

    def encode(self, value: Any) -> bytearray:
        """One-copy flat encode: the bytearray the flat form is written
        into IS the return value (the old ``bytes(out)`` re-copied every
        payload — one full extra pass on the put/transfer path)."""
        header, buffers = self.serialize(value)
        out = bytearray(self.encode_total_size(header, buffers))
        n = self.encode_into(memoryview(out), header, buffers)
        if n != len(out):  # encode_total_size is exact; guard only
            del out[n:]
        return out

    def decode(self, data) -> Any:
        """Zero-copy decode: numpy results view into ``data``."""
        return self.deserialize(*_split_flat(data))


def _split_flat(data) -> Tuple[bytes, List[memoryview]]:
    """The flat wire form's (header, out-of-band buffers)."""
    if isinstance(data, (bytes, bytearray)):
        data = memoryview(data)
    magic, hlen = struct.unpack_from("<II", data, 0)
    if magic != _MAGIC:
        raise ValueError("corrupt object header")
    off = 8
    header = bytes(data[off : off + hlen])
    off += _pad(hlen)
    (nbufs,) = struct.unpack_from("<Q", data, off)
    off += 8
    buffers: List[memoryview] = []
    for _ in range(nbufs):
        (blen,) = struct.unpack_from("<Q", data, off)
        off += 8
        buffers.append(data[off : off + blen])
        off += _pad(blen)
    return header, buffers


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


_STREAM_COPY_MIN = 1 << 20


def stream_copy(dest, src) -> None:
    """Copy ``src`` (bytes-like) into the equal-length writable buffer
    ``dest``. Blocks >= 1 MB go through np.copyto, which streams
    measurably faster than memoryview slice assignment (and this copy IS
    the put bandwidth for big objects); used by both the wire encoder and
    the shm store's put path so the threshold lives in one place."""
    n = len(src) if not isinstance(src, memoryview) else src.nbytes
    if n >= _STREAM_COPY_MIN:
        np.copyto(np.frombuffer(dest, np.uint8),
                  np.frombuffer(src, np.uint8))
    else:
        dest[:] = src


def capture_exception(exc: BaseException) -> TaskError:
    """Package a remote exception for transport to the get() site."""
    tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
    try:
        cloudpickle.dumps(exc)
        cause = exc
    except Exception:
        cause = None
    return TaskError(type(exc).__name__, tb, cause,
                     exc_type_mro=[c.__name__ for c in type(exc).__mro__])


SERIALIZER = Serializer()
