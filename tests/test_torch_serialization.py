"""The port's wire format (``ray_tpu_torch/core/serialization.py``) against
``ray_tpu``'s (``ray_tpu/core/serialization.py``) on the CPU.

Bytes one package's ``SERIALIZER`` writes decode with the other's for
numpy values; torch tensors travel out of band from 512 bytes and decode
as views over the encoded buffer; bf16 (and the other dtypes numpy lacks)
make a bit-equal round trip; a CUDA tensor's bytes refuse to decode in a
process without a card.
"""

import ctypes
import os
import warnings

import numpy as np
import pytest
import torch

from ray_tpu.core.serialization import SERIALIZER as JSER
from ray_tpu_torch.core import serialization as tser
from ray_tpu_torch.core.serialization import SERIALIZER as TSER

_rng = np.random.RandomState(0)
NUMPY_VALUES = [
    {"a": 1, "b": [1.5, "x", None], "c": (b"raw", True)},
    np.arange(10, dtype=np.int32),  # inline: under 512 bytes
    _rng.standard_normal((64, 33)).astype(np.float32),  # out of band
    {"w": _rng.standard_normal(1000), "i": np.arange(300, dtype=np.int64),
     "u8": np.frombuffer(bytes(range(256)) * 3, np.uint8),
     "h": _rng.standard_normal(700).astype(np.float16)},
    [np.zeros((0, 4)), np.ones((2, 3), dtype=bool), np.float64(3.25)],
]


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(a, np.generic):
        return (type(a) is type(b) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return a == b


@pytest.mark.parametrize("i", range(len(NUMPY_VALUES)))
@pytest.mark.parametrize("writer,reader", [(JSER, TSER), (TSER, JSER)],
                         ids=["ray_tpu_to_port", "port_to_ray_tpu"])
def test_numpy_values_cross_packages(writer, reader, i):
    value = NUMPY_VALUES[i]
    wire = writer.encode(value)
    assert _same(reader.decode(bytes(wire)), value)


@pytest.mark.parametrize("i", range(len(NUMPY_VALUES)))
def test_numpy_wire_bytes_equal_ray_tpus(i):
    """The same numpy value encodes to the same bytes in both packages."""
    assert bytes(TSER.encode(NUMPY_VALUES[i])) == bytes(
        JSER.encode(NUMPY_VALUES[i]))


def _inside(t, buf):
    base = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    return base <= t.data_ptr() < base + len(buf)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64, torch.float16])
def test_large_cpu_tensor_travels_out_of_band_and_decodes_as_a_view(dtype):
    t = (torch.arange(1024) * 3 - 7).to(dtype)  # >= 2048 bytes
    _, buffers = TSER.serialize(t)
    assert len(buffers) == 1 and buffers[0].nbytes == t.numel() * t.element_size()
    wire = TSER.encode(t)
    out = TSER.decode(wire)
    assert out.dtype == dtype and out.shape == t.shape
    assert torch.equal(out, t)
    assert _inside(out, wire)  # no copy: a view over the encoded bytes


@pytest.fixture
def store():
    from ray_tpu_torch.core.shm_store import ShmStore, build_lib

    build_lib()
    s = ShmStore.create(f"/rtt_store_sertest_{os.getpid()}", 16 << 20,
                        prefault=False)
    try:
        yield s
    finally:
        s.close()


def test_a_tensor_over_the_store_shares_its_pages_and_writes_privately(
        store):
    """Decoded over the shm store, a tensor reads the store's pages through
    a private mapping: equal values with no copy made, and an in-place op
    lands in this reader's pages alone."""
    from ray_tpu_torch.core.ids import ObjectID

    t = (torch.arange(4096) * 3 - 7).to(torch.bfloat16)
    wire = TSER.encode({"t": t})
    oid = ObjectID(bytes(range(28)))
    store.create_buffer(oid, len(wire))[:] = wire
    store.seal(oid)
    first = TSER.decode(memoryview(store.get(oid)))["t"]
    second = TSER.decode(memoryview(store.get(oid)))["t"]
    assert torch.equal(first, t) and torch.equal(second, t)
    assert first.data_ptr() != second.data_ptr()  # a mapping each
    first.add_(1)
    assert torch.equal(second, t)
    assert torch.equal(TSER.decode(memoryview(store.get(oid)))["t"], t)
    assert torch.equal(first, t + 1)


def test_a_tensor_over_read_only_bytes_is_a_copy():
    """Bytes cannot be written, and a tensor can: the tensor gets its own
    memory, without torch's warning of a non-writable array."""
    t = torch.arange(1024, dtype=torch.float32)
    wire = bytes(TSER.encode(t))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = TSER.decode(wire)
    out.add_(1)
    assert torch.equal(TSER.decode(wire), t)


def test_small_cpu_tensor_stays_in_band():
    t = torch.arange(16, dtype=torch.float32)  # 64 bytes
    _, buffers = TSER.serialize(t)
    assert buffers == []
    assert torch.equal(TSER.decode(TSER.encode(t)), t)


@pytest.mark.parametrize("shape", [(), (3,), (17, 31), (4, 0, 2)])
def test_bf16_round_trip_is_bit_equal(shape):
    n = int(np.prod(shape)) if shape else 1
    bits = np.random.RandomState(1).randint(0, 1 << 16, n).astype(np.uint16)
    # Every class of bits: NaN payloads, infinities, -0, subnormals.
    bits[:min(n, 4)] = np.array([0x7FC1, 0xFF80, 0x8000, 0x0001],
                                np.uint16)[:min(n, 4)]
    t = torch.from_numpy(bits.reshape(shape)).view(torch.bfloat16)
    out = TSER.decode(TSER.encode({"t": t}))["t"]
    assert out.dtype == torch.bfloat16 and out.shape == t.shape
    assert torch.equal(out.view(torch.int16), t.view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2,
                                   torch.bool, torch.int8, torch.complex64])
def test_other_dtypes_round_trip(dtype):
    src = torch.arange(-300, 300, dtype=torch.float32) / 7
    t = (src > 0) if dtype is torch.bool else src.to(dtype)
    out = TSER.decode(TSER.encode(t))
    assert out.dtype == dtype
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        assert torch.equal(out.view(torch.uint8), t.view(torch.uint8))
    else:
        assert torch.equal(out, t)


def test_non_contiguous_and_requires_grad():
    base = torch.randn(8, 70, generator=torch.Generator().manual_seed(0))
    t = base.t()[::2]  # strided view
    out = TSER.decode(TSER.encode(t))
    assert out.is_contiguous() and torch.equal(out, t)
    leaf = torch.randn(200, requires_grad=True)
    got = TSER.decode(TSER.encode(leaf))
    assert got.requires_grad and torch.equal(got.detach(), leaf.detach())


def test_parameter_pickles_through_torch_with_its_data_on_our_path():
    p = torch.nn.Parameter(torch.randn(300))
    out = TSER.decode(TSER.encode(p))
    assert isinstance(out, torch.nn.Parameter) and torch.equal(out, p)


def test_cuda_tensor_bytes_refuse_a_process_without_a_card():
    """What a CUDA tensor reduces to restores onto the card; without one it
    raises, it never hands back a CPU tensor."""
    if torch.cuda.is_available():
        pytest.skip("this process has a card: the refusal needs none")
    host = np.arange(200, dtype=np.float32)
    with pytest.raises(RuntimeError, match="without a card"):
        tser._restore_tensor(host, "float32", False, True)
    # The same bytes as a CPU tensor decode fine.
    assert torch.equal(tser._restore_tensor(host, "float32", False, False),
                       torch.from_numpy(host))


def test_decode_or_error_reads_a_value_around_an_unrestorable_tensor():
    """What a worker without a card reads a task spec with: the metadata
    and None in the CUDA tensor's place, beside the error."""
    if torch.cuda.is_available():
        pytest.skip("this process has a card: the refusal needs none")

    class CudaBytes:
        def __reduce__(self):
            return (tser._restore_tensor,
                    (np.arange(300, dtype=np.float32), "float32", False, True))

    wire = TSER.encode({"owner": "127.0.0.1:1", "args": (CudaBytes(), 7)})
    with pytest.raises(tser.NoCardError):
        TSER.decode(wire)
    value, err = TSER.decode_or_error(wire)
    assert value == {"owner": "127.0.0.1:1", "args": (None, 7)}
    assert isinstance(err, tser.NoCardError)
    assert TSER.decode_or_error(TSER.encode([1, 2])) == ([1, 2], None)

