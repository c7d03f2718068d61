"""The port's interchange-format codecs and connectors against
``ray_tpu``'s on the CPU: the counterparts of
``tests/test_data_formats.py``.

The codecs' bytes are ``ray_tpu``'s: CRC32C, tf.train.Example records,
and the files each writer of both packages makes from the same dataset
(tfrecords, webdataset tar shards, json, csv, npy, parquet), compared
file by file. Avro is read only (``ray_tpu`` writes none): the decoded
rows of a hand-written container are ``ray_tpu``'s. ``ray_tpu`` runs on
its in-process runtime, the port on its cluster.
"""

import io
import json
import struct
import zlib

import numpy as np
import pytest

import ray_tpu.data as jdata
import ray_tpu_torch.data as tdata
from ray_tpu.data import formats as jformats
from ray_tpu_torch.data import formats
from tests.torch_data_common import assert_same_rows, both, files_of


@pytest.fixture(scope="module")
def cluster():
    with both(num_cpus=2) as rt:
        yield rt


def test_crc32c_known_vectors():
    # RFC 3720 test vectors.
    assert formats.crc32c(b"") == 0x0
    assert formats.crc32c(b"123456789") == 0xE3069283
    assert formats.crc32c(bytes(32)) == 0x8A9136AA
    blob = np.random.default_rng(0).bytes(4096)
    assert formats.crc32c(blob) == jformats.crc32c(blob)


def test_example_proto_roundtrip():
    feats = {
        "label": 3,
        "weights": [1.5, -2.25],
        "name": b"sample-1",
        "tags": [b"a", b"b", b"c"],
    }
    raw = formats.encode_example(feats)
    assert raw == jformats.encode_example(feats)
    parsed = formats.parse_example(raw)
    assert parsed == jformats.parse_example(raw)
    assert parsed["label"] == [3]
    np.testing.assert_allclose(parsed["weights"], [1.5, -2.25])
    assert parsed["name"] == [b"sample-1"]
    assert parsed["tags"] == [b"a", b"b", b"c"]


def _columns():
    return {"x": np.arange(10, dtype=np.int64),
            "y": np.linspace(0, 1, 10).astype(np.float32)}


@pytest.mark.parametrize("sink", ["tfrecords", "json", "csv", "numpy",
                                  "parquet"])
def test_written_files_equal_ray_tpus(cluster, tmp_path, sink):
    """Each writer of both packages on the same dataset: the same part
    files, byte for byte."""
    written = {}
    for name, d in (("port", tdata), ("ray_tpu", jdata)):
        ds = d.from_numpy(_columns(), parallelism=2)
        out = str(tmp_path / name)
        if sink == "numpy":
            written[name] = files_of(ds.write_numpy(out, column="y"))
        else:
            written[name] = files_of(getattr(ds, f"write_{sink}")(out))
    assert len(written["port"]) == 2
    assert written["port"] == written["ray_tpu"]


def test_tfrecords_roundtrip_through_dataset(cluster, tmp_path):
    out = tdata.from_numpy(_columns(), parallelism=2).write_tfrecords(
        str(tmp_path / "tfr"))
    assert out and all(p.endswith(".tfrecords") for p in out)
    back = tdata.read_tfrecords(str(tmp_path / "tfr")).materialize()
    rows = back.take_all()
    assert_same_rows(rows, jdata.read_tfrecords(
        str(tmp_path / "tfr")).take_all())
    rows = sorted(rows, key=lambda r: r["x"])
    assert [r["x"] for r in rows] == list(range(10))
    np.testing.assert_allclose([r["y"] for r in rows],
                               np.linspace(0, 1, 10), rtol=1e-6)


def test_tfrecords_crc_detects_corruption(tmp_path):
    path = str(tmp_path / "x.tfrecords")
    formats.write_tfrecord_file(path, [b"hello world"])
    raw = bytearray(open(path, "rb").read())
    raw[14] ^= 0xFF  # flip a payload byte
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="crc"):
        list(formats.read_tfrecord_file(path))


def test_webdataset_roundtrip(cluster, tmp_path):
    items = [{"__key__": f"s{i}", "txt": f"caption {i}".encode(),
              "cls": str(i).encode()} for i in range(6)]
    out = tdata.from_items(items, parallelism=2).write_webdataset(
        str(tmp_path / "wds"))
    jout = jdata.from_items(items, parallelism=2).write_webdataset(
        str(tmp_path / "jwds"))
    assert out and all(p.endswith(".tar") for p in out)
    assert files_of(out) == files_of(jout)
    back = tdata.read_webdataset(str(tmp_path / "wds")).materialize()
    rows = back.take_all()
    assert_same_rows(rows, jdata.read_webdataset(
        str(tmp_path / "wds")).take_all())
    rows = sorted(rows, key=lambda r: r["__key__"])
    assert [r["__key__"] for r in rows] == [f"s{i}" for i in range(6)]
    assert rows[2]["txt"] == b"caption 2"
    assert rows[2]["cls"] == b"2"


def _write_avro(path, schema: dict, rows, codec=b"null"):
    """Hand-rolled avro writer (``tests/test_data_formats.py``'s)."""
    def zig(n):
        return _varint((n << 1) ^ (n >> 63))

    def _varint(n):
        out = b""
        n &= (1 << 64) - 1
        while True:
            b = n & 0x7F
            n >>= 7
            if n:
                out += bytes([b | 0x80])
            else:
                return out + bytes([b])

    def enc(schema, v):
        if isinstance(schema, dict) and schema["type"] == "record":
            return b"".join(enc(f["type"], v[f["name"]])
                            for f in schema["fields"])
        if isinstance(schema, list):  # union: pick the matching branch
            idx = 0 if v is None else 1
            return zig(idx) + (b"" if v is None else enc(schema[idx], v))
        if schema in ("int", "long"):
            return zig(v)
        if schema == "double":
            return struct.pack("<d", v)
        if schema == "string":
            b = v.encode()
            return zig(len(b)) + b
        raise AssertionError(schema)

    body = b"".join(enc(schema, r) for r in rows)
    if codec == b"deflate":
        cobj = zlib.compressobj(wbits=-15)
        body = cobj.compress(body) + cobj.flush()
    sync = bytes(range(16))
    meta = {"avro.schema": json.dumps(schema).encode(), "avro.codec": codec}
    out = io.BytesIO()
    out.write(b"Obj\x01")
    out.write(zig(len(meta)))
    for k, v in meta.items():
        kb = k.encode()
        out.write(zig(len(kb)) + kb + zig(len(v)) + v)
    out.write(zig(0))
    out.write(sync)
    out.write(zig(len(rows)) + zig(len(body)) + body + sync)
    with open(path, "wb") as f:
        f.write(out.getvalue())


AVRO_SCHEMA = {
    "type": "record", "name": "Rec",
    "fields": [
        {"name": "id", "type": "long"},
        {"name": "score", "type": "double"},
        {"name": "tag", "type": "string"},
        {"name": "opt", "type": ["null", "long"]},
    ],
}


@pytest.mark.parametrize("codec", [b"null", b"deflate"])
def test_avro_decoding(tmp_path, codec, cluster):
    rows = [{"id": i, "score": i * 0.5, "tag": f"t{i}",
             "opt": None if i % 2 else i * 10}
            for i in range(7)]
    path = str(tmp_path / "data.avro")
    _write_avro(path, AVRO_SCHEMA, rows, codec=codec)
    decoded = formats.read_avro_file(path)
    assert decoded == rows == jformats.read_avro_file(path)
    got = tdata.read_avro(path).materialize().take_all()
    assert_same_rows(got, jdata.read_avro(path).take_all())
    got = sorted(got, key=lambda r: r["id"])
    assert [r["tag"] for r in got] == [f"t{i}" for i in range(7)]


def test_from_torch(cluster):
    import torch

    class DS(torch.utils.data.Dataset):
        def __len__(self):
            return 5

        def __getitem__(self, i):
            return {"x": i, "y": i * i}

    rows = tdata.from_torch(DS()).materialize().take_all()
    assert_same_rows(rows, jdata.from_torch(DS()).take_all())
    assert [r["y"] for r in sorted(rows, key=lambda r: r["x"])] == [
        0, 1, 4, 9, 16]


def test_from_huggingface_via_pandas_protocol(cluster):
    import pandas as pd

    class FakeHF:  # anything exposing to_pandas (datasets.Dataset does)
        def to_pandas(self):
            return pd.DataFrame({"a": [1, 2, 3]})

    rows = tdata.from_huggingface(FakeHF()).materialize().take_all()
    assert_same_rows(rows, jdata.from_huggingface(FakeHF()).take_all())
    assert sorted(r["a"] for r in rows) == [1, 2, 3]
    with pytest.raises(TypeError, match="DatasetDict"):
        tdata.from_huggingface({"train": [1]})
