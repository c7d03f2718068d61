"""A copy of ``ray_tpu/data/formats.py``: the files written are byte-equal
to ``ray_tpu``'s.

Dependency-free codecs for interchange formats the reference reads via
heavyweight libraries (reference: python/ray/data/datasource/
tfrecords_datasource.py [tensorflow], webdataset_datasource.py [webdataset],
avro_datasource.py [fastavro]). Re-implemented small so the connectors work
in any environment:

- TFRecord framing (u64 len | masked-crc32c | payload | masked-crc32c) with
  a minimal tf.train.Example protobuf encoder/parser (bytes/float/int64
  feature lists — the entire surface the format uses in practice).
- WebDataset: tar shards where files sharing a basename prefix form one
  sample and extensions become columns.
- Avro object-container files: schema-driven binary decoding (null/deflate
  codecs, primitive + record/array/map/union/enum/fixed types).
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

# --------------------------------------------------------------- crc32c

_CRC32C_POLY = 0x82F63B78
_CRC32C_TABLE: List[int] = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ (_CRC32C_POLY if _c & 1 else 0)
    _CRC32C_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    """Castagnoli CRC (table-driven; plenty for record framing)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------- tfrecord

def write_tfrecord_file(path: str, records: List[bytes]) -> None:
    with open(path, "wb") as f:
        for rec in records:
            hdr = struct.pack("<Q", len(rec))
            f.write(hdr)
            f.write(struct.pack("<I", _masked_crc(hdr)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(rec)))


def read_tfrecord_file(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if not hdr:
                return
            if len(hdr) != 8:
                raise ValueError(f"{path}: truncated tfrecord length")
            (length,) = struct.unpack("<Q", hdr)
            (len_crc,) = struct.unpack("<I", f.read(4))
            if len_crc != _masked_crc(hdr):
                raise ValueError(f"{path}: tfrecord length crc mismatch")
            payload = f.read(length)
            if len(payload) != length:
                raise ValueError(f"{path}: truncated tfrecord payload")
            (data_crc,) = struct.unpack("<I", f.read(4))
            if data_crc != _masked_crc(payload):
                raise ValueError(f"{path}: tfrecord payload crc mismatch")
            yield payload


# ----------------------------------------------- minimal protobuf plumbing

def _write_varint(out: io.BytesIO, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    out = io.BytesIO()
    _write_varint(out, (field << 3) | wire)
    return out.getvalue()


def _len_delimited(field: int, payload: bytes) -> bytes:
    out = io.BytesIO()
    out.write(_tag(field, 2))
    _write_varint(out, len(payload))
    out.write(payload)
    return out.getvalue()


# tf.train.Example:
#   Example{ Features features=1 }  Features{ map<string,Feature> feature=1 }
#   Feature{ BytesList=1 | FloatList=2 | Int64List=3 }, lists use field 1.

def encode_example(features: Dict[str, Any]) -> bytes:
    """Dict of str -> (bytes | str | float | int | list/array thereof)
    -> serialized tf.train.Example."""
    feats = io.BytesIO()
    for name, value in sorted(features.items()):
        vals = value if isinstance(value, (list, tuple, np.ndarray)) else [value]
        body = io.BytesIO()
        first = vals[0] if len(vals) else b""
        if isinstance(first, (bytes, str)) or (
                isinstance(first, np.generic)
                and first.dtype.kind in ("S", "U")):
            for v in vals:
                if isinstance(v, str):
                    v = v.encode()
                elif isinstance(v, np.generic):
                    v = bytes(v)
                body.write(_len_delimited(1, v))
            feature = _len_delimited(1, body.getvalue())       # BytesList
        elif isinstance(first, (float, np.floating)):
            packed = struct.pack(f"<{len(vals)}f", *[float(v) for v in vals])
            feature = _len_delimited(2, _len_delimited(1, packed))
        elif isinstance(first, (int, np.integer, bool, np.bool_)):
            for v in vals:
                _write_varint(body, int(v) & 0xFFFFFFFFFFFFFFFF)
            feature = _len_delimited(3, _len_delimited(1, body.getvalue()))
        else:
            raise TypeError(f"unsupported feature type for {name!r}: "
                            f"{type(first)}")
        entry = _len_delimited(1, name.encode()) + _len_delimited(2, feature)
        feats.write(_len_delimited(1, entry))
    return _len_delimited(1, feats.getvalue())  # Example.features


def _parse_feature(data: bytes) -> List[Any]:
    pos = 0
    out: List[Any] = []
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire != 2:
            raise ValueError("malformed Feature")
        length, pos = _read_varint(data, pos)
        payload = data[pos:pos + length]
        pos += length
        # payload is BytesList/FloatList/Int64List; all use field 1.
        p = 0
        while p < len(payload):
            t, p = _read_varint(payload, p)
            f, w = t >> 3, t & 7
            if field == 1:                      # BytesList: bytes value=1
                ln, p = _read_varint(payload, p)
                out.append(payload[p:p + ln])
                p += ln
            elif field == 2:                    # FloatList
                if w == 2:                      # packed
                    ln, p = _read_varint(payload, p)
                    out.extend(struct.unpack(f"<{ln // 4}f",
                                             payload[p:p + ln]))
                    p += ln
                else:                           # unpacked fixed32
                    out.append(struct.unpack("<f", payload[p:p + 4])[0])
                    p += 4
            elif field == 3:                    # Int64List
                if w == 2:                      # packed varints
                    ln, p = _read_varint(payload, p)
                    end = p + ln
                    while p < end:
                        v, p = _read_varint(payload, p)
                        if v >= 1 << 63:
                            v -= 1 << 64
                        out.append(v)
                else:
                    v, p = _read_varint(payload, p)
                    if v >= 1 << 63:
                        v -= 1 << 64
                    out.append(v)
            else:
                raise ValueError(f"unknown Feature list field {field}")
    return out


def parse_example(record: bytes) -> Dict[str, List[Any]]:
    """Serialized tf.train.Example -> {feature name: list of values}."""
    out: Dict[str, List[Any]] = {}
    pos = 0
    while pos < len(record):
        tag, pos = _read_varint(record, pos)
        if tag >> 3 != 1 or tag & 7 != 2:
            raise ValueError("malformed Example")
        length, pos = _read_varint(record, pos)
        features = record[pos:pos + length]
        pos += length
        fpos = 0
        while fpos < len(features):
            ftag, fpos = _read_varint(features, fpos)
            if ftag >> 3 != 1 or ftag & 7 != 2:
                raise ValueError("malformed Features map")
            flen, fpos = _read_varint(features, fpos)
            entry = features[fpos:fpos + flen]
            fpos += flen
            # map entry: key=1 (string), value=2 (Feature)
            name, vals = None, []
            epos = 0
            while epos < len(entry):
                etag, epos = _read_varint(entry, epos)
                elen, epos = _read_varint(entry, epos)
                if etag >> 3 == 1:
                    name = entry[epos:epos + elen].decode()
                else:
                    vals = _parse_feature(entry[epos:epos + elen])
                epos += elen
            if name is not None:
                out[name] = vals
    return out


def examples_to_block(records: List[bytes]) -> Dict[str, np.ndarray]:
    """Parsed examples -> columnar block; scalar features become 1-D
    columns, multi-value features become object columns of lists."""
    rows = [parse_example(r) for r in records]
    names = sorted({k for r in rows for k in r})
    block: Dict[str, np.ndarray] = {}
    for name in names:
        cols = [r.get(name, []) for r in rows]
        if all(len(c) == 1 for c in cols):
            vals = [c[0] for c in cols]
            if isinstance(vals[0], bytes):
                block[name] = np.array(vals, dtype=object)
            else:
                block[name] = np.asarray(vals)
        else:
            arr = np.empty(len(cols), dtype=object)
            for i, c in enumerate(cols):
                arr[i] = c
            block[name] = arr
    return block


def block_to_examples(block: Dict[str, np.ndarray]) -> List[bytes]:
    from ray_tpu_torch.data.block import rows_view

    rows = rows_view(block)
    cols = list(rows.keys())
    n = len(next(iter(rows.values()))) if rows else 0
    out = []
    for i in range(n):
        out.append(encode_example({c: rows[c][i] for c in cols}))
    return out


# --------------------------------------------------------------- webdataset

def read_webdataset_shard(path: str) -> Dict[str, np.ndarray]:
    """One .tar shard -> columnar block. Files sharing the basename up to
    the FIRST dot form one sample; the remainder (extension) is the column
    name; values are raw bytes (decoding is the user's map stage, matching
    webdataset's convention)."""
    import tarfile

    samples: Dict[str, Dict[str, bytes]] = {}
    order: List[str] = []
    with tarfile.open(path) as tar:
        for member in tar:
            if not member.isfile():
                continue
            base = member.name.split("/")[-1]
            if "." in base:
                key, ext = base.split(".", 1)
            else:
                key, ext = base, "bin"
            if key not in samples:
                samples[key] = {}
                order.append(key)
            samples[key][ext] = tar.extractfile(member).read()
    cols = sorted({ext for s in samples.values() for ext in s})
    block: Dict[str, np.ndarray] = {
        "__key__": np.array(order, dtype=object)}
    for ext in cols:
        block[ext] = np.array([samples[k].get(ext) for k in order],
                              dtype=object)
    return block


def write_webdataset_shard(path: str, block: Dict[str, np.ndarray]) -> None:
    import tarfile

    keys = block.get("__key__")
    n = len(next(iter(block.values())))
    if keys is None:
        keys = np.array([f"{i:06d}" for i in range(n)], dtype=object)
    with tarfile.open(path, "w") as tar:
        for i in range(n):
            for ext in block:
                if ext == "__key__":
                    continue
                data = block[ext][i]
                if data is None:
                    continue
                if isinstance(data, str):
                    data = data.encode()
                elif not isinstance(data, (bytes, bytearray)):
                    data = json.dumps(
                        data.tolist() if hasattr(data, "tolist")
                        else data).encode()
                info = tarfile.TarInfo(f"{keys[i]}.{ext}")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(bytes(data)))


# --------------------------------------------------------------- avro

def _avro_long(data: bytes, pos: int) -> Tuple[int, int]:
    n, pos = _read_varint(data, pos)
    return (n >> 1) ^ -(n & 1), pos  # zigzag


class _AvroDecoder:
    def __init__(self, data: bytes, schema: Any,
                 named: Optional[Dict[str, Any]] = None):
        self.data = data
        self.pos = 0
        self.schema = schema
        self.named = named or {}

    def read(self, schema: Any) -> Any:
        if isinstance(schema, list):                      # union
            idx, self.pos = _avro_long(self.data, self.pos)
            return self.read(schema[idx])
        if isinstance(schema, dict):
            t = schema["type"]
            if t == "record":
                self.named[schema.get("name", "")] = schema
                return {f["name"]: self.read(f["type"])
                        for f in schema["fields"]}
            if t == "array":
                out = []
                while True:
                    count, self.pos = _avro_long(self.data, self.pos)
                    if count == 0:
                        return out
                    if count < 0:
                        _size, self.pos = _avro_long(self.data, self.pos)
                        count = -count
                    for _ in range(count):
                        out.append(self.read(schema["items"]))
            if t == "map":
                out = {}
                while True:
                    count, self.pos = _avro_long(self.data, self.pos)
                    if count == 0:
                        return out
                    if count < 0:
                        _size, self.pos = _avro_long(self.data, self.pos)
                        count = -count
                    for _ in range(count):
                        key = self.read("string")
                        out[key] = self.read(schema["values"])
            if t == "enum":
                idx, self.pos = _avro_long(self.data, self.pos)
                return schema["symbols"][idx]
            if t == "fixed":
                size = schema["size"]
                v = self.data[self.pos:self.pos + size]
                self.pos += size
                return v
            return self.read(t)                           # wrapped primitive
        if schema in self.named:
            return self.read(self.named[schema])
        if schema == "null":
            return None
        if schema == "boolean":
            v = self.data[self.pos] != 0
            self.pos += 1
            return v
        if schema in ("int", "long"):
            v, self.pos = _avro_long(self.data, self.pos)
            return v
        if schema == "float":
            v = struct.unpack("<f", self.data[self.pos:self.pos + 4])[0]
            self.pos += 4
            return v
        if schema == "double":
            v = struct.unpack("<d", self.data[self.pos:self.pos + 8])[0]
            self.pos += 8
            return v
        if schema in ("bytes", "string"):
            n, self.pos = _avro_long(self.data, self.pos)
            v = self.data[self.pos:self.pos + n]
            self.pos += n
            return v.decode() if schema == "string" else v
        raise ValueError(f"unsupported avro type: {schema!r}")


def read_avro_file(path: str) -> List[Dict[str, Any]]:
    """Avro object-container file -> list of row dicts (codecs: null,
    deflate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"Obj\x01":
        raise ValueError(f"{path}: not an avro object container file")
    dec = _AvroDecoder(data, None)
    dec.pos = 4
    meta: Dict[str, bytes] = {}
    while True:
        count, dec.pos = _avro_long(data, dec.pos)
        if count == 0:
            break
        if count < 0:
            _sz, dec.pos = _avro_long(data, dec.pos)
            count = -count
        for _ in range(count):
            k = dec.read("string")
            meta[k] = dec.read("bytes")
    sync = data[dec.pos:dec.pos + 16]
    dec.pos += 16
    schema = json.loads(meta["avro.schema"].decode())
    codec = meta.get("avro.codec", b"null")
    rows: List[Dict[str, Any]] = []
    named: Dict[str, Any] = {}
    while dec.pos < len(data):
        count, dec.pos = _avro_long(data, dec.pos)
        size, dec.pos = _avro_long(data, dec.pos)
        blob = data[dec.pos:dec.pos + size]
        dec.pos += size
        if data[dec.pos:dec.pos + 16] != sync:
            raise ValueError(f"{path}: avro sync marker mismatch")
        dec.pos += 16
        if codec == b"deflate":
            blob = zlib.decompress(blob, -15)
        elif codec != b"null":
            raise ValueError(f"{path}: unsupported avro codec {codec!r}")
        bdec = _AvroDecoder(blob, schema, named)
        for _ in range(count):
            rows.append(bdec.read(schema))
    return rows
