"""Fleet KV page tier: chain-hashed prefix pages as stored objects
(``ray_tpu/serve/engine/kv_fleet.py``, the port's own copy).

The engine's prefix cache (kv_manager.py) dies with its slot: an evicted
block's KV is recomputed even when an identical prefix was materialized
moments ago. This tier keeps one object per COMPLETE prefix block, keyed
by a deterministic id derived from (model fingerprint, chain hash). The
chain-hash property — ``h_i = H(h_{i-1}, block_i)`` — means one hash
identifies the whole prefix through block ``i``, so a puller walks its
own prompt's chain depth by depth and stops at the first miss: the
longest resident prefix wins without a directory scan.

A payload is the engine's export shape (``k_page``/``v_page`` of
``[L, KH, P, D]``, a CRC over the page bytes and the chain prefix), and
installs go through the same ``install_page`` + chain-verify seam as the
disaggregated handoff, so wrong KV cannot decode silently whichever tier
it came from.

Pages are host tensors in the cache's dtype. A frame stores them as
numpy, which has no bfloat16: bf16 pages travel as their uint16 bits and
the frame records the dtype, so ``unpack_page`` gives back the cache's
dtype bit for bit. The CRC covers those bytes.

Two stores: ``LocalKVPageStore`` (one process) and ``ClusterKVPageStore``
(the cluster runtime's shm object store and the head's object directory,
so replicas in different worker processes share pages); ``resolve_store``
picks the cluster one when a cluster runtime is attached.

Differences from ``ray_tpu``: ``page_object_id`` returns the 28 bytes of
``ray_tpu.core.ids.ObjectID``'s binary, and the stores key on them (the
cluster store wraps them in the port's own ``ObjectID``);
``GLOBAL_CONFIG``'s defaults are the module constants below.
"""

from __future__ import annotations

import hashlib
import io
import struct
import threading
import zlib
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np
import torch

# ray_tpu/core/config.py's defaults.
#: Minimum contiguous pullable prefix in blocks (-1 = tier off).
MIN_PREFIX_BLOCKS = -1
#: Byte cap of the process-local page store.
LOCAL_BYTES = 256 << 20
#: Recently spilled/pulled chain hashes a load snapshot carries.
SNAPSHOT_FLEET_HASHES = 32
#: Resident prefix chain hashes a load snapshot carries.
SNAPSHOT_PREFIX_HASHES = 256

# ray_tpu.core.ids._FLAG_PUT: a page id presents as an ordinary put-object.
_PUT_FLAGS = struct.pack("<I", 0x1)

_MAGIC = b"RTKV1\n"


def fleet_namespace(cfg, block_size: int, quantize: Optional[str],
                    seed: int) -> bytes:
    """20-byte namespace digest over everything that changes KV BYTES for
    the same token ids. Engines whose namespaces differ can never resolve
    each other's pages."""
    ident = (
        "rtpu-kv-fleet", int(cfg.vocab_size), int(cfg.d_model),
        int(cfg.n_layers), int(cfg.n_heads), int(cfg.n_kv_heads),
        int(cfg.max_seq_len), str(getattr(cfg, "dtype", "")),
        str(quantize), int(seed), int(block_size),
    )
    return hashlib.blake2b(repr(ident).encode(), digest_size=20).digest()


def page_object_id(namespace: bytes, chain_hash: int) -> bytes:
    """Deterministic 28-byte object id for the prefix ending at
    ``chain_hash``, laid out as ``ObjectID`` (index 4B + task 20B + flags
    4B): 24 content bytes from hashing (namespace, chain hash), then the
    put flag. Every holder of the same prefix derives the same id."""
    h = hashlib.blake2b(
        namespace + struct.pack("<Q", chain_hash & (2 ** 64 - 1)),
        digest_size=24).digest()
    return h + _PUT_FLAGS


def _host_array(page: torch.Tensor) -> np.ndarray:
    """A host page as numpy: bf16, which numpy lacks, as its uint16
    bits."""
    page = page.detach().cpu().contiguous()
    if page.dtype == torch.bfloat16:
        return page.view(torch.int16).numpy().view(np.uint16)
    return page.numpy()


def _from_array(arr: np.ndarray, name: str) -> torch.Tensor:
    """The inverse of ``_host_array`` for a page whose frame names
    ``name``."""
    if name == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != name:
        raise ValueError(f"frame says {name}, page is {arr.dtype}")
    return torch.from_numpy(arr)


def page_bytes(page: torch.Tensor) -> bytes:
    """The page's raw bytes, what its CRC covers."""
    return _host_array(page).tobytes()


def page_crc(k_page: torch.Tensor, v_page: torch.Tensor) -> int:
    """The content check of a handoff's and a frame's pages, over their
    bytes (chain hashes cover only token identity)."""
    return zlib.crc32(page_bytes(k_page)) ^ zlib.crc32(page_bytes(v_page))


def pack_page(block_tokens, chain, k_page: torch.Tensor,
              v_page: torch.Tensor, crc: int) -> bytes:
    """Serialize one block's payload. np.save framing (not pickle): shape
    and dtype ride in the header, the page bytes stream raw, and unpack
    never runs code from the bytes. The dtype name follows the chain, so
    bf16 pages (stored as uint16 bits) come back as bf16."""
    buf = io.BytesIO()
    buf.write(_MAGIC)
    toks = np.asarray(block_tokens, np.int64)
    ch = np.asarray(chain, np.int64)
    name = str(k_page.dtype).removeprefix("torch.").encode()
    buf.write(struct.pack("<qIII", crc & 0xFFFFFFFF, len(toks), len(ch),
                          len(name)))
    buf.write(toks.tobytes())
    buf.write(ch.tobytes())
    buf.write(name)
    np.save(buf, _host_array(k_page), allow_pickle=False)
    np.save(buf, _host_array(v_page), allow_pickle=False)
    return buf.getvalue()


def unpack_page(raw: bytes) -> Optional[Dict[str, Any]]:
    """Decode + integrity-check one payload. Returns None on ANY
    corruption (bad magic, short read, unknown dtype, CRC mismatch): the
    caller treats it exactly like a store miss and recomputes."""
    try:
        buf = io.BytesIO(raw)
        if buf.read(len(_MAGIC)) != _MAGIC:
            return None
        crc, nt, nc, nn = struct.unpack("<qIII", buf.read(20))
        tokens = np.frombuffer(buf.read(8 * nt), np.int64)
        chain = np.frombuffer(buf.read(8 * nc), np.int64)
        name = buf.read(nn).decode()
        k_arr = np.load(buf, allow_pickle=False)
        v_arr = np.load(buf, allow_pickle=False)
        if len(tokens) != nt or len(chain) != nc:
            return None
        got = zlib.crc32(k_arr.tobytes()) ^ zlib.crc32(v_arr.tobytes())
        if (got & 0xFFFFFFFF) != (crc & 0xFFFFFFFF):
            return None
        k_page, v_page = _from_array(k_arr, name), _from_array(v_arr, name)
    except (ValueError, EOFError, OSError, struct.error,
            UnicodeDecodeError):
        # A truncated or garbled frame reads as a store miss by design.
        return None
    return {"tokens": [int(t) for t in tokens],
            "chain": [int(h) for h in chain],
            "k_page": k_page, "v_page": v_page, "crc": int(crc)}


class LocalKVPageStore:
    """In-process page tier: dict + LRU byte cap. Engines in one process
    may share one instance (the node-local tier without a cluster)."""

    def __init__(self, capacity_bytes: Optional[int] = None):
        self.capacity_bytes = int(LOCAL_BYTES if capacity_bytes is None
                                  else capacity_bytes)
        self._lock = threading.Lock()
        self._objs: "OrderedDict[bytes, bytes]" = OrderedDict()
        self._bytes = 0
        self.evictions = 0

    def put(self, oid: bytes, payload: bytes) -> bool:
        with self._lock:
            if oid in self._objs:
                return False
            self._objs[oid] = payload
            self._bytes += len(payload)
            while self._bytes > self.capacity_bytes and len(self._objs) > 1:
                _k, old = self._objs.popitem(last=False)
                self._bytes -= len(old)
                self.evictions += 1
            return True

    def get(self, oid: bytes) -> Optional[bytes]:
        with self._lock:
            raw = self._objs.get(oid)
            if raw is not None:
                self._objs.move_to_end(oid)  # a hit is a hotness signal
            return raw

    def contains(self, oid: bytes) -> bool:
        with self._lock:
            return oid in self._objs

    def delete(self, oid: bytes) -> bool:
        with self._lock:
            raw = self._objs.pop(oid, None)
            if raw is not None:
                self._bytes -= len(raw)
            return raw is not None

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"objects": len(self._objs), "bytes": self._bytes,
                    "evictions": self.evictions}


_local_singleton: Optional[LocalKVPageStore] = None
_local_lock = threading.Lock()


def local_store() -> LocalKVPageStore:
    """Process-wide LocalKVPageStore: engines in one process share the
    tier without a cluster runtime."""
    global _local_singleton
    with _local_lock:
        if _local_singleton is None:
            _local_singleton = LocalKVPageStore()
        return _local_singleton


class ClusterKVPageStore:
    """Page tier over the cluster runtime's object plane. Puts land in the
    node's shm arena and register in the head's object directory through
    the same batched object-notify path as task outputs; gets try the
    local arena (memcpy), then one directory-guided ``pull_object``
    through the node manager. Eviction needs no new code: the arena's LRU
    spills cold pages to disk and ``get`` restores them."""

    def __init__(self, core, pull_timeout_ms: int = 2000):
        self._core = core          # ClusterCore (driver or worker runtime)
        self._pull_timeout_ms = int(pull_timeout_ms)

    @staticmethod
    def _oid(oid: bytes):
        from ray_tpu_torch.core.ids import ObjectID

        return ObjectID(oid)

    def put(self, oid: bytes, payload: bytes) -> bool:
        store = self._core.store
        key = self._oid(oid)
        try:
            if store.contains(key):
                return False
            store.put_bytes(key, payload)
        except Exception:
            # Duplicate create (a sibling replica on this node raced the
            # same chain hash) or arena pressure: the page tier is a
            # cache — a failed put is a skipped optimization, never an
            # error the engine should see.
            return False
        self._core._queue_object_notify("add", oid, len(payload))
        return True

    def get(self, oid: bytes, remote: bool = True) -> Optional[bytes]:
        store = self._core.store
        key = self._oid(oid)
        raw = store.get_bytes(key)
        if raw is not None or not remote:
            return raw
        try:
            holders = self._core.head.call(
                "object_locations", oid,
                getattr(self._core, "node_id", None), timeout=2)
        except Exception:  # directory unreachable == tier miss
            return None
        if not holders:
            return None
        try:
            ok = bool(self._core.node.call(
                "pull_object", oid, self._pull_timeout_ms, None,
                timeout=self._pull_timeout_ms / 1e3 + 2))
        except Exception:  # failed peer pull == tier miss
            return None
        return store.get_bytes(key) if ok else None

    def contains(self, oid: bytes) -> bool:
        return self._core.store.contains(self._oid(oid))

    def delete(self, oid: bytes) -> bool:
        if self._core.store.delete(self._oid(oid)):
            self._core._queue_object_notify("rm", oid)
            return True
        return False

    def stats(self) -> Dict[str, int]:
        used, _cap, n, ev = self._core.store.stats()
        return {"objects": n, "bytes": used, "evictions": ev}


def resolve_store(explicit=None):
    """Pick the page tier for an engine: an explicit store instance
    (tests), else the cluster shm store when a cluster runtime is
    attached, else the process-local one."""
    if explicit is not None:
        return explicit
    from ray_tpu_torch.core.runtime_context import get_runtime

    rt = get_runtime()
    if (rt is not None and getattr(rt, "store", None) is not None
            and getattr(rt, "node", None) is not None):
        return ClusterKVPageStore(rt)
    return local_store()
