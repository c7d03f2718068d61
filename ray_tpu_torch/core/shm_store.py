"""Python client for the native shared-memory object store
(``ray_tpu_torch/csrc/shm_store.cc``).

This is the per-node object plane. Parity target: the reference's plasma
client (reference: src/ray/object_manager/plasma/client.h — Create/Seal/Get/
Release/Delete over a unix-socket protocol), re-designed: here every process
maps the same POSIX shm segment and calls straight into the store library —
no store server, no socket round trip, zero-copy reads via memoryview into
the mapping. The segment is SHARDED (layout v2): per-shard process-shared
robust mutexes, slot stripes, and sub-arena free lists, with process-affine
allocation so concurrent writers neither serialize on one lock nor ping-pong
pages between each other's page tables (see shm_store.cc).

The creator process calls `ShmStore.create(...)`; workers `ShmStore.open(...)`
with the same name. Both sides then use identical put/get APIs.

The library is built from the package's own source with ``g++`` at first
use, as ``ops/_build.py`` builds the CUDA kernels: the file name carries a
hash of the source and the flags, and the library is written under a
temporary name and moved into place with ``os.replace``, so a process never
``dlopen``s a half-written file. ``build_lib()`` runs in the driver before it
spawns any process; the head, nodes and workers then find the file built.
No binary is checked in.

A copy of ``ray_tpu/core/shm_store.py`` with that build in place of the
checked-in library and its ``RTPU_SHM_STORE_SO`` override.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import subprocess
import threading
import time
import weakref
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.devtools.lock_debug import make_lock

_LIB = None
_LIB_LOCK = make_lock("shm_store._LIB_LOCK")

#: Expected shm segment layout version. MUST match kLayoutVersion in
#: shm_store.cc: the v2 layout shards the arena (per-shard mutexes, slot
#: stripes, sub-arena free lists), so a library built from older source
#: would corrupt a v2 segment — attach fails fast instead.
_LAYOUT_VERSION = 2

_PKG_DIR = Path(__file__).resolve().parent.parent
_SOURCE = _PKG_DIR / "csrc" / "shm_store.cc"
_BUILD_DIR = _PKG_DIR / "_build"
_GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_GXX_LIBS = ("-lpthread", "-lrt")


def library_path() -> Path:
    """``_build/libshm_store-<hash>.so``: the hash covers the source and
    the flags, so an edited source is rebuilt and a stale build never
    loads."""
    h = hashlib.sha256(" ".join(_GXX_FLAGS + _GXX_LIBS).encode())
    h.update(_SOURCE.read_bytes())
    return _BUILD_DIR / f"libshm_store-{h.hexdigest()[:16]}.so"


def build_lib() -> Path:
    """Compile ``csrc/shm_store.cc`` with ``g++`` unless its library
    exists. Raises RuntimeError with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp")
    proc = subprocess.run(["g++", *_GXX_FLAGS, "-o", str(tmp),
                           str(_SOURCE), *_GXX_LIBS],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for csrc/shm_store.cc (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def _load_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        so = str(build_lib())
        lib = ctypes.CDLL(so)
        lib.rtpu_lib_layout_version.restype = ctypes.c_uint64
        got = int(lib.rtpu_lib_layout_version())
        if got != _LAYOUT_VERSION:
            raise OSError(f"shm store library {so!r}: layout version {got}, "
                          f"this client needs {_LAYOUT_VERSION}")
        lib.rtpu_store_create.restype = ctypes.c_void_p
        lib.rtpu_store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                          ctypes.c_uint64, ctypes.c_uint64,
                                          ctypes.c_int, ctypes.c_int]
        lib.rtpu_store_open.restype = ctypes.c_void_p
        lib.rtpu_store_open.argtypes = [ctypes.c_char_p]
        lib.rtpu_store_close.argtypes = [ctypes.c_void_p]
        lib.rtpu_store_unlink.argtypes = [ctypes.c_char_p]
        lib.rtpu_store_base.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.rtpu_store_base.argtypes = [ctypes.c_void_p]
        lib.rtpu_obj_create.restype = ctypes.c_uint64
        lib.rtpu_obj_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_uint64, ctypes.c_int64,
                                        ctypes.POINTER(ctypes.c_int)]
        lib.rtpu_obj_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_obj_get.restype = ctypes.c_int
        lib.rtpu_obj_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_uint64),
                                     ctypes.POINTER(ctypes.c_uint64)]
        lib.rtpu_obj_release.restype = ctypes.c_int
        lib.rtpu_obj_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_obj_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_obj_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_obj_abort.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_obj_reclaim_pending.restype = ctypes.c_int
        lib.rtpu_obj_reclaim_pending.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_char_p]
        lib.rtpu_store_stats.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_uint64)] * 4
        lib.rtpu_store_prefault.argtypes = [ctypes.c_void_p]
        lib.rtpu_store_size.restype = ctypes.c_uint64
        lib.rtpu_store_size.argtypes = [ctypes.c_void_p]
        lib.rtpu_store_set_auto_evict.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_int]
        lib.rtpu_store_spill_victims.restype = ctypes.c_int
        lib.rtpu_store_spill_victims.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.rtpu_store_layout_version.restype = ctypes.c_uint64
        lib.rtpu_store_layout_version.argtypes = [ctypes.c_void_p]
        lib.rtpu_store_n_shards.restype = ctypes.c_uint64
        lib.rtpu_store_n_shards.argtypes = [ctypes.c_void_p]
        lib.rtpu_store_spill_note.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int64]
        lib.rtpu_store_spill_count.restype = ctypes.c_int64
        lib.rtpu_store_spill_count.argtypes = [ctypes.c_void_p]
        lib.rtpu_store_max_object_bytes.restype = ctypes.c_uint64
        lib.rtpu_store_max_object_bytes.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


_KEY_SIZE = 28  # must match kKeySize in shm_store.cc (== ObjectID bytes)


def unlink_segment(name: str) -> None:
    """Remove a store segment's name (no-op when it is already gone)."""
    _load_lib().rtpu_store_unlink(name.encode())


# The store segments mapped in this process, as (first address, end
# address, store): what ``private_pages`` looks a decoded array up in.
_SEGMENTS: list = []


class _PinnedMap(mmap.mmap):
    """A private mapping of store pages; ``pin`` keeps the object pinned
    while the mapping lives (its unwritten pages read the store's)."""


def private_pages(arr: np.ndarray) -> Optional[np.ndarray]:
    """``arr``, which lies in a store segment mapped in this process, again
    over a private copy-on-write mapping of the segment's pages: reads share
    the store's memory, writes stay in this process. None when ``arr`` lies
    in no segment. Torch has no read-only tensors, so a CPU tensor decoded
    over the store takes this mapping, and an in-place op on it never
    changes the sealed object for its other readers."""
    addr = arr.__array_interface__["data"][0]
    for lo, hi, store in _SEGMENTS:
        if lo <= addr < hi:
            return store._private(arr, addr - lo)
    return None


class ShmObjectExistsError(Exception):
    pass


class ShmStoreFullError(Exception):
    pass


class PinnedBuffer:
    """Zero-copy view of a sealed object; releases its pin when closed /
    garbage-collected. Holding one keeps the object unevictable.

    Implements the buffer protocol: ``memoryview(pinned_buffer)`` (and every
    slice derived from it, and every numpy array deserialized over those
    slices) keeps THIS object alive, so the pin is only dropped once no view
    into the shm segment remains. This is how zero-copy ``get()`` stays safe
    against LRU eviction reusing the arena block (the reference ties plasma
    buffer lifetime to the python object the same way)."""

    def __init__(self, store: "ShmStore", key: bytes, mv: memoryview,
                 spill_pin: bool = False):
        self._store = store
        self._key = key
        self.buffer = mv
        self._released = False
        self._finalizer = weakref.finalize(
            self, store._release_raw, key, spill_pin)

    def release(self) -> None:
        if not self._released:
            self._released = True
            self.buffer = None
            self._finalizer()

    def __buffer__(self, flags: int) -> memoryview:
        return memoryview(self.buffer)

    def __len__(self):
        return len(self.buffer)


class ShmStore:
    """One mapped store segment."""

    def __init__(self, handle: int, name: str, owner: bool):
        self._lib = _load_lib()
        self._h = handle
        self.name = name
        self._owner = owner
        # Belt-and-braces attach guard: the C open/create already rejects
        # mismatched segments via the versioned magic, but a corrupted or
        # hand-rolled mapping must still fail fast here.
        seg_ver = int(self._lib.rtpu_store_layout_version(self._h))
        if seg_ver != _LAYOUT_VERSION:
            raise OSError(
                f"shm store {name!r} has layout version {seg_ver}, this "
                f"client needs {_LAYOUT_VERSION}; the creating process ran "
                "a different build; restart the cluster.")
        self.n_shards = int(self._lib.rtpu_store_n_shards(self._h))
        # Allocation affinity: this process prefers one sub-arena, so the
        # blocks it cycles through stay mapped in ITS page tables (soft
        # page faults are per-process and brutally slow on some
        # kernels — concurrent writers swapping blocks was the
        # multi-writer put collapse). Lookup correctness is unaffected:
        # an object's slot location is always key-hashed.
        self._pref_shard = os.getpid() % self.n_shards
        self.max_object_bytes = int(
            self._lib.rtpu_store_max_object_bytes(self._h))
        # Object views are built per-get from this base pointer; offsets from
        # the store are segment-relative.
        self._base_ptr = self._lib.rtpu_store_base(self._h)
        # The segment's file, for private mappings of its pages (kept
        # open: the owner may unlink the name while readers live).
        try:
            self._fd = os.open(os.path.join("/dev/shm", name.lstrip("/")),
                               os.O_RDONLY)
        except OSError:
            self._fd = None  # unlinked already: decoded tensors copy
        base = ctypes.addressof(self._base_ptr.contents)
        _SEGMENTS.append(
            (base, base + int(self._lib.rtpu_store_size(self._h)), self))
        # Disk spilling (reference: local_object_manager.h:110 +
        # external_storage.py): when enabled (config), memory pressure
        # spills LRU sealed objects to per-store files instead of
        # destructively evicting; reads transparently restore. The spill
        # dir derives from the store name so every process mapping the
        # segment (workers, node manager, driver) resolves the same files.
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as _cfg

        self._spill_enabled = bool(_cfg.object_spilling_enabled)
        self._spill_dir = os.path.join(_cfg.object_spilling_dir,
                                       name.lstrip("/"))
        if self._spill_enabled:
            os.makedirs(self._spill_dir, exist_ok=True)
            if owner:
                self._lib.rtpu_store_set_auto_evict(self._h, 0)
        self.n_spilled = 0
        self.n_restored = 0

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def create(cls, name: str, capacity: int, n_slots: int = 0,
               n_shards: int = 0, unlink_existing: bool = True,
               prefault: bool = True) -> "ShmStore":
        lib = _load_lib()
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as _cfg

        if not n_slots:
            n_slots = _cfg.object_store_slots
        if not n_shards:
            n_shards = _cfg.object_store_shards
        # The C side shrinks the shard count for tiny segments so every
        # sub-arena can still hold a real object; n_shards is a ceiling.
        h = lib.rtpu_store_create(name.encode(), capacity, n_slots,
                                  n_shards, 1 if unlink_existing else 0, 0)
        if not h:
            raise OSError(f"failed to create shm store {name!r}")
        store = cls(h, name, owner=True)
        if prefault:
            # madvise(MADV_POPULATE_WRITE) from a daemon thread: pages are
            # faulted in (not modified — safe alongside writers) while
            # create() returns instantly.
            threading.Thread(
                target=lambda: store._lib.rtpu_store_prefault(store._h),
                daemon=True, name=f"shm-prefault-{name}").start()
        return store

    @classmethod
    def open(cls, name: str) -> "ShmStore":
        lib = _load_lib()
        h = lib.rtpu_store_open(name.encode())
        if not h:
            raise OSError(
                f"failed to open shm store {name!r} (missing, or created "
                f"by a build with a different layout version — expected "
                f"v{_LAYOUT_VERSION})")
        return cls(h, name, owner=False)

    def close(self) -> None:
        # Deliberately does NOT rtpu_store_close (munmap): background
        # threads (push-ack sweeps, GC-driven deferred releases) can still
        # be inside a store call with the handle in hand — unmapping under
        # them is a use-after-unmap SIGSEGV at shutdown. The mapping is
        # reclaimed at process exit. Unlink (owner only) removes the NAME;
        # live mappings in other processes stay valid per POSIX shm.
        if getattr(self, "_closed", False):
            return
        self._closed = True
        if self._h and self._owner:
            self._lib.rtpu_store_unlink(self.name.encode())
            if self._spill_enabled:
                import shutil

                shutil.rmtree(self._spill_dir, ignore_errors=True)

    # -- raw segment access ------------------------------------------------

    def _private(self, arr: np.ndarray, offset: int) -> np.ndarray:
        """``private_pages`` for an array at ``offset`` in this segment."""
        if self._fd is None or not arr.flags.c_contiguous:
            return arr.copy()
        start = offset - offset % mmap.ALLOCATIONGRANULARITY
        pages = _PinnedMap(self._fd, offset + arr.nbytes - start,
                           flags=mmap.MAP_PRIVATE,
                           prot=mmap.PROT_READ | mmap.PROT_WRITE,
                           offset=start)
        pages.pin = arr
        return np.frombuffer(pages, arr.dtype, arr.size,
                             offset - start).reshape(arr.shape)

    def _view(self, offset: int, size: int) -> memoryview:
        ArrayT = ctypes.c_uint8 * size
        arr = ArrayT.from_address(
            ctypes.addressof(self._base_ptr.contents) + offset)
        return memoryview(arr).cast("B")

    @staticmethod
    def _key(oid: ObjectID) -> bytes:
        return oid.binary()

    # -- spilling ----------------------------------------------------------

    def _spill_path(self, key: bytes) -> str:
        return os.path.join(self._spill_dir, key.hex() + ".bin")

    def spill_for(self, need: int) -> bool:
        """Write LRU sealed unpinned objects out to disk (then delete them
        from the arena) until ~`need` bytes could be freed. Returns True if
        anything was spilled."""
        Buf = ctypes.c_uint8 * (256 * _KEY_SIZE)
        keys_buf = Buf()
        n = self._lib.rtpu_store_spill_victims(
            self._h, max(need, 1), keys_buf, 256)
        spilled = False
        for i in range(n):
            key = bytes(keys_buf[i * _KEY_SIZE:(i + 1) * _KEY_SIZE])
            oid = ObjectID(key)
            buf = self.get(oid, timeout_ms=0, _no_restore=True)
            if buf is None:
                continue  # raced: deleted/spilled by someone else
            path = self._spill_path(key)
            # Unique per (process, thread): two exec threads spilling the
            # same victim concurrently must not share a tmp name (the
            # second os.replace would find it already moved).
            tmp = path + f".tmp{os.getpid()}.{threading.get_ident()}"
            try:
                with open(tmp, "wb") as f:
                    f.write(buf.buffer)
                # Shared live-file counter: delete() on every process
                # mapping this store skips its unlink syscall while this
                # reads 0 (the overwhelmingly common case). Incremented
                # BEFORE the rename so a concurrent delete() can never
                # observe the file without the counter — skipping an
                # unlink there would let a stale file resurrect a deleted
                # object. Over-counting (rename lost a race) only costs
                # extra unlink attempts, never correctness.
                self._lib.rtpu_store_spill_note(self._h, 1)
                try:
                    os.replace(tmp, path)  # atomic: whole files only
                except FileNotFoundError:
                    # A concurrent spill (or a shutdown rmtree) won the
                    # race; the object is either safely on disk already or
                    # the store is going away.
                    self._lib.rtpu_store_spill_note(self._h, -1)
            finally:
                buf.release()
            self.spill_delete_only(oid)  # keep the file we just wrote
            self.n_spilled += 1
            spilled = True
        return spilled

    def _spill_files_live(self) -> bool:
        """True when any process mapping this store may have spill files on
        disk. One mapped-memory read — gates the per-op unlink/stat/open
        syscalls (~400us each on overlayfs) off the spill-less hot path."""
        return (self._spill_enabled
                and self._lib.rtpu_store_spill_count(self._h) > 0)

    def _maybe_restore(self, oid: ObjectID) -> bool:
        """Bring a spilled object back into the arena. True if present
        afterwards (restored here or concurrently by another process)."""
        if not self._spill_files_live():
            return False
        path = self._spill_path(self._key(oid))
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return False
        try:
            mv = self.create_buffer(oid, len(data))
        except ShmObjectExistsError:
            return True  # another process is restoring it; get() will wait
        except ShmStoreFullError:
            return False
        try:
            mv[:] = data
        except BaseException:
            self.abort(oid)
            raise
        self.seal(oid)
        self.n_restored += 1
        # Keep the file: it is the cheap insurance copy until delete().
        return True

    def _create_raw(self, key: bytes, total: int, what: str) -> int:
        """rtpu_obj_create with a spill-on-pressure rescue OFF the hot
        path: the common case is exactly one C call under one shard mutex
        (concurrent creates from separate processes proceed in parallel).
        Only a full store enters the spill/retry loop below — and the
        gc.collect rescue (zero-copy views stuck in GC cycles keeping
        arena pins alive) runs at most once per call, never per lap."""
        if total > self.max_object_bytes:
            raise ShmStoreFullError(
                f"object of {total} bytes exceeds the largest sub-arena "
                f"({self.max_object_bytes} bytes across {self.n_shards} "
                "shards); raise object_store_memory_bytes or lower "
                "object_store_shards")
        err = ctypes.c_int(0)
        off = self._lib.rtpu_obj_create(self._h, key, total,
                                        self._pref_shard, ctypes.byref(err))
        if off:
            return off
        if err.value == 1:
            raise ShmObjectExistsError(key.hex())

        def full():
            return ShmStoreFullError(
                f"store full ({what}: {total} bytes requested; "
                f"err={err.value}, spilling="
                f"{'on' if self._spill_enabled else 'off'})")

        if not self._spill_enabled:
            raise full()
        gc_done = False
        for attempt in range(24):
            spilled = self.spill_for(total)
            off = self._lib.rtpu_obj_create(self._h, key, total,
                                            self._pref_shard,
                                            ctypes.byref(err))
            if off:
                return off
            if err.value == 1:
                raise ShmObjectExistsError(key.hex())
            if not spilled:
                if not gc_done:
                    import gc

                    gc.collect()
                    gc_done = True
                    continue
                if attempt >= 4:
                    raise full()
                # Nothing spillable and GC already ran: concurrent pins
                # are the only thing that can still free room — wait them
                # out briefly, then give up.
                time.sleep(0.02 * (attempt + 1))
        raise full()

    # -- object API --------------------------------------------------------

    def put_bytes(self, oid: ObjectID, payload) -> None:
        """Create+write+seal in one call. payload: bytes-like or list of
        bytes-like (scattered write, no intermediate concat copy)."""
        parts = payload if isinstance(payload, (list, tuple)) else [payload]
        total = sum(len(p) for p in parts)
        key = self._key(oid)
        off = self._create_raw(key, total, "put_bytes")
        try:
            from ray_tpu_torch.core.serialization import stream_copy

            mv = self._view(off, total)
            pos = 0
            for p in parts:
                n = len(p)
                if not isinstance(p, (bytes, bytearray, memoryview)):
                    p = bytes(p)
                stream_copy(mv[pos:pos + n], p)
                pos += n
        except BaseException:
            self._lib.rtpu_obj_abort(self._h, key)
            raise
        self._lib.rtpu_obj_seal(self._h, key)

    def create_buffer(self, oid: ObjectID, size: int) -> memoryview:
        """Two-phase create: returns a writable view; call seal() after."""
        off = self._create_raw(self._key(oid), size, "create_buffer")
        return self._view(off, size)

    def seal(self, oid: ObjectID) -> None:
        self._lib.rtpu_obj_seal(self._h, self._key(oid))

    def abort(self, oid: ObjectID) -> None:
        self._lib.rtpu_obj_abort(self._h, self._key(oid))

    def get(self, oid: ObjectID, timeout_ms: int = 0,
            _no_restore: bool = False) -> Optional[PinnedBuffer]:
        """Pinned zero-copy read; transparently restores spilled objects.
        None on timeout/missing. ``_no_restore`` pins are SPILL pins: their
        release must never unlink the spill file (see _release_raw)."""
        key = self._key(oid)
        off = ctypes.c_uint64(0)
        size = ctypes.c_uint64(0)
        rc = self._lib.rtpu_obj_get(self._h, key, 0,
                                    ctypes.byref(off), ctypes.byref(size))
        if rc != 0 and not _no_restore and self._maybe_restore(oid):
            rc = self._lib.rtpu_obj_get(self._h, key, timeout_ms or 5000,
                                        ctypes.byref(off), ctypes.byref(size))
        elif rc != 0 and timeout_ms != 0:
            rc = self._lib.rtpu_obj_get(self._h, key, timeout_ms,
                                        ctypes.byref(off), ctypes.byref(size))
        if rc != 0:
            return None
        return PinnedBuffer(self, key, self._view(off.value, size.value),
                            spill_pin=_no_restore)

    def get_bytes(self, oid: ObjectID,
                  timeout_ms: int = 0) -> Optional[bytes]:
        """Copying read (no pin held afterwards)."""
        buf = self.get(oid, timeout_ms)
        if buf is None:
            return None
        try:
            return bytes(buf.buffer)
        finally:
            buf.release()

    def _release_raw(self, key: bytes, spill_pin: bool = False) -> None:
        if self._h:
            rc = self._lib.rtpu_obj_release(self._h, key)
            if rc == 2 and not spill_pin and self._spill_files_live():
                # Last pin of a DOOMED object (deleted while we held it):
                # any spill file we or others wrote must not resurrect it.
                # SPILL pins are exempt: two concurrent spills of the same
                # victim interleave as (T1 pin, T2 pin, T2 file, T2
                # arena-drop, T1 file, T1 release<-rc2) — T1 unlinking here
                # destroyed the just-written backing file, leaving a GHOST
                # object (owner says in_store; nothing anywhere). A stale
                # file after a real delete() is already unlinked by
                # delete() itself; the residual race leaks only a dead
                # file, never data.
                try:
                    os.unlink(self._spill_path(key))
                    self._lib.rtpu_store_spill_note(self._h, -1)
                except OSError:
                    pass

    def delete(self, oid: ObjectID) -> bool:
        """Remove the in-memory copy AND any spill file (a freed object must
        not resurrect on a later read). The unlink syscall is skipped while
        the shared spill-file counter reads 0 — the common (spill-less)
        case pays exactly one C call."""
        ok = self._lib.rtpu_obj_delete(self._h, self._key(oid)) == 0
        if self._spill_files_live():
            try:
                os.unlink(self._spill_path(self._key(oid)))
                self._lib.rtpu_store_spill_note(self._h, -1)
                ok = True
            except OSError:
                pass
        return ok

    def reclaim_pending(self, oid: ObjectID) -> bool:
        """Reclaim a create whose owner died between inserting its
        placeholder slot and filling it (the slot would otherwise wedge
        the key forever). Only touches PENDING placeholders — a live
        writer's allocated-but-unsealed object is never affected."""
        return self._lib.rtpu_obj_reclaim_pending(
            self._h, self._key(oid)) == 0

    def spill_delete_only(self, oid: ObjectID) -> bool:
        """delete() semantics as used by spill_for: drop ONLY the arena
        copy, keeping the spill file as the object's backing."""
        return self._lib.rtpu_obj_delete(self._h, self._key(oid)) == 0

    def contains(self, oid: ObjectID) -> bool:
        if bool(self._lib.rtpu_obj_contains(self._h, self._key(oid))):
            return True
        return (self._spill_files_live()
                and os.path.exists(self._spill_path(self._key(oid))))

    def stats(self) -> Tuple[int, int, int, int]:
        """(used_bytes, capacity, n_objects, n_evictions)."""
        vals = [ctypes.c_uint64(0) for _ in range(4)]
        self._lib.rtpu_store_stats(self._h, *[ctypes.byref(v) for v in vals])
        return tuple(v.value for v in vals)
