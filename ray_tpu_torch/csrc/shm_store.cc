// rtpu shm object store: the per-node object plane (plasma-equivalent).
//
// Design parity with the reference's plasma store
// (reference: src/ray/object_manager/plasma/store.h:55,
//  object_lifecycle_manager.h:101, eviction_policy.h:105), re-architected
// for the TPU era instead of ported: plasma is a *server process* speaking a
// flatbuffer protocol over a unix socket (reference plasma/plasma.fbs), which
// costs a socket round-trip per create/get/seal. Here the store is a plain
// POSIX shm segment that every worker process on the node maps directly;
// operations take a process-shared robust mutex and touch the header table
// in-place. Zero RPCs, zero copies on the hot path — get() returns an
// offset into the same mapping the creator wrote through. Host RAM is the
// staging area for TPU HBM, so the store doubles as the iter_batches
// device-prefetch source.
//
// Layout v2 — SHARDED for multi-writer scaling: the single arena + one
// process-shared mutex serialized every concurrent create/seal/get/release
// (aggregate put bandwidth *fell* when writers were added). Now:
//
//   [StoreHeader | ShardHeader[n_shards] | slot stripes | sub-arenas]
//
//   - an object's *home shard* is fnv1a(key) % n_shards: its slot lives in
//     that shard's stripe, so lookups (create-exists, get, seal, release,
//     delete, contains) take exactly ONE shard mutex.
//   - each shard owns a sub-arena with its own first-fit free list
//     (boundary-tag coalescing). create() allocates from the home shard's
//     arena and FALLS THROUGH to the other shards when it is full; the
//     slot records arena_shard so frees return the block to its owner.
//   - no operation ever holds two shard mutexes: create inserts a PENDING
//     placeholder slot (excludes duplicate creates), allocates under the
//     arena-owner's lock only, then fills the slot under the home lock.
//     Frees capture (offset, arena_shard) under the home lock, tombstone,
//     and free under the arena-owner's lock afterwards.
//   - eviction stays globally-LRU-correct across shards: the LRU clock is
//     a lock-free atomic in the store header, and evict scans every stripe
//     (one lock at a time) for the oldest sealed refcount-0 object whose
//     block lives in the pressured shard.
//   - crash safety: PTHREAD_MUTEX_ROBUST per shard — a worker dying
//     mid-section marks that shard's mutex inconsistent; the next locker
//     repairs and continues. The two-phase ops narrow the v1 guarantee:
//     a process dying BETWEEN a free's tombstone section and its
//     arena_free section leaks that one block until the store is
//     recreated (the offset lived only in the dead process), and one
//     dying between create's placeholder and fill leaves a PENDING slot
//     that rtpu_obj_reclaim_pending (driven by the Python put path's
//     takeover timer) clears. Both windows are microseconds of C code
//     with no syscalls besides the mutexes.
//   - kLayoutVersion is stamped into the mapped header and exported from
//     the library (rtpu_lib_layout_version) so a stale prebuilt .so — or a
//     stale RTPU_SHM_STORE_SO override — fails fast at attach instead of
//     silently corrupting the arena. Rebuild: python ray_tpu/_cpp/build.py
//   - spill_files: lock-free counter of live spill files for this store;
//     the Python layer checks it before paying unlink/stat syscalls on the
//     (overwhelmingly common) spill-less delete path.
//
// Built by ray_tpu/_cpp/build.py (g++ -O2 -shared), consumed via ctypes from
// ray_tpu/core/shm_store.py.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x325253485550'5452ULL;  // layout-v2 magic
constexpr uint64_t kLayoutVersion = 2;
constexpr int kKeySize = 28;
constexpr uint8_t kEmpty = 0;
constexpr uint8_t kCreated = 1;
constexpr uint8_t kSealed = 2;
constexpr uint8_t kTombstone = 3;  // slot freed; probe chains continue past
constexpr uint8_t kPendingShard = 0xff;  // create() allocation in flight

// Arena block header (boundary tags for O(1) coalescing).
struct BlockHeader {
  uint64_t size;       // payload size (bytes, 64-aligned)
  uint64_t prev_size;  // payload size of physically-previous block (0 = first)
  uint32_t free_;      // 1 if on free list
  uint32_t pad_;
  uint64_t next_free;  // offset of next free block (0 = end)
  uint64_t prev_free;  // offset of prev free block (0 = head)
};
constexpr uint64_t kBlockHdr = sizeof(BlockHeader);

struct Slot {
  uint8_t key[kKeySize];
  uint8_t state;
  uint8_t doomed;       // delete() hit a pinned object: dies at last release
  uint8_t arena_shard;  // which shard's sub-arena holds the payload
  uint8_t pad;
  int32_t refcount;
  uint64_t offset;     // data offset within segment (to payload)
  uint64_t data_size;  // user-visible size
  uint64_t lru_tick;
};

struct ShardHeader {
  pthread_mutex_t mutex;   // guards this shard's slot stripe + sub-arena
  pthread_cond_t seal_cond;
  uint64_t slot_off;       // absolute offset of this shard's slot stripe
  uint64_t n_slots;
  uint64_t arena_off;      // absolute offset of this shard's sub-arena
  uint64_t arena_size;
  uint64_t used_bytes;
  uint64_t free_head;      // absolute payload offset of first free block
  uint64_t n_objects;      // live objects whose HOME is this shard
  uint64_t n_evictions;
};

struct StoreHeader {
  uint64_t magic;
  uint64_t layout_version;
  uint64_t segment_size;
  uint64_t n_shards;
  uint64_t n_slots_total;
  uint64_t lru_clock;    // global LRU clock, advanced with atomics
  uint64_t auto_evict;   // 1 (default): create may destructively evict LRU
                         // sealed objects. 0: create fails with OOM and the
                         // client layer spills victims to disk first.
  uint64_t spill_files;  // live spill files for this store (atomic, approx)
  uint64_t shards_off;   // absolute offset of the ShardHeader array
};

struct Handle {
  uint8_t* base;
  uint64_t size;
  StoreHeader* hdr;
  ShardHeader* shards;
};

inline ShardHeader* shard(Handle* h, uint64_t i) { return &h->shards[i]; }

inline Slot* stripe(Handle* h, ShardHeader* sh) {
  return reinterpret_cast<Slot*>(h->base + sh->slot_off);
}

inline uint64_t align64(uint64_t n) { return (n + 63) & ~uint64_t(63); }

uint64_t fnv1a(const uint8_t* key) {
  uint64_t hsh = 1469598103934665603ULL;
  for (int i = 0; i < kKeySize; i++) {
    hsh ^= key[i];
    hsh *= 1099511628211ULL;
  }
  return hsh;
}

inline uint64_t home_of(Handle* h, const uint8_t* key) {
  // Mix the top bits in: the low bits also pick the probe start inside the
  // stripe, and reusing the same bits for both would cluster probes.
  uint64_t hsh = fnv1a(key);
  return (hsh >> 32) % h->hdr->n_shards;
}

inline uint64_t clock_tick(Handle* h) {
  return __atomic_add_fetch(&h->hdr->lru_clock, 1, __ATOMIC_RELAXED);
}

class Locker {
 public:
  explicit Locker(ShardHeader* sh) : sh_(sh) {
    int rc = pthread_mutex_lock(&sh_->mutex);
    if (rc == EOWNERDEAD) {
      // Previous owner died inside a critical section. Repair: the header
      // table is always left structurally valid between individual field
      // writes (see ordering notes in create/seal), so consistent-mark is
      // safe.
      pthread_mutex_consistent(&sh_->mutex);
    }
  }
  ~Locker() { pthread_mutex_unlock(&sh_->mutex); }

 private:
  ShardHeader* sh_;
};

// -------- arena allocator (per-shard first-fit free list, boundary-tag
// coalesce; caller holds the owning shard's mutex) ------------------------

inline BlockHeader* block_at(Handle* h, uint64_t payload_off) {
  return reinterpret_cast<BlockHeader*>(h->base + payload_off - kBlockHdr);
}

inline uint64_t next_payload_off(Handle* h, ShardHeader* sh,
                                 uint64_t payload_off) {
  BlockHeader* b = block_at(h, payload_off);
  uint64_t next = payload_off + b->size + kBlockHdr;
  if (next >= sh->arena_off + sh->arena_size) return 0;
  return next;
}

inline uint64_t prev_payload_off(Handle* h, ShardHeader* sh,
                                 uint64_t payload_off) {
  BlockHeader* b = block_at(h, payload_off);
  if (b->prev_size == 0 && payload_off == sh->arena_off + kBlockHdr)
    return 0;
  return payload_off - kBlockHdr - b->prev_size;
}

void freelist_remove(Handle* h, ShardHeader* sh, uint64_t off) {
  BlockHeader* b = block_at(h, off);
  if (b->prev_free)
    block_at(h, b->prev_free)->next_free = b->next_free;
  else
    sh->free_head = b->next_free;
  if (b->next_free) block_at(h, b->next_free)->prev_free = b->prev_free;
  b->next_free = b->prev_free = 0;
  b->free_ = 0;
}

void freelist_push(Handle* h, ShardHeader* sh, uint64_t off) {
  BlockHeader* b = block_at(h, off);
  b->free_ = 1;
  b->prev_free = 0;
  b->next_free = sh->free_head;
  if (sh->free_head) block_at(h, sh->free_head)->prev_free = off;
  sh->free_head = off;
}

// Split block at `off` so its payload is exactly `want` (aligned); push
// remainder to the free list.
void split_block(Handle* h, ShardHeader* sh, uint64_t off, uint64_t want) {
  BlockHeader* b = block_at(h, off);
  uint64_t spare = b->size - want;
  if (spare < kBlockHdr + 64) return;  // too small to split
  uint64_t rem_off = off + want + kBlockHdr;
  BlockHeader* rem = block_at(h, rem_off);
  rem->size = spare - kBlockHdr;
  rem->prev_size = want;
  rem->free_ = 0;
  rem->next_free = rem->prev_free = 0;
  b->size = want;
  uint64_t after = next_payload_off(h, sh, rem_off);
  if (after) block_at(h, after)->prev_size = rem->size;
  freelist_push(h, sh, rem_off);
}

// Returns payload offset or 0.
uint64_t arena_alloc(Handle* h, ShardHeader* sh, uint64_t want) {
  want = align64(want ? want : 1);
  uint64_t off = sh->free_head;
  while (off) {
    BlockHeader* b = block_at(h, off);
    if (b->size >= want) {
      freelist_remove(h, sh, off);
      split_block(h, sh, off, want);
      sh->used_bytes += block_at(h, off)->size + kBlockHdr;
      return off;
    }
    off = b->next_free;
  }
  return 0;
}

void arena_free(Handle* h, ShardHeader* sh, uint64_t off) {
  BlockHeader* b = block_at(h, off);
  sh->used_bytes -= b->size + kBlockHdr;
  // Coalesce with next.
  uint64_t next = next_payload_off(h, sh, off);
  if (next && block_at(h, next)->free_) {
    freelist_remove(h, sh, next);
    b->size += block_at(h, next)->size + kBlockHdr;
    uint64_t after = next_payload_off(h, sh, off);
    if (after) block_at(h, after)->prev_size = b->size;
  }
  // Coalesce with prev.
  uint64_t prev = prev_payload_off(h, sh, off);
  if (prev && block_at(h, prev)->free_) {
    BlockHeader* pb = block_at(h, prev);
    freelist_remove(h, sh, prev);
    pb->size += b->size + kBlockHdr;
    uint64_t after = next_payload_off(h, sh, prev);
    if (after) block_at(h, after)->prev_size = pb->size;
    off = prev;
  }
  freelist_push(h, sh, off);
}

// Free a payload block owned by shard `si`, taking that shard's lock.
void free_block_in(Handle* h, uint64_t si, uint64_t off) {
  ShardHeader* as = shard(h, si);
  Locker lock(as);
  arena_free(h, as, off);
}

// -------- slot stripes (caller holds the stripe's shard mutex) -----------

Slot* find_slot_in(Handle* h, ShardHeader* sh, const uint8_t* key) {
  Slot* table = stripe(h, sh);
  uint64_t n = sh->n_slots;
  uint64_t i = fnv1a(key) % n;
  for (uint64_t probes = 0; probes < n; probes++) {
    Slot* s = &table[i];
    if (s->state == kEmpty) return nullptr;
    if (s->state != kTombstone && memcmp(s->key, key, kKeySize) == 0) return s;
    i = (i + 1) % n;
  }
  return nullptr;
}

Slot* find_insert_slot_in(Handle* h, ShardHeader* sh, const uint8_t* key) {
  Slot* table = stripe(h, sh);
  uint64_t n = sh->n_slots;
  uint64_t i = fnv1a(key) % n;
  Slot* first_tomb = nullptr;
  for (uint64_t probes = 0; probes < n; probes++) {
    Slot* s = &table[i];
    if (s->state == kEmpty) return first_tomb ? first_tomb : s;
    if (s->state == kTombstone) {
      if (!first_tomb) first_tomb = s;
    } else if (memcmp(s->key, key, kKeySize) == 0) {
      return nullptr;  // exists
    }
    i = (i + 1) % n;
  }
  return first_tomb;  // table full of live+tombstones; may still reuse tomb
}

// Evict globally-LRU sealed refcount-0 objects whose payload lives in shard
// `target` until at least `need` contiguous bytes could be allocated there
// (or nothing evictable remains). Never holds two locks: each scan round
// takes one stripe lock at a time, then re-verifies the victim under its
// home lock before tombstoning. Returns 1 if enough room was made.
int evict_in_shard(Handle* h, uint64_t target, uint64_t need) {
  uint64_t n = h->hdr->n_shards;
  for (;;) {
    uint8_t vkey[kKeySize];
    uint64_t vtick = 0;
    int found = 0;
    for (uint64_t si = 0; si < n; si++) {
      ShardHeader* sh = shard(h, si);
      Locker lock(sh);
      Slot* table = stripe(h, sh);
      for (uint64_t i = 0; i < sh->n_slots; i++) {
        Slot* s = &table[i];
        if (s->state != kSealed || s->refcount != 0 || s->doomed ||
            s->arena_shard != target)
          continue;
        if (!found || s->lru_tick < vtick) {
          memcpy(vkey, s->key, kKeySize);
          vtick = s->lru_tick;
          found = 1;
        }
      }
    }
    if (!found) return 0;
    // Delete the victim (it may have been pinned/removed since the scan).
    uint64_t home = home_of(h, vkey);
    ShardHeader* hs = shard(h, home);
    uint64_t free_off = 0;
    {
      Locker lock(hs);
      Slot* s = find_slot_in(h, hs, vkey);
      if (s && s->state == kSealed && s->refcount == 0 && !s->doomed &&
          s->arena_shard == target && s->lru_tick == vtick) {
        free_off = s->offset;
        s->state = kTombstone;
        hs->n_objects--;
        hs->n_evictions++;
      }
    }
    ShardHeader* as = shard(h, target);
    {
      Locker lock(as);
      if (free_off) arena_free(h, as, free_off);
      // Enough contiguous room now?
      uint64_t off = arena_alloc(h, as, need);
      if (off) {
        arena_free(h, as, off);
        return 1;
      }
    }
  }
}

}  // namespace

extern "C" {

// Compile-time layout version of THIS library build; the Python client
// refuses to run against a library whose version it does not expect.
uint64_t rtpu_lib_layout_version() { return kLayoutVersion; }

// Layout version stamped into a mapped segment's header.
uint64_t rtpu_store_layout_version(void* hp) {
  return reinterpret_cast<Handle*>(hp)->hdr->layout_version;
}

uint64_t rtpu_store_n_shards(void* hp) {
  return reinterpret_cast<Handle*>(hp)->hdr->n_shards;
}

// Largest single allocation any sub-arena could ever satisfy (an object
// cannot span sub-arenas) — the client fails oversized creates fast with
// a clear error instead of spinning through futile spill/evict laps.
uint64_t rtpu_store_max_object_bytes(void* hp) {
  auto* h = reinterpret_cast<Handle*>(hp);
  uint64_t arena = shard(h, 0)->arena_size;
  return arena > 2 * kBlockHdr ? arena - 2 * kBlockHdr : 0;
}

// Create + initialize a store segment. Fails if it already exists unless
// unlink_existing. Returns handle or null.
void* rtpu_store_create(const char* name, uint64_t segment_size,
                        uint64_t n_slots, uint64_t n_shards,
                        int unlink_existing, int populate) {
  if (unlink_existing) shm_unlink(name);
  if (n_shards < 1) n_shards = 1;
  if (n_shards > 64) n_shards = 64;
  if (n_slots < n_shards * 8) n_slots = n_shards * 8;
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)segment_size) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  // Optional MAP_POPULATE prefaults the segment at creation so first-touch
  // page faults never throttle the put path (cold: ~0.05 GB/s, prefaulted:
  // memcpy-bound ~4 GB/s) — but costs seconds/GB up front, so the Python
  // side defaults to a background prefault thread instead.
  int flags = MAP_SHARED | (populate ? MAP_POPULATE : 0);
  void* base =
      mmap(nullptr, segment_size, PROT_READ | PROT_WRITE, flags, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;

  auto* hdr = reinterpret_cast<StoreHeader*>(base);
  memset(hdr, 0, sizeof(StoreHeader));
  hdr->segment_size = segment_size;
  hdr->layout_version = kLayoutVersion;

  // Shrink the shard count until every sub-arena is usefully large: a
  // single object can never span sub-arenas, so small (test) stores
  // collapse to fewer shards rather than making every big object
  // unallocatable. 64 MB minimum keeps the default 2 GB store at 8 shards
  // while a 64 MB store stays monolithic.
  constexpr uint64_t kMinSubArena = 64ULL << 20;
  uint64_t shards_off = align64(sizeof(StoreHeader));
  uint64_t n, slots_per, stripe_bytes, arena_off, per_arena;
  for (n = n_shards;; n /= 2) {
    uint64_t shard_hdr_bytes = align64(n * sizeof(ShardHeader));
    slots_per = (n_slots + n - 1) / n;
    stripe_bytes = align64(slots_per * sizeof(Slot));
    arena_off = shards_off + shard_hdr_bytes + n * stripe_bytes;
    if (arena_off >= segment_size) {
      if (n == 1) {
        munmap(base, segment_size);
        shm_unlink(name);
        return nullptr;  // segment cannot even hold the tables
      }
      continue;
    }
    per_arena = ((segment_size - arena_off) / n) & ~uint64_t(63);
    if (per_arena >= kMinSubArena || n == 1) break;
  }
  if (per_arena <= kBlockHdr + 64) {
    munmap(base, segment_size);
    shm_unlink(name);
    return nullptr;
  }
  hdr->n_shards = n;
  hdr->n_slots_total = slots_per * n;
  hdr->auto_evict = 1;
  hdr->shards_off = shards_off;

  auto* shards = reinterpret_cast<ShardHeader*>(
      reinterpret_cast<uint8_t*>(base) + shards_off);
  auto* h = new Handle{reinterpret_cast<uint8_t*>(base), segment_size, hdr,
                       shards};

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_condattr_setclock(&ca, CLOCK_MONOTONIC);

  uint64_t shard_hdr_bytes = align64(n * sizeof(ShardHeader));
  uint64_t slot_base = shards_off + shard_hdr_bytes;
  memset(reinterpret_cast<uint8_t*>(base) + slot_base, 0, n * stripe_bytes);
  for (uint64_t i = 0; i < n; i++) {
    ShardHeader* sh = &shards[i];
    memset(reinterpret_cast<void*>(sh), 0, sizeof(ShardHeader));
    sh->slot_off = slot_base + i * stripe_bytes;
    sh->n_slots = slots_per;
    sh->arena_off = arena_off + i * per_arena;
    sh->arena_size = per_arena;
    pthread_mutex_init(&sh->mutex, &ma);
    pthread_cond_init(&sh->seal_cond, &ca);
    // One giant free block spanning this shard's sub-arena.
    uint64_t first = sh->arena_off + kBlockHdr;
    BlockHeader* b = block_at(h, first);
    b->size = sh->arena_size - kBlockHdr;
    b->prev_size = 0;
    b->free_ = 0;
    b->next_free = b->prev_free = 0;
    freelist_push(h, sh, first);
  }
  hdr->magic = kMagic;  // last: marks init complete for openers
  return h;
}

void* rtpu_store_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base =
      mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  auto* hdr = reinterpret_cast<StoreHeader*>(base);
  if (hdr->magic != kMagic || hdr->layout_version != kLayoutVersion) {
    munmap(base, st.st_size);
    return nullptr;
  }
  auto* shards = reinterpret_cast<ShardHeader*>(
      reinterpret_cast<uint8_t*>(base) + hdr->shards_off);
  return new Handle{reinterpret_cast<uint8_t*>(base), (uint64_t)st.st_size,
                    hdr, shards};
}

void rtpu_store_close(void* hp) {
  auto* h = reinterpret_cast<Handle*>(hp);
  munmap(h->base, h->size);
  delete h;
}

void rtpu_store_unlink(const char* name) { shm_unlink(name); }

// Node-wide eviction policy switch (lives in the shared header so every
// mapping process obeys it). 0 = fail-with-OOM so the client layer can
// spill to disk instead of destroying data.
void rtpu_store_set_auto_evict(void* hp, int on) {
  auto* h = reinterpret_cast<Handle*>(hp);
  __atomic_store_n(&h->hdr->auto_evict, on ? 1 : 0, __ATOMIC_RELAXED);
}

// Live spill-file accounting (approximate, lock-free): the Python layer
// bumps it when a spill file is written and decrements on unlink, then
// skips the per-delete unlink/stat syscalls entirely while it reads 0 —
// those syscalls were ~400us each on overlayfs and dominated put/delete.
void rtpu_store_spill_note(void* hp, int64_t delta) {
  auto* h = reinterpret_cast<Handle*>(hp);
  __atomic_add_fetch(&h->hdr->spill_files, (uint64_t)delta, __ATOMIC_RELAXED);
}

int64_t rtpu_store_spill_count(void* hp) {
  auto* h = reinterpret_cast<Handle*>(hp);
  return (int64_t)__atomic_load_n(&h->hdr->spill_files, __ATOMIC_RELAXED);
}

// Select LRU sealed refcount-0 victims whose sizes sum to >= need (or until
// none remain / max_keys reached). Copies their keys into keys_out
// (kKeySize bytes each) WITHOUT removing them — the caller reads each out
// to disk, then deletes it. Returns the number of keys written. Victims are
// chosen across ALL shards by the global LRU clock.
int rtpu_store_spill_victims(void* hp, uint64_t need, uint8_t* keys_out,
                             int max_keys) {
  auto* h = reinterpret_cast<Handle*>(hp);
  if (max_keys > 256) max_keys = 256;
  uint64_t chosen[256];  // global slot index = shard * stride + i
  int count = 0;
  uint64_t acc = 0;
  uint64_t n = h->hdr->n_shards;
  uint64_t stride = shard(h, 0)->n_slots;
  while (count < max_keys && acc < need) {
    int found = 0;
    uint64_t best_tick = 0, best_idx = 0, best_size = 0;
    uint8_t best_key[kKeySize];
    for (uint64_t si = 0; si < n; si++) {
      ShardHeader* sh = shard(h, si);
      Locker lock(sh);
      Slot* table = stripe(h, sh);
      for (uint64_t i = 0; i < sh->n_slots; i++) {
        Slot* s = &table[i];
        if (s->state != kSealed || s->refcount != 0 || s->doomed) continue;
        uint64_t gidx = si * stride + i;
        bool taken = false;
        for (int j = 0; j < count; j++) {
          if (chosen[j] == gidx) { taken = true; break; }
        }
        if (taken) continue;
        if (!found || s->lru_tick < best_tick) {
          best_tick = s->lru_tick;
          best_idx = gidx;
          best_size = s->data_size;
          memcpy(best_key, s->key, kKeySize);
          found = 1;
        }
      }
    }
    if (!found) break;
    chosen[count] = best_idx;
    memcpy(keys_out + (uint64_t)count * kKeySize, best_key, kKeySize);
    acc += best_size;
    count++;
  }
  return count;
}

uint8_t* rtpu_store_base(void* hp) {
  return reinterpret_cast<Handle*>(hp)->base;
}

// Reserve space for an object. Returns payload offset, or 0 on:
//   errno_out = 1 (already exists), 2 (out of memory even after eviction),
//               3 (slot table full).
//
// Two-phase: a PENDING placeholder slot is inserted under the home shard's
// lock (duplicate creates see err 1 immediately), then the arena block is
// allocated under the owning shard's lock only — concurrent creates from
// separate processes proceed in parallel unless they hash to one shard.
//
// pref_shard (>= 0) is the caller's ALLOCATION-affinity hint, normally
// pid-derived: the slot's home stays key-hashed (lookups are one-shard),
// but the payload block is taken from the preferred sub-arena first, so a
// writer process keeps reusing blocks its own page tables already map.
// Without this, concurrent writers swap first-fit blocks between
// processes and every put pays per-process soft page faults over the
// whole block (~30us/page on some kernels = the multi-writer put
// collapse). pref_shard < 0 falls back to the home shard.
uint64_t rtpu_obj_create(void* hp, const uint8_t* key, uint64_t data_size,
                         int64_t pref_shard, int* errno_out) {
  auto* h = reinterpret_cast<Handle*>(hp);
  *errno_out = 0;
  uint64_t home = home_of(h, key);
  ShardHeader* hs = shard(h, home);
  {
    Locker lock(hs);
    if (find_slot_in(h, hs, key)) {
      *errno_out = 1;
      return 0;
    }
    Slot* s = find_insert_slot_in(h, hs, key);
    if (!s) {
      *errno_out = 3;
      return 0;
    }
    memcpy(s->key, key, kKeySize);
    s->refcount = 0;
    s->doomed = 0;
    s->offset = 0;
    s->data_size = data_size;
    s->arena_shard = kPendingShard;
    s->lru_tick = clock_tick(h);
    s->state = kCreated;  // visible, but pending: get/seal/delete skip it
    hs->n_objects++;
  }
  uint64_t n = h->hdr->n_shards;
  uint64_t first = (pref_shard >= 0 ? (uint64_t)pref_shard % n : home);
  uint64_t off = 0, ashard = 0;
  for (uint64_t d = 0; d < n && !off; d++) {
    uint64_t si = (first + d) % n;
    ShardHeader* as = shard(h, si);
    Locker lock(as);
    off = arena_alloc(h, as, data_size);
    if (off) ashard = si;
  }
  if (!off && __atomic_load_n(&h->hdr->auto_evict, __ATOMIC_RELAXED)) {
    uint64_t need = align64(data_size ? data_size : 1);
    for (uint64_t d = 0; d < n && !off; d++) {
      uint64_t si = (first + d) % n;
      if (evict_in_shard(h, si, need)) {
        ShardHeader* as = shard(h, si);
        Locker lock(as);
        off = arena_alloc(h, as, data_size);
        if (off) ashard = si;
      }
    }
  }
  int filled = 0;
  {
    Locker lock(hs);
    Slot* s = find_slot_in(h, hs, key);
    if (s && s->state == kCreated && s->arena_shard == kPendingShard) {
      if (off) {
        s->offset = off;
        s->arena_shard = (uint8_t)ashard;
        filled = 1;
      } else {
        s->state = kTombstone;
        hs->n_objects--;
      }
    }
  }
  if (!off) {
    *errno_out = 2;
    return 0;
  }
  if (!filled) {  // placeholder vanished (defensive): return the block
    free_block_in(h, ashard, off);
    *errno_out = 2;
    return 0;
  }
  return off;
}

int rtpu_obj_seal(void* hp, const uint8_t* key) {
  auto* h = reinterpret_cast<Handle*>(hp);
  ShardHeader* hs = shard(h, home_of(h, key));
  Locker lock(hs);
  Slot* s = find_slot_in(h, hs, key);
  if (!s || s->state != kCreated || s->arena_shard == kPendingShard)
    return -1;
  s->state = kSealed;
  pthread_cond_broadcast(&hs->seal_cond);
  return 0;
}

// Blocking get: waits up to timeout_ms (-1 = forever, 0 = nonblocking) for
// the object to be sealed. On success pins (refcount++) and fills
// offset/size. Returns 0 ok, -1 timeout/missing.
int rtpu_obj_get(void* hp, const uint8_t* key, int64_t timeout_ms,
                 uint64_t* offset, uint64_t* size) {
  auto* h = reinterpret_cast<Handle*>(hp);
  ShardHeader* hs = shard(h, home_of(h, key));
  Locker lock(hs);
  struct timespec deadline;
  if (timeout_ms > 0) {
    clock_gettime(CLOCK_MONOTONIC, &deadline);
    deadline.tv_sec += timeout_ms / 1000;
    deadline.tv_nsec += (timeout_ms % 1000) * 1000000L;
    if (deadline.tv_nsec >= 1000000000L) {
      deadline.tv_sec++;
      deadline.tv_nsec -= 1000000000L;
    }
  }
  for (;;) {
    Slot* s = find_slot_in(h, hs, key);
    if (s && s->state == kSealed && !s->doomed) {
      s->refcount++;
      s->lru_tick = clock_tick(h);
      *offset = s->offset;
      *size = s->data_size;
      return 0;
    }
    if (timeout_ms == 0) return -1;
    int rc;
    if (timeout_ms < 0) {
      rc = pthread_cond_wait(&hs->seal_cond, &hs->mutex);
    } else {
      rc = pthread_cond_timedwait(&hs->seal_cond, &hs->mutex, &deadline);
    }
    if (rc == ETIMEDOUT) return -1;
    if (rc == EOWNERDEAD) pthread_mutex_consistent(&hs->mutex);
  }
}

// Returns 0 on plain release, 2 when this was the LAST pin of a doomed
// object (now freed) — the caller must treat the object as deleted.
int rtpu_obj_release(void* hp, const uint8_t* key) {
  auto* h = reinterpret_cast<Handle*>(hp);
  ShardHeader* hs = shard(h, home_of(h, key));
  uint64_t free_off = 0, fshard = 0;
  {
    Locker lock(hs);
    Slot* s = find_slot_in(h, hs, key);
    if (!s || s->refcount <= 0) return -1;
    s->refcount--;
    if (s->refcount == 0 && s->doomed) {
      free_off = s->offset;
      fshard = s->arena_shard;
      s->state = kTombstone;
      s->doomed = 0;
      hs->n_objects--;
    }
  }
  if (free_off) {
    free_block_in(h, fshard, free_off);
    return 2;
  }
  return 0;
}

// Delete: free immediately if unpinned; pinned objects are DOOMED — they
// read as absent immediately (get/contains miss them) and their memory is
// freed by the LAST release. This closes the spill/consume race: a
// concurrent spiller's pin cannot make a consumer's delete silently fail
// (the spiller's release returns 2 so it can discard the spill file it
// wrote). A PENDING create (allocation in flight) reads as missing.
int rtpu_obj_delete(void* hp, const uint8_t* key) {
  auto* h = reinterpret_cast<Handle*>(hp);
  ShardHeader* hs = shard(h, home_of(h, key));
  uint64_t free_off = 0, fshard = 0;
  {
    Locker lock(hs);
    Slot* s = find_slot_in(h, hs, key);
    if (!s || (s->state == kCreated && s->arena_shard == kPendingShard))
      return -1;  // pending placeholders are reclaimed via _reclaim_pending
    if (s->refcount > 0) {
      s->doomed = 1;
      return 0;
    }
    free_off = s->offset;
    fshard = s->arena_shard;
    s->state = kTombstone;
    s->doomed = 0;
    hs->n_objects--;
  }
  free_block_in(h, fshard, free_off);
  return 0;
}

// Reclaim a PENDING placeholder slot (creator died between inserting the
// placeholder and filling it — no other op touches pending slots, so a
// dead creator would wedge the key forever). Touches ONLY pending slots:
// a live writer's kCreated (mid-write, allocation complete) slot is never
// affected. The slot owns no arena block yet; a still-LIVE creator whose
// placeholder was reclaimed out from under it finds the slot gone at fill
// time and returns its freshly-allocated block (the !filled branch in
// rtpu_obj_create). Returns 0 if reclaimed, -1 otherwise.
int rtpu_obj_reclaim_pending(void* hp, const uint8_t* key) {
  auto* h = reinterpret_cast<Handle*>(hp);
  ShardHeader* hs = shard(h, home_of(h, key));
  Locker lock(hs);
  Slot* s = find_slot_in(h, hs, key);
  if (!s || s->state != kCreated || s->arena_shard != kPendingShard)
    return -1;
  s->state = kTombstone;
  hs->n_objects--;
  return 0;
}

int rtpu_obj_contains(void* hp, const uint8_t* key) {
  auto* h = reinterpret_cast<Handle*>(hp);
  ShardHeader* hs = shard(h, home_of(h, key));
  Locker lock(hs);
  Slot* s = find_slot_in(h, hs, key);
  return (s && s->state == kSealed && !s->doomed) ? 1 : 0;
}

// Abort an in-progress create (creator failed before seal).
int rtpu_obj_abort(void* hp, const uint8_t* key) {
  auto* h = reinterpret_cast<Handle*>(hp);
  ShardHeader* hs = shard(h, home_of(h, key));
  uint64_t free_off = 0, fshard = 0;
  {
    Locker lock(hs);
    Slot* s = find_slot_in(h, hs, key);
    if (!s || s->state != kCreated || s->arena_shard == kPendingShard)
      return -1;
    free_off = s->offset;
    fshard = s->arena_shard;
    s->state = kTombstone;
    hs->n_objects--;
  }
  free_block_in(h, fshard, free_off);
  return 0;
}

uint64_t rtpu_store_size(void* hp) {
  return reinterpret_cast<Handle*>(hp)->size;
}

// Fault the whole segment in without touching contents (safe concurrently
// with writers — pages are populated, not modified). Called from a
// background thread by the creator so puts never pay first-touch faults.
int rtpu_store_prefault(void* hp) {
#ifdef MADV_POPULATE_WRITE
  auto* h = reinterpret_cast<Handle*>(hp);
  return madvise(h->base, h->size, MADV_POPULATE_WRITE);
#else
  return -1;
#endif
}

void rtpu_store_stats(void* hp, uint64_t* used, uint64_t* capacity,
                      uint64_t* n_objects, uint64_t* n_evictions) {
  auto* h = reinterpret_cast<Handle*>(hp);
  *used = *capacity = *n_objects = *n_evictions = 0;
  for (uint64_t si = 0; si < h->hdr->n_shards; si++) {
    ShardHeader* sh = shard(h, si);
    Locker lock(sh);
    *used += sh->used_bytes;
    *capacity += sh->arena_size;
    *n_objects += sh->n_objects;
    *n_evictions += sh->n_evictions;
  }
}

}  // extern "C"
