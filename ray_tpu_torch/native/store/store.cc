// Native shared-memory object store: one mmap'd arena per node, a slab
// (first-fit free-list) allocator and an open-addressed object index, both
// living INSIDE the shared mapping so every process on the node sees one
// coherent store with zero-copy reads and no store-server process.
//
// Plays the role of the reference's plasma store + eviction bookkeeping
// (reference: src/ray/object_manager/plasma/store.h:53, dlmalloc arena in
// plasma/malloc.cc) redesigned for the TPU host: no fd passing, no IPC —
// creation is allocate+memcpy, sealing is one atomic flag store, lookup is
// a lock-free-read hash probe. Cross-process mutual exclusion for
// allocation/deletion uses a robust pthread mutex in the arena header so a
// crashed worker can never deadlock the node.
//
// C ABI (driven from Python via ctypes — see native_store.py):
//   rts_open / rts_close
//   rts_create -> offset   (writable region; caller memcpys then seals)
//   rts_seal
//   rts_get    -> offset,size   (sealed objects only)
//   rts_delete
//   rts_stats

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52545055464f5255ULL;  // "RTPUFORU" (v3: refs)
constexpr uint32_t kIdBytes = 24;  // ObjectID size (ids.py: TaskID16+tag4+rand4)
constexpr uint32_t kAlign = 64;  // cacheline; also keeps numpy views aligned

enum SlotState : uint32_t {
  kFree = 0,
  kCreating = 1,
  kSealed = 2,
  // Deleted while readers still hold pins: invisible to lookups, block
  // freed when the last pin releases (plasma-style deferred deletion,
  // reference: plasma clients hold objects in use until Release).
  kZombie = 3,
};

struct Slot {
  uint8_t id[kIdBytes];
  uint64_t offset;
  uint64_t size;
  uint32_t state;
  uint32_t probe_live;  // 1 while this slot participates in probe chains
  uint32_t refs;        // outstanding reader pins (rts_get/rts_release)
};

struct Block {  // free-list node, stored at block start inside the arena
  uint64_t size;      // payload capacity of this block
  uint64_t next_off;  // next free block offset (0 = none)
};

struct Header {
  uint64_t magic;
  uint64_t capacity;       // arena bytes after the header/index
  uint64_t data_start;     // file offset where allocatable data begins
  uint64_t free_head;      // offset of first free block (0 = none)
  uint64_t used_bytes;
  uint64_t num_objects;
  uint64_t tombstones;     // kFree slots still holding probe chains open
  uint32_t num_slots;
  pthread_mutex_t mu;      // robust, pshared
};

struct Handle {
  uint8_t* base;
  uint64_t map_len;
  Header* hdr;
  Slot* slots;
};

uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~uint64_t(kAlign - 1); }

uint64_t hash_id(const uint8_t* id) {
  // FNV-1a over the 16-byte id
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdBytes; i++) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return h;
}

class Lock {
 public:
  explicit Lock(Header* hdr) : hdr_(hdr) {
    int rc = pthread_mutex_lock(&hdr_->mu);
    if (rc == EOWNERDEAD) {
      // A process died holding the lock; state is still consistent for our
      // operations (each op completes its bookkeeping before unlock), so
      // mark it recovered and continue.
      pthread_mutex_consistent(&hdr_->mu);
    }
  }
  ~Lock() { pthread_mutex_unlock(&hdr_->mu); }

 private:
  Header* hdr_;
};

Slot* find_slot(Handle* h, const uint8_t* id, bool want_sealed) {
  uint32_t n = h->hdr->num_slots;
  uint64_t idx = hash_id(id) % n;
  for (uint32_t probes = 0; probes < n; probes++) {
    Slot* s = &h->slots[(idx + probes) % n];
    if (s->state == kFree && !s->probe_live) return nullptr;
    if (s->state != kFree && memcmp(s->id, id, kIdBytes) == 0) {
      if (s->state == kZombie) continue;  // invisible; a fresh slot with
                                          // the same id may live further
                                          // down the chain
      if (want_sealed && s->state != kSealed) return nullptr;
      return s;
    }
  }
  return nullptr;
}

Slot* claim_slot(Handle* h, const uint8_t* id) {
  uint32_t n = h->hdr->num_slots;
  uint64_t idx = hash_id(id) % n;
  for (uint32_t probes = 0; probes < n; probes++) {
    Slot* s = &h->slots[(idx + probes) % n];
    if (s->state == kFree) {
      if (s->probe_live) h->hdr->tombstones--;  // recycling a tombstone
      memcpy(s->id, id, kIdBytes);
      s->probe_live = 1;
      return s;
    }
    if (memcmp(s->id, id, kIdBytes) == 0 && s->state != kZombie)
      return nullptr;  // duplicate (zombies of the id may coexist)
  }
  return nullptr;  // index full
}

// Rebuild the index in place, dropping tombstones (amortized: runs when
// tombstones exceed half the table; keeps miss-lookups O(cluster) instead
// of degrading to full-table scans over the node's lifetime).
void maybe_rehash(Handle* h) {
  Header* hdr = h->hdr;
  if (hdr->tombstones <= hdr->num_slots / 2) return;
  uint32_t n = hdr->num_slots;
  // Collect live slots — count first: num_objects excludes zombies,
  // which must survive a rehash (their pins are still outstanding).
  uint64_t live_n = 0;
  for (uint32_t i = 0; i < n; i++)
    if (h->slots[i].state != kFree) live_n++;
  Slot* live = new Slot[live_n ? live_n : 1];
  uint64_t m = 0;
  for (uint32_t i = 0; i < n; i++) {
    if (h->slots[i].state != kFree) live[m++] = h->slots[i];
    h->slots[i].state = kFree;
    h->slots[i].probe_live = 0;
  }
  hdr->tombstones = 0;
  for (uint64_t j = 0; j < m; j++) {
    uint64_t idx = hash_id(live[j].id) % n;
    for (uint32_t probes = 0; probes < n; probes++) {
      Slot* s = &h->slots[(idx + probes) % n];
      if (s->state == kFree) {
        *s = live[j];
        s->probe_live = 1;
        break;
      }
    }
  }
  delete[] live;
}

// First-fit allocation from the in-arena free list. Returns 0 on failure.
uint64_t alloc_block(Handle* h, uint64_t want) {
  want = align_up(want);
  Header* hdr = h->hdr;
  uint64_t prev_off = 0;
  uint64_t off = hdr->free_head;
  while (off) {
    Block* b = reinterpret_cast<Block*>(h->base + off);
    if (b->size >= want) {
      uint64_t remainder = b->size - want;
      if (remainder >= sizeof(Block) + kAlign) {
        // split: tail remains free
        uint64_t tail_off = off + sizeof(Block) + want;
        Block* tail = reinterpret_cast<Block*>(h->base + tail_off);
        tail->size = remainder - sizeof(Block);
        tail->next_off = b->next_off;
        b->size = want;
        if (prev_off) {
          reinterpret_cast<Block*>(h->base + prev_off)->next_off = tail_off;
        } else {
          hdr->free_head = tail_off;
        }
      } else {
        if (prev_off) {
          reinterpret_cast<Block*>(h->base + prev_off)->next_off = b->next_off;
        } else {
          hdr->free_head = b->next_off;
        }
      }
      hdr->used_bytes += b->size;
      return off + sizeof(Block);  // payload offset
    }
    prev_off = off;
    off = b->next_off;
  }
  return 0;
}

void free_block(Handle* h, uint64_t payload_off) {
  Header* hdr = h->hdr;
  uint64_t off = payload_off - sizeof(Block);
  Block* b = reinterpret_cast<Block*>(h->base + off);
  hdr->used_bytes -= b->size;
  // address-ordered insert + coalesce with neighbours
  uint64_t prev_off = 0;
  uint64_t cur = hdr->free_head;
  while (cur && cur < off) {
    prev_off = cur;
    cur = reinterpret_cast<Block*>(h->base + cur)->next_off;
  }
  b->next_off = cur;
  if (prev_off) {
    Block* prev = reinterpret_cast<Block*>(h->base + prev_off);
    prev->next_off = off;
    // coalesce prev+b
    if (prev_off + sizeof(Block) + prev->size == off) {
      prev->size += sizeof(Block) + b->size;
      prev->next_off = b->next_off;
      b = prev;
      off = prev_off;
    }
  } else {
    hdr->free_head = off;
  }
  // coalesce b+next
  if (b->next_off && off + sizeof(Block) + b->size == b->next_off) {
    Block* next = reinterpret_cast<Block*>(h->base + b->next_off);
    b->size += sizeof(Block) + next->size;
    b->next_off = next->next_off;
  }
}

}  // namespace

extern "C" {

// Open (creating if needed) an arena file with `capacity` data bytes and
// an index sized for `max_objects`. Returns an opaque handle or null.
void* rts_open(const char* path, uint64_t capacity, uint32_t max_objects) {
  if (capacity == 0 || max_objects == 0) return nullptr;
  uint64_t index_bytes = align_up(sizeof(Slot) * uint64_t(max_objects));
  uint64_t data_start = align_up(sizeof(Header)) + index_bytes;
  uint64_t total = data_start + capacity;

  int fd = open(path, O_RDWR | O_CREAT, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  bool fresh = st.st_size == 0;
  if (fresh && ftruncate(fd, int64_t(total)) != 0) {
    close(fd);
    return nullptr;
  }
  if (!fresh) total = uint64_t(st.st_size);

  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;

  Handle* h = new Handle();
  h->base = static_cast<uint8_t*>(mem);
  h->map_len = total;
  h->hdr = reinterpret_cast<Header*>(h->base);
  h->slots = reinterpret_cast<Slot*>(h->base + align_up(sizeof(Header)));

  if (fresh) {
    Header* hdr = h->hdr;
    hdr->capacity = capacity;
    hdr->data_start = data_start;
    hdr->num_slots = max_objects;
    hdr->used_bytes = 0;
    hdr->num_objects = 0;
    // one big free block
    Block* b = reinterpret_cast<Block*>(h->base + data_start);
    b->size = capacity - sizeof(Block);
    b->next_off = 0;
    hdr->free_head = data_start;
    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&hdr->mu, &attr);
    pthread_mutexattr_destroy(&attr);
    __atomic_store_n(&hdr->magic, kMagic, __ATOMIC_RELEASE);
  } else {
    // wait for another opener's initialization to become visible
    for (int i = 0; i < 1000000; i++) {
      if (__atomic_load_n(&h->hdr->magic, __ATOMIC_ACQUIRE) == kMagic) break;
    }
    if (h->hdr->magic != kMagic) {
      munmap(mem, total);
      delete h;
      return nullptr;
    }
  }
  return h;
}

void rts_close(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  if (!h) return;
  munmap(h->base, h->map_len);
  delete h;
}

// Allocate space for an object; returns the arena OFFSET of the writable
// payload, or 0 on failure (exists / out of space / index full).
uint64_t rts_create(void* handle, const uint8_t* id, uint64_t size) {
  Handle* h = static_cast<Handle*>(handle);
  Lock lock(h->hdr);
  if (find_slot(h, id, /*want_sealed=*/false)) return 0;
  Slot* s = claim_slot(h, id);
  if (!s) return 0;
  uint64_t payload = alloc_block(h, size ? size : 1);
  if (!payload) {
    s->state = kFree;  // probe_live stays 1: keeps chains intact
    h->hdr->tombstones++;
    return 0;
  }
  s->offset = payload;
  s->size = size;
  s->refs = 0;
  __atomic_store_n(&s->state, kCreating, __ATOMIC_RELEASE);
  h->hdr->num_objects++;
  return payload;
}

int rts_seal(void* handle, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(handle);
  Lock lock(h->hdr);
  Slot* s = find_slot(h, id, false);
  if (!s || s->state != kCreating) return -1;
  __atomic_store_n(&s->state, kSealed, __ATOMIC_RELEASE);
  return 0;
}

// Look up a sealed object; fills offset+size and takes a reader PIN
// (caller must balance with rts_release). Returns 0 on hit, -1 miss.
int rts_get(void* handle, const uint8_t* id, uint64_t* offset,
            uint64_t* size) {
  Handle* h = static_cast<Handle*>(handle);
  Lock lock(h->hdr);
  Slot* s = find_slot(h, id, /*want_sealed=*/true);
  if (!s) return -1;
  s->refs++;
  *offset = s->offset;
  *size = s->size;
  return 0;
}

// Drop one reader pin. `offset` (from the matching rts_get) names the
// exact BLOCK: an id alone is ambiguous once an object is overwritten
// while pinned (old zombie generation + new sealed generation share the
// id, and freeing the wrong one would corrupt the other's readers).
// The last release of a zombie frees its block. Returns 0, or -1 if no
// pinned slot matches.
int rts_release(void* handle, const uint8_t* id, uint64_t offset) {
  Handle* h = static_cast<Handle*>(handle);
  Lock lock(h->hdr);
  uint32_t n = h->hdr->num_slots;
  uint64_t idx = hash_id(id) % n;
  for (uint32_t probes = 0; probes < n; probes++) {
    Slot* s = &h->slots[(idx + probes) % n];
    if (s->state == kFree && !s->probe_live) break;
    if (s->state != kFree && s->offset == offset && s->refs > 0 &&
        memcmp(s->id, id, kIdBytes) == 0) {
      s->refs--;
      if (s->state == kZombie && s->refs == 0) {
        free_block(h, s->offset);
        s->state = kFree;
        h->hdr->tombstones++;
        maybe_rehash(h);
      }
      return 0;
    }
  }
  return -1;
}

int rts_contains(void* handle, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(handle);
  Lock lock(h->hdr);
  return find_slot(h, id, true) ? 1 : 0;
}

// Delete (sealed or aborted) object. Unpinned: frees the block now.
// Pinned: becomes a zombie — invisible immediately, block freed by the
// last rts_release. Returns the object's (logical) size either way.
uint64_t rts_delete(void* handle, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(handle);
  Lock lock(h->hdr);
  Slot* s = find_slot(h, id, false);
  if (!s || s->state == kFree) return 0;
  uint64_t freed = s->size;
  h->hdr->num_objects--;
  if (s->refs > 0) {
    __atomic_store_n(&s->state, kZombie, __ATOMIC_RELEASE);
    return freed;
  }
  free_block(h, s->offset);
  s->state = kFree;  // probe_live stays 1 so longer chains keep working
  h->hdr->tombstones++;
  maybe_rehash(h);
  return freed;
}

void rts_stats(void* handle, uint64_t* capacity, uint64_t* used,
               uint64_t* num_objects) {
  Handle* h = static_cast<Handle*>(handle);
  Lock lock(h->hdr);
  *capacity = h->hdr->capacity;
  *used = h->hdr->used_bytes;
  *num_objects = h->hdr->num_objects;
}

// Base pointer of the mapping (Python builds zero-copy memoryviews from
// base+offset).
uint8_t* rts_base(void* handle) {
  return static_cast<Handle*>(handle)->base;
}

uint64_t rts_map_len(void* handle) {
  return static_cast<Handle*>(handle)->map_len;
}

}  // extern "C"
