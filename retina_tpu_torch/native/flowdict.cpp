// Persistent flow-descriptor dictionary: descriptor -> stable slot id.
//
// The C++ twin of retina_tpu/parallel/flowdict.py (see that module for
// the wire-v2 contract and the kernel-map analogy). The Python dict
// version costs a per-row interpreter loop under the GIL (~100-300 ms
// per 150k-row production quantum on a 1-core agent box — a serial tax
// on the feed path); this version is one GIL-released pass over an open
// addressing table of resident descriptors.
//
// Must stay semantically identical to HostFlowDict — the test suite
// cross-checks the two on random batches:
// - ids are assigned in row order starting at 1 (0 = overflow sentinel);
// - a batch that would overflow capacity clears the table first
//   (generation bump) IF clearing lets it fit; descriptors beyond
//   capacity get sentinel id 0 with is_new=1;
// - repeats within a batch resolve to the id just assigned.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int NUM_FIELDS = 16;
// Descriptor columns (combine.py KEY_COLS order is irrelevant here as
// long as hashing/compare agree internally — but keep the combiner's
// set: everything except TS_LO/TS_HI/BYTES/PACKETS).
constexpr int KEY_COLS[12] = {2, 3, 4, 5, 8, 9, 10, 11, 12, 13, 14, 15};
constexpr int KEY_LEN = 12;

// The extracted key is contiguous: hash it as six u64 words (half the
// mix rounds of the per-column loop; this probe sits on the per-quantum
// feed path).
inline uint64_t hash_desc(const uint32_t* key) {
  uint64_t h = 0x9E3779B97F4A7C15ull, v;
  for (int i = 0; i < KEY_LEN / 2; i++) {
    memcpy(&v, key + 2 * i, 8);
    h ^= v;
    h *= 0xFF51AFD7ED558CCDull;
    h ^= h >> 33;
  }
  return h;
}

struct Slot {
  uint32_t key[KEY_LEN];
  uint32_t id;  // 0 = empty
};

struct FlowDict {
  Slot* slots;
  size_t n_slots;  // power of two >= 2*capacity
  size_t mask;
  uint32_t capacity;  // max assignable id is capacity-1
  uint32_t count;     // descriptors resident
  uint32_t generation;
};

inline void extract_key(const uint32_t* row, uint32_t* key) {
  for (int i = 0; i < KEY_LEN; i++) key[i] = row[KEY_COLS[i]];
}

inline bool key_eq(const uint32_t* a, const uint32_t* b) {
  return memcmp(a, b, KEY_LEN * sizeof(uint32_t)) == 0;
}

// Find the slot holding `key`, or the empty slot where it belongs.
inline Slot* probe(FlowDict* d, const uint32_t* key, uint64_t h) {
  size_t s = h & d->mask;
  for (;;) {
    Slot* sl = &d->slots[s];
    if (sl->id == 0 || key_eq(sl->key, key)) return sl;
    s = (s + 1) & d->mask;
  }
}

}  // namespace

extern "C" {

void* rt_flowdict_new(uint32_t capacity) {
  FlowDict* d = (FlowDict*)malloc(sizeof(FlowDict));
  if (!d) return nullptr;
  size_t slots = 16;
  while (slots < 2 * (size_t)capacity) slots <<= 1;
  d->slots = (Slot*)calloc(slots, sizeof(Slot));
  if (!d->slots) {
    free(d);
    return nullptr;
  }
  d->n_slots = slots;
  d->mask = slots - 1;
  d->capacity = capacity;
  d->count = 0;
  d->generation = 0;
  return d;
}

void rt_flowdict_free(void* h) {
  if (!h) return;
  FlowDict* d = (FlowDict*)h;
  free(d->slots);
  free(d);
}

void rt_flowdict_clear(void* h) {
  FlowDict* d = (FlowDict*)h;
  memset(d->slots, 0, d->n_slots * sizeof(Slot));
  d->count = 0;
  d->generation++;
}

uint32_t rt_flowdict_len(void* h) { return ((FlowDict*)h)->count; }

uint32_t rt_flowdict_generation(void* h) {
  return ((FlowDict*)h)->generation;
}

// rows: (n, 16) u32 row-major. ids: out (n,) u32. is_new: out (n,) u8.
// Returns the generation AFTER the call (a bump means the table
// cleared before assignment).
uint32_t rt_flowdict_assign(void* h, const uint32_t* rows, size_t n,
                            uint32_t* ids, uint8_t* is_new) {
  FlowDict* d = (FlowDict*)h;
  // Overflow pre-check (HostFlowDict contract): clearing mid-batch
  // would hand out known-ids the new generation never assigned.
  if ((size_t)d->count + n > d->capacity) {
    size_t fresh = 0;
    uint32_t key[KEY_LEN];
    // Count batch-distinct unseen descriptors with a throwaway pass:
    // mark seen-in-batch by probing the main table WITHOUT inserting,
    // plus a scratch table for intra-batch repeats.
    size_t sslots = 16;
    while (sslots < 2 * n) sslots <<= 1;
    Slot* scratch = (Slot*)calloc(sslots, sizeof(Slot));
    if (scratch) {
      const size_t smask = sslots - 1;
      for (size_t i = 0; i < n; i++) {
        extract_key(rows + i * NUM_FIELDS, key);
        uint64_t hh = hash_desc(key);
        Slot* main = probe(d, key, hh);
        if (main->id != 0) continue;  // already resident
        size_t s = hh & smask;
        for (;;) {
          Slot* sl = &scratch[s];
          if (sl->id == 0) {
            memcpy(sl->key, key, sizeof(key));
            sl->id = 1;
            fresh++;
            break;
          }
          if (key_eq(sl->key, key)) break;
          s = (s + 1) & smask;
        }
      }
      free(scratch);
      if ((size_t)d->count + fresh > d->capacity) rt_flowdict_clear(h);
    } else {
      rt_flowdict_clear(h);  // allocation pressure: degrade safely
    }
  }
  uint32_t key[KEY_LEN];
  for (size_t i = 0; i < n; i++) {
    extract_key(rows + i * NUM_FIELDS, key);
    Slot* sl = probe(d, key, hash_desc(key));
    if (sl->id != 0) {
      ids[i] = sl->id;
      is_new[i] = 0;
      continue;
    }
    is_new[i] = 1;
    uint32_t next = d->count + 1;  // ids start at 1
    if (next < d->capacity) {
      memcpy(sl->key, key, sizeof(key));
      sl->id = next;
      d->count = next;
      ids[i] = next;
    } else {
      ids[i] = 0;  // overflow sentinel: ships as a table-less full row
    }
  }
  return d->generation;
}

}  // extern "C"
