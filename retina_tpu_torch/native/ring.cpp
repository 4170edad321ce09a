// Shared-memory SPSC event ring — the perf-ring analog, in C++.
//
// Reference analog: the kernel→user perf event array
// (packetparser.c:19-21, 16,384 entries; read loop
// packetparser_linux.go:669-698): a bounded, never-blocking ring where
// overflow drops are counted, not waited on. This ring lives in a caller-
// provided memory region (heap or mmap'd shm file), so a C++/Go producer
// process can feed the Python agent — or plugin threads can bypass the
// GIL'd queue — with zero copies beyond the record write.
//
// Single-producer/single-consumer, acquire/release atomics, fixed-width
// records (NUM_FIELDS u32 = 64 B, cacheline-sized like the reference's
// perf records). C ABI via ctypes. Build: make -C retina_tpu/native
#include <atomic>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kMagic = 0x52544E52;  // "RTNR"

struct alignas(64) Header {
  uint32_t magic;
  uint32_t record_words;  // u32 lanes per record
  uint64_t capacity;      // record slots (power of two)
  alignas(64) std::atomic<uint64_t> head;     // writer position
  alignas(64) std::atomic<uint64_t> tail;     // reader position
  alignas(64) std::atomic<uint64_t> dropped;  // producer-side losses
};

inline Header* hdr(void* mem) { return static_cast<Header*>(mem); }
inline uint32_t* slots(void* mem) {
  return reinterpret_cast<uint32_t*>(static_cast<uint8_t*>(mem) +
                                     sizeof(Header));
}

}  // namespace

extern "C" {

// Bytes needed for a ring of `capacity` records (capacity: power of two).
size_t rt_ring_bytes(uint64_t capacity, uint32_t record_words) {
  return sizeof(Header) + capacity * record_words * sizeof(uint32_t);
}

// Initialize a ring in caller-provided zeroed memory. Returns 0 on
// success, -1 on bad capacity (not a power of two).
int rt_ring_init(void* mem, uint64_t capacity, uint32_t record_words) {
  if (capacity == 0 || (capacity & (capacity - 1))) return -1;
  Header* h = hdr(mem);
  h->magic = kMagic;
  h->record_words = record_words;
  h->capacity = capacity;
  h->head.store(0, std::memory_order_relaxed);
  h->tail.store(0, std::memory_order_relaxed);
  h->dropped.store(0, std::memory_order_relaxed);
  return 0;
}

// Validate an existing ring (attach from another process). 0 = ok.
int rt_ring_check(void* mem, uint32_t record_words) {
  Header* h = hdr(mem);
  if (h->magic != kMagic || h->record_words != record_words) return -1;
  return 0;
}

// Push n records; returns how many were accepted (rest dropped+counted —
// the never-block rule, packetparser_linux.go:692-697).
uint64_t rt_ring_push(void* mem, const uint32_t* records, uint64_t n) {
  Header* h = hdr(mem);
  const uint64_t cap = h->capacity;
  const uint32_t w = h->record_words;
  uint64_t head = h->head.load(std::memory_order_relaxed);
  const uint64_t tail = h->tail.load(std::memory_order_acquire);
  uint64_t free_slots = cap - (head - tail);
  uint64_t take = n < free_slots ? n : free_slots;
  uint32_t* base = slots(mem);
  // At most two contiguous spans (pre/post wrap): one memcpy per span
  // instead of one per record — the per-record call overhead dominated
  // at staged-block sizes (thousands of 64 B records per push).
  uint64_t start = head & (cap - 1);
  uint64_t first = take < cap - start ? take : cap - start;
  std::memcpy(base + start * w, records, first * w * sizeof(uint32_t));
  if (take > first)
    std::memcpy(base, records + first * w,
                (take - first) * w * sizeof(uint32_t));
  h->head.store(head + take, std::memory_order_release);
  if (take < n)
    h->dropped.fetch_add(n - take, std::memory_order_relaxed);
  return take;
}

// Pop up to max records into out; returns how many were read.
uint64_t rt_ring_pop(void* mem, uint32_t* out, uint64_t max) {
  Header* h = hdr(mem);
  const uint64_t cap = h->capacity;
  const uint32_t w = h->record_words;
  uint64_t tail = h->tail.load(std::memory_order_relaxed);
  const uint64_t head = h->head.load(std::memory_order_acquire);
  uint64_t avail = head - tail;
  uint64_t take = max < avail ? max : avail;
  uint32_t* base = slots(mem);
  // Mirror of the push path: at most two span memcpys per pop.
  uint64_t start = tail & (cap - 1);
  uint64_t first = take < cap - start ? take : cap - start;
  std::memcpy(out, base + start * w, first * w * sizeof(uint32_t));
  if (take > first)
    std::memcpy(out + first * w, base,
                (take - first) * w * sizeof(uint32_t));
  h->tail.store(tail + take, std::memory_order_release);
  return take;
}

uint64_t rt_ring_size(void* mem) {
  Header* h = hdr(mem);
  return h->head.load(std::memory_order_acquire) -
         h->tail.load(std::memory_order_acquire);
}

uint64_t rt_ring_dropped(void* mem) {
  return hdr(mem)->dropped.load(std::memory_order_relaxed);
}

}  // extern "C"
