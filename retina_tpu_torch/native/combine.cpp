// Host-side record combiner: RLE of identical flow descriptors.
//
// The C++ twin of retina_tpu/parallel/combine.py (see that module for the
// losslessness contract and the eBPF-map analogy). One pass, open
// addressing: hash the 12 descriptor columns, probe, and either claim an
// output row or accumulate PACKETS/BYTES (saturating) and take the later
// timestamp. Order of first appearance is preserved, which the Python
// fallback does NOT guarantee (it sorts); consumers treat row order as
// arbitrary.
//
// Must stay semantically identical to combine_records_numpy — the test
// suite cross-checks the two on random batches.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>

namespace {

constexpr int NUM_FIELDS = 16;
// Field indices (retina_tpu/events/schema.py).
constexpr int F_TS_LO = 0, F_TS_HI = 1, F_BYTES = 6, F_PACKETS = 7;
// Descriptor columns: everything except TS_LO/TS_HI/BYTES/PACKETS.
constexpr int KEY_COLS[12] = {2, 3, 4, 5, 8, 9, 10, 11, 12, 13, 14, 15};

// The 12 key columns form two contiguous spans (2..5 and 8..15):
// hashing/comparing them as six unaligned u64 words halves the per-row
// mix rounds vs the per-column loop — this pass is the host feed path's
// single largest cost at production quanta.
inline uint64_t hash_row(const uint32_t* row) {
  uint64_t h = 0x9E3779B97F4A7C15ull, v;
  const char* p = (const char*)(row + 2);
  for (int i = 0; i < 2; i++) {
    memcpy(&v, p + 8 * i, 8);
    h ^= v;
    h *= 0xFF51AFD7ED558CCDull;
    h ^= h >> 33;
  }
  p = (const char*)(row + 8);
  for (int i = 0; i < 4; i++) {
    memcpy(&v, p + 8 * i, 8);
    h ^= v;
    h *= 0xFF51AFD7ED558CCDull;
    h ^= h >> 33;
  }
  return h;
}

inline bool keys_equal(const uint32_t* a, const uint32_t* b) {
  return memcmp(a + 2, b + 2, 4 * sizeof(uint32_t)) == 0 &&
         memcmp(a + 8, b + 8, 8 * sizeof(uint32_t)) == 0;
}

inline uint32_t sat_add_u32(uint32_t a, uint32_t b) {
  uint64_t s = (uint64_t)a + b;
  return s > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)s;
}

// Which of n_stripes key-partitions a row belongs to. Uses the UPPER
// hash bits (the table index burns the lower ones — reusing them would
// collapse each stripe's slot distribution) via a multiply-shift range
// map, so any n_stripes works without a per-row divide.
inline uint32_t stripe_of(uint64_t h, uint32_t n_stripes) {
  return (uint32_t)(((uint64_t)(uint32_t)(h >> 32) * n_stripes) >> 32);
}

}  // namespace

extern "C" {

// rows: (n, 16) u32 row-major. out: caller buffer with room for n rows.
// Returns the number of combined rows written to out, or -1 on alloc
// failure. out may alias nothing (distinct buffer required).
//
// hint_slots (rt_combine_hint): expected table size from the caller's
// previous quantum — distinct-flow counts are stable flush over flush,
// and a table sized to the distinct count stays cache-resident where
// the worst-case 2n sizing (16 MB at production quanta) probes cold
// RAM. 0 means no hint (worst-case sizing, the old behavior). When a
// hint undershoots, the table doubles and re-inserts the g combined
// rows seen so far (cheap: g << n), so results are identical for any
// hint.
long rt_combine_multi(const uint32_t* const* blocks, const size_t* ns,
                      size_t nblocks, uint32_t* out, size_t hint_slots);

long rt_combine_hint(const uint32_t* rows, size_t n, uint32_t* out,
                     size_t hint_slots) {
  // One-block view of the multi-block core (single table body lives
  // in rt_combine_multi so a fix can never diverge between them).
  const uint32_t* blocks[1] = {rows};
  size_t ns[1] = {n};
  return rt_combine_multi(blocks, ns, 1, out, hint_slots);
}

// Multi-threaded combine for multi-core hosts: T contiguous chunks
// combined independently (each with its own table), then one
// sequential merge pass over the concatenated partials (G_total rows,
// ~n/ratio — cheap). Row order differs from the single-thread pass
// (chunk-major first-appearance); consumers treat order as arbitrary
// (see header). nthreads <= 1, tiny inputs, or any allocation failure
// fall back to the single-threaded pass — results are equivalent
// either way (cross-checked as key -> value maps by the test suite).
long rt_combine_mt(const uint32_t* rows, size_t n, uint32_t* out,
                   size_t hint_slots, unsigned nthreads) {
  constexpr size_t kMinPerThread = 1 << 15;
  if (nthreads > 16) nthreads = 16;
  if (nthreads <= 1 || n < 2 * kMinPerThread)
    return rt_combine_hint(rows, n, out, hint_slots);
  if ((size_t)nthreads > n / kMinPerThread)
    nthreads = (unsigned)(n / kMinPerThread);

  uint32_t* scratch =
      (uint32_t*)malloc(n * NUM_FIELDS * sizeof(uint32_t));
  if (!scratch) return rt_combine_hint(rows, n, out, hint_slots);
  long* counts = (long*)malloc(nthreads * sizeof(long));
  if (!counts) {
    free(scratch);
    return rt_combine_hint(rows, n, out, hint_slots);
  }

  size_t chunk = n / nthreads;
  size_t per_hint = hint_slots ? hint_slots / nthreads : 0;
  // Spawn-per-call is fine at these sizes: threading only engages at
  // >= 64k rows, where create+join (tens of us) is <0.1% of the pass.
  // std::thread construction can throw (EAGAIN under pid-limit
  // pressure) — that must become the single-threaded fallback, never
  // an exception across the extern "C" boundary (std::terminate).
  std::thread workers[16];
  unsigned spawned = 0;
  try {
    for (unsigned t = 0; t < nthreads; t++) {
      size_t lo = t * chunk;
      size_t hi = (t == nthreads - 1) ? n : lo + chunk;
      workers[t] = std::thread([=]() {
        counts[t] = rt_combine_hint(rows + lo * NUM_FIELDS, hi - lo,
                                    scratch + lo * NUM_FIELDS, per_hint);
      });
      spawned++;
    }
  } catch (...) {
    for (unsigned t = 0; t < spawned; t++) workers[t].join();
    free(counts);
    free(scratch);
    return rt_combine_hint(rows, n, out, hint_slots);
  }
  for (unsigned t = 0; t < nthreads; t++) workers[t].join();

  bool failed = false;
  size_t total = 0;
  for (unsigned t = 0; t < nthreads; t++) {
    if (counts[t] < 0) failed = true;
    else total += (size_t)counts[t];
  }
  long g = -1;
  if (!failed) {
    // Compact the partials to one contiguous run, then merge. The
    // compaction reuses scratch in place (partials are in ascending
    // offsets, so memmove is safe front to back).
    size_t off = 0;
    for (unsigned t = 0; t < nthreads; t++) {
      size_t lo = t * chunk;
      size_t cnt = (size_t)counts[t];
      if (off != lo && cnt)
        memmove(scratch + off * NUM_FIELDS, scratch + lo * NUM_FIELDS,
                cnt * NUM_FIELDS * sizeof(uint32_t));
      off += cnt;
    }
    g = rt_combine_hint(scratch, total, out, hint_slots);
  }
  free(counts);
  free(scratch);
  if (g < 0) return rt_combine_hint(rows, n, out, hint_slots);
  return g;
}

long rt_combine(const uint32_t* rows, size_t n, uint32_t* out) {
  return rt_combine_hint(rows, n, out, 0);
}

// The one table body behind every combine entry point (single-block,
// multi-block, striped) — a fix can never diverge between them.
// stripe/n_stripes: with n_stripes > 1, only rows whose key hashes into
// the given stripe (stripe_of) are combined; the rest are skipped. Key
// partitioning makes concurrent striped calls over the SAME blocks
// write disjoint flow sets — the multi-consumer combine crew needs no
// cross-worker merge pass and no locks (each worker owns its out
// buffer; the input blocks are read-only).
static long combine_core(const uint32_t* const* blocks, const size_t* ns,
                         size_t nblocks, uint32_t* out, size_t hint_slots,
                         uint32_t stripe, uint32_t n_stripes) {
  size_t n = 0;
  for (size_t b = 0; b < nblocks; b++) n += ns[b];
  if (n == 0) return 0;
  size_t worst = 16;
  while (worst < 2 * n) worst <<= 1;
  size_t slots = worst;
  if (hint_slots) {
    slots = 1024;
    while (slots < hint_slots && slots < worst) slots <<= 1;
    if (slots > worst) slots = worst;
  }
  uint32_t* table = (uint32_t*)malloc(slots * sizeof(uint32_t));
  if (!table) return -1;
  memset(table, 0xFF, slots * sizeof(uint32_t));
  size_t mask = slots - 1;
  size_t g = 0;
  for (size_t b = 0; b < nblocks; b++) {
    const uint32_t* rows = blocks[b];
    size_t nb = ns[b];
    // Per-block prefetch pipeline (blocks are thousands of rows; the
    // ~kAhead ramp cost per boundary is noise).
    constexpr size_t kAhead = 8;
    size_t next_hashes[kAhead];
    for (size_t i = 0; i < nb && i < kAhead; i++) {
      next_hashes[i] = hash_row(rows + i * NUM_FIELDS);
      __builtin_prefetch(&table[next_hashes[i] & mask]);
    }
    for (size_t i = 0; i < nb; i++) {
      const uint32_t* row = rows + i * NUM_FIELDS;
      size_t h_i = next_hashes[i % kAhead];
      size_t slot = h_i & mask;
      if (i + kAhead < nb) {
        size_t h = hash_row(rows + (i + kAhead) * NUM_FIELDS);
        next_hashes[(i + kAhead) % kAhead] = h;
        __builtin_prefetch(&table[h & mask]);
      }
      if (n_stripes > 1 && stripe_of(h_i, n_stripes) != stripe) continue;
      if (2 * g >= slots && slots < worst) {
        size_t nslots = slots << 1;
        uint32_t* ntable = (uint32_t*)malloc(nslots * sizeof(uint32_t));
        if (!ntable) {
          free(table);
          return -1;
        }
        memset(ntable, 0xFF, nslots * sizeof(uint32_t));
        size_t nmask = nslots - 1;
        for (size_t j = 0; j < g; j++) {
          size_t s = hash_row(out + j * NUM_FIELDS) & nmask;
          while (ntable[s] != 0xFFFFFFFFu) s = (s + 1) & nmask;
          ntable[s] = (uint32_t)j;
        }
        free(table);
        table = ntable;
        slots = nslots;
        mask = nmask;
        slot = hash_row(row) & mask;
      }
      for (;;) {
        uint32_t gid = table[slot];
        if (gid == 0xFFFFFFFFu) {
          table[slot] = (uint32_t)g;
          memcpy(out + g * NUM_FIELDS, row,
                 NUM_FIELDS * sizeof(uint32_t));
          g++;
          break;
        }
        uint32_t* orow = out + (size_t)gid * NUM_FIELDS;
        if (keys_equal(orow, row)) {
          orow[F_PACKETS] = sat_add_u32(orow[F_PACKETS], row[F_PACKETS]);
          orow[F_BYTES] = sat_add_u32(orow[F_BYTES], row[F_BYTES]);
          uint64_t ots =
              ((uint64_t)orow[F_TS_HI] << 32) | orow[F_TS_LO];
          uint64_t nts = ((uint64_t)row[F_TS_HI] << 32) | row[F_TS_LO];
          if (nts > ots) {
            orow[F_TS_LO] = row[F_TS_LO];
            orow[F_TS_HI] = row[F_TS_HI];
          }
          break;
        }
        slot = (slot + 1) & mask;
      }
    }
  }
  free(table);
  return (long)g;
}

// Multi-block combine: same single-pass table as rt_combine_hint but
// consuming a LIST of row blocks — the feed loop's flush quantum is a
// list of sink blocks, and concatenating them first costs a full
// row-copy pass (~40% of the combine stage at production quanta).
// First-appearance output order matches exactly what rt_combine_hint
// would produce on the concatenation, so results are bit-identical
// (cross-checked by the test suite).
long rt_combine_multi(const uint32_t* const* blocks, const size_t* ns,
                      size_t nblocks, uint32_t* out, size_t hint_slots) {
  return combine_core(blocks, ns, nblocks, out, hint_slots, 0, 1);
}

// Striped multi-consumer combine: combine ONLY the rows of one key
// partition (stripe of n_stripes, see stripe_of). T concurrent callers
// over the same blocks with stripes 0..T-1 produce disjoint flow sets
// whose concatenation equals rt_combine_multi's output as a key->value
// map (first-appearance order is per-stripe). This is the per-worker
// partitioned combine of the feed pool's combine crew: unlike
// rt_combine_mt's chunk+sequential-merge, there is NO merge pass and no
// shared mutable state — each worker scans all rows but hashes/probes
// only its own stripe's, so the expensive part (table writes, output
// row copies) parallelizes perfectly.
long rt_combine_stripe(const uint32_t* const* blocks, const size_t* ns,
                       size_t nblocks, uint32_t* out, size_t hint_slots,
                       uint32_t stripe, uint32_t n_stripes) {
  if (n_stripes <= 1)
    return combine_core(blocks, ns, nblocks, out, hint_slots, 0, 1);
  if (stripe >= n_stripes) return 0;
  return combine_core(blocks, ns, nblocks, out, hint_slots, stripe,
                      n_stripes);
}

}  // extern "C"
