// K7: the engine's ingest programs, which turn the host-to-card wire back
// into the step's (capacity, 16) record windows.
//
// Replaces retina_tpu/engine.py:1052 _ingest_fn (engine.ingest: unpack
// the 12-lane packed wire, parallel/wire.py:279 unpack_records_device, or
// copy 16 lanes), :1205 _ingest_new_fn (engine.ingest_new: scatter the new
// descriptors' lanes into the card's descriptor table, then unpack) and
// :1275 _ingest_known_fn (engine.ingest_known: decode the v4 dense stream,
// wire.py:160 dense_known_unpack_device, or the v3 two-lane rows, gather
// each row's descriptor from the table, overlay TS_REL, BYTES and PACKETS,
// then unpack). Each writes the whole (n_win * capacity, 16) buffer of
// windows: rows past the wire's bucket are zero, as the reference's
// jnp.pad makes them. The plain versions are parallel/wire.py
// ingest_packed_plain, ingest_new_plain and ingest_known_plain.
//
// Bound on the H100: bytes. Each row reads its wire row (48, 52, or 8 /
// (id_bits + 32) / 8 bytes) and writes a 64-byte record; the known side
// reads each distinct descriptor (48 bytes at a 48-byte stride: two
// sectors), the new side writes each distinct id's descriptor and its
// claim word. The integer work is a few shifts a lane.
//
// Design: a block walks tiles of 256 rows. It stages the tile's wire span
// (contiguous, 16-byte aligned: 12,288 bytes packed, 13,312 new, 8 x
// (id_bits + 32) + 1 words dense, 2,048 two-lane) in shared memory with
// 16-byte loads, neighbouring threads on neighbouring addresses, all of a
// thread's loads in flight before it stores any. Thread t then writes the
// 16-byte part t & 3 of rows t / 4, t / 4 + 64, ..., so that a warp's
// store covers 512 contiguous bytes of records; the zero tail is written
// the same way, and the 16-lane wire is a straight tile copy.
//
// The known side decodes a tile's (id, packets, bytes) from the staged
// stream, then gathers each row's descriptor as three 16-byte loads, three
// threads a row and three rows a thread, every load issued before any is
// stored, and overlays the row's lanes in shared memory before the unpack.
//
// The new side's repeated ids: escalated rows re-send a resident
// descriptor and every padding or table-less row names the sacrificial
// slot 0, so an id repeats within a wire, and the last row in batch order
// wins. Launch 1 writes a tile's records first, then finds each id's last
// row within each warp (__match_any_sync) and takes one atomicMax of
// (row + 1) per distinct id a warp into a scratch array that is zero
// between calls; for id 0, the sentinel that padding names, the warps'
// last rows meet in one shared word first, so a tile of padding claims
// slot 0 once, not 256 times. Launch 2 lets only the row holding its id's
// claim write the slot and clear the claim. Ids past the table are
// dropped on the new side and read the last slot on the known side.
#include "hash.cuh"

namespace {

constexpr int kPacked = 12;
constexpr int kTile = 256;     // rows a tile
constexpr int kThreads = 256;  // threads a block: 4 output rows a thread
constexpr int kBlocksPerSm = 4;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;  // never an id inside the table (slots < 2^32)

// Record lanes 4k .. 4k + 3 of a row from its 12 packed lanes p (wire.py's
// table; schema field order of retina_tpu_torch/events/schema.py).
__device__ __forceinline__ uint4 unpack_part(int k, const uint32_t* p, uint32_t base_lo,
                                             uint32_t base_hi) {
  if (k == 0) {  // TS_LO, TS_HI, SRC_IP, DST_IP
    const uint32_t rel = p[0];
    const uint32_t relm1 = rel - 1u;  // wraps for rel == 0; masked below
    const uint32_t ts_lo = base_lo + relm1;
    const uint32_t carry = ts_lo < relm1 ? 1u : 0u;
    return make_uint4(rel ? ts_lo : 0u, rel ? base_hi + carry : 0u, p[1], p[2]);
  }
  if (k == 1) return make_uint4(p[3], p[4], p[5], p[6]);  // PORTS, META, BYTES, PACKETS
  const uint32_t misc = p[7];
  if (k == 2)  // VERDICT, DROP_REASON, TSVAL, TSECR
    return make_uint4(misc >> 29, (misc >> 21) & 0xFFu, p[8], p[9]);
  // DNS, DNS_QHASH, EVENT_TYPE, IFINDEX
  return make_uint4(p[10], p[11], (misc >> 17) & 0xFu, misc & 0x1FFFFu);
}

// Copy n_words u32 from src (16-byte aligned) to dst in shared memory:
// 16-byte loads, at most kPer a thread, all issued before the stores.
template <int kPer>
__device__ __forceinline__ void stage(uint32_t* __restrict__ dst,
                                      const uint32_t* __restrict__ src, int n_words) {
  const int n_vec = n_words >> 2;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  uint4 v[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int q = threadIdx.x + m * kThreads;
    if (q < n_vec) v[m] = __ldg(s4 + q);
  }
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int q = threadIdx.x + m * kThreads;
    if (q < n_vec) d4[q] = v[m];
  }
  const int q = (n_vec << 2) + threadIdx.x;
  if (q < n_words) dst[q] = __ldg(src + q);
}

// Write a tile's records: rows below nr unpacked from rows of `stride`
// words at s + lane0, the rest (to n_rows) zero. Thread t writes part
// t & 3 of rows t / 4 + 64 m.
__device__ __forceinline__ void write_tile(uint4* __restrict__ o, const uint32_t* s, int stride,
                                           int lane0, int nr, int n_rows, uint32_t base_lo,
                                           uint32_t base_hi) {
  const int k = threadIdx.x & 3;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = (threadIdx.x >> 2) + m * (kThreads / 4);
    if (r >= n_rows) break;
    o[4 * r + k] = r < nr ? unpack_part(k, s + r * stride + lane0, base_lo, base_hi)
                          : make_uint4(0u, 0u, 0u, 0u);
  }
}

struct Tile {
  long long r0;  // first row
  int nr;        // wire rows in the tile
  int n_rows;    // output rows in the tile
};

__device__ __forceinline__ Tile tile_at(long long t, long long bucket, long long n_out) {
  Tile tl;
  tl.r0 = t * kTile;
  const long long in = bucket - tl.r0, all = n_out - tl.r0;
  tl.nr = in <= 0 ? 0 : (in < kTile ? (int)in : kTile);
  tl.n_rows = all < kTile ? (int)all : kTile;
  return tl;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
packed_kernel(const uint32_t* __restrict__ wire, long long bucket, int packed, uint32_t base_lo,
              uint32_t base_hi, uint4* __restrict__ out, long long n_out) {
  __shared__ __align__(16) uint32_t s[kTile * kPacked];
  const long long n_tiles = (n_out + kTile - 1) / kTile;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Tile tl = tile_at(t, bucket, n_out);
    uint4* o = out + 4 * tl.r0;
    if (!packed) {  // 16 lanes: a straight copy of 4 x 16 bytes a row
      const uint4* w = reinterpret_cast<const uint4*>(wire) + 4 * tl.r0;
      uint4 v[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = threadIdx.x + m * kThreads;
        v[m] = j < 4 * tl.nr ? __ldg(w + j) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = threadIdx.x + m * kThreads;
        if (j < 4 * tl.n_rows) o[j] = v[m];
      }
      continue;
    }
    if (tl.nr > 0) {
      __syncthreads();  // the previous tile's reads of s are done
      stage<3>(s, wire + tl.r0 * kPacked, tl.nr * kPacked);
      __syncthreads();
    }
    write_tile(o, s, kPacked, 0, tl.nr, tl.n_rows, base_lo, base_hi);
  }
}

// New side, launch 1: every row unpacked, then the tile's claims (one
// atomicMax per distinct id a warp, for its last row; one for id 0 a
// tile).
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
new_claim_kernel(const uint32_t* __restrict__ wire, long long bucket, uint32_t slots,
                 uint32_t* __restrict__ winner, uint32_t base_lo, uint32_t base_hi,
                 uint4* __restrict__ out, long long n_out) {
  __shared__ __align__(16) uint32_t s[kTile * 13];
  __shared__ uint32_t last0;  // the tile's last row of id 0 (+ 1)
  const long long n_tiles = (n_out + kTile - 1) / kTile;
  const int lane = threadIdx.x & 31;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Tile tl = tile_at(t, bucket, n_out);
    if (tl.nr > 0) {
      __syncthreads();  // the previous tile's reads of s and last0 are done
      if (threadIdx.x == 0) last0 = 0u;
      stage<4>(s, wire + tl.r0 * 13, tl.nr * 13);
      __syncthreads();
      write_tile(out + 4 * tl.r0, s, 13, 1, tl.nr, tl.n_rows, base_lo, base_hi);
      const int r = threadIdx.x;
      const uint32_t id = r < tl.nr ? s[13 * r] : kEmpty;
      // The warp's rows of one id, and the last of them (the highest lane).
      const unsigned same = __match_any_sync(0xFFFFFFFFu, id);
      if (id < slots && lane == 31 - __clz(same)) {
        if (id == 0u)
          atomicMax(&last0, (uint32_t)r + 1u);
        else
          atomicMax(winner + id, (uint32_t)(tl.r0 + r) + 1u);
      }
      __syncthreads();
      if (threadIdx.x == 0 && last0) atomicMax(winner, (uint32_t)tl.r0 + last0);
    } else {
      write_tile(out + 4 * tl.r0, s, 13, 1, 0, tl.n_rows, base_lo, base_hi);
    }
  }
}

// New side, launch 2: the row holding its id's claim writes the slot and
// clears the claim. A losing row reads either the winner's claim or 0,
// never its own.
__global__ void new_write_kernel(const uint32_t* __restrict__ wire, long long bucket,
                                 uint4* __restrict__ table, uint32_t slots,
                                 uint32_t* __restrict__ winner) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < bucket; i += stride) {
    const uint32_t* w = wire + 13 * i;
    const uint32_t id = __ldg(w);
    if (id >= slots || winner[id] != (uint32_t)(i + 1)) continue;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      table[3 * (size_t)id + k] = make_uint4(__ldg(w + 1 + 4 * k), __ldg(w + 2 + 4 * k),
                                             __ldg(w + 3 + 4 * k), __ldg(w + 4 + 4 * k));
    winner[id] = 0u;
  }
}

// Known side: decode a tile's (id, packets, bytes), gather and overlay its
// descriptors, unpack.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
known_kernel(const uint32_t* __restrict__ wire, long long bucket, int dense, int id_bits,
             const uint4* __restrict__ table, uint32_t slots, uint32_t ts_rel, uint32_t base_lo,
             uint32_t base_hi, uint4* __restrict__ out, long long n_out) {
  // A tile's stream: 8 x rb + 1 words dense (rb <= 64), 2 x 256 two-lane.
  __shared__ __align__(16) uint32_t sw[8 * 64 + 4];
  __shared__ __align__(16) uint32_t sd[kTile * kPacked];  // the tile's overlaid descriptors
  __shared__ uint32_t sid[kTile], spk[kTile], sby[kTile];
  const int rb = id_bits + 10 + 22;
  const uint32_t id_mask = id_bits >= 32 ? 0xFFFFFFFFu : (1u << id_bits) - 1u;
  const long long n_words = dense ? (bucket * rb + 31) / 32 + 1 : 2 * bucket;
  const long long n_tiles = (n_out + kTile - 1) / kTile;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Tile tl = tile_at(t, bucket, n_out);
    if (tl.nr > 0) {
      __syncthreads();  // the previous tile's reads of sw, sd and the lanes are done
      if (dense) {
        const long long w0 = tl.r0 / 32 * rb;  // whole words: r0 is a multiple of 256
        const long long left = n_words - w0;
        stage<1>(sw, wire + w0, (int)(left < 8 * rb + 1 ? left : 8 * rb + 1));
      } else {
        stage<1>(sw, wire + 2 * tl.r0, 2 * tl.nr);
      }
      __syncthreads();
      const int r = threadIdx.x;
      if (r < tl.nr) {
        uint32_t id, pk, by;
        if (dense) {
          // Each field is <= 32 bits, so two words hold it; a shift of 0
          // takes nothing from the upper word (the pad word keeps the last
          // row's read in bounds).
          uint32_t f[3];
          const int off[3] = {0, id_bits, id_bits + 10};
          const uint32_t mask[3] = {id_mask, (1u << 10) - 1u, (1u << 22) - 1u};
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const int p = r * rb + off[k];
            const int wi = p >> 5, sh = p & 31;
            const uint32_t lo = sw[wi] >> sh;
            const uint32_t up = sh ? sw[wi + 1] << (32 - sh) : 0u;
            f[k] = (lo | up) & mask[k];
          }
          id = f[0];
          pk = f[1];
          by = f[2];
        } else {
          const uint32_t w0 = sw[2 * r], w1 = sw[2 * r + 1];
          id = w0 & id_mask;
          pk = id_bits >= 32 ? 0u : w0 >> id_bits;
          by = w1;
        }
        sid[r] = id < slots ? id : slots - 1u;
        spk[r] = pk;
        sby[r] = by;
      }
      __syncthreads();
      // Three threads a row, one 16-byte part each; three parts a thread,
      // all loads issued first.
      uint4 v[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int u = threadIdx.x + m * kThreads;
        if (u < 3 * tl.nr) v[m] = __ldg(table + 3 * (size_t)sid[u / 3] + u % 3);
      }
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int u = threadIdx.x + m * kThreads;
        if (u >= 3 * tl.nr) break;
        const int row = u / 3, part = u % 3;
        if (part == 0) {
          v[m].x = ts_rel;  // lane 0: TS_REL
        } else if (part == 1) {
          v[m].y = sby[row];  // lane 5: BYTES
          v[m].z = spk[row];  // lane 6: PACKETS
        }
        reinterpret_cast<uint4*>(sd)[u] = v[m];
      }
      __syncthreads();
    }
    write_tile(out + 4 * tl.r0, sd, kPacked, 0, tl.nr, tl.n_rows, base_lo, base_hi);
  }
}

}  // namespace

extern "C" int ingest_packed(const void* wire, long long bucket, int packed, unsigned int base_lo,
                             unsigned int base_hi, void* out, long long n_out, void* stream) {
  packed_kernel<<<rt::grid_for(n_out, kTile), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wire), bucket, packed, base_lo, base_hi,
      static_cast<uint4*>(out), n_out);
  return (int)cudaGetLastError();
}

extern "C" int ingest_new(const void* wire, long long bucket, void* table, long long slots,
                          void* winner, unsigned int base_lo, unsigned int base_hi, void* out,
                          long long n_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* w = static_cast<const uint32_t*>(wire);
  uint32_t* win = static_cast<uint32_t*>(winner);
  new_claim_kernel<<<rt::grid_for(n_out, kTile), kThreads, 0, s>>>(
      w, bucket, (uint32_t)slots, win, base_lo, base_hi, static_cast<uint4*>(out), n_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  new_write_kernel<<<rt::grid_for(bucket, kThreads), kThreads, 0, s>>>(
      w, bucket, static_cast<uint4*>(table), (uint32_t)slots, win);
  return (int)cudaGetLastError();
}

extern "C" int ingest_known(const void* wire, long long bucket, int dense, int id_bits,
                            const void* table, long long slots, unsigned int ts_rel,
                            unsigned int base_lo, unsigned int base_hi, void* out, long long n_out,
                            void* stream) {
  known_kernel<<<rt::grid_for(n_out, kTile), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wire), bucket, dense, id_bits,
      static_cast<const uint4*>(table), (uint32_t)slots, ts_rel, base_lo, base_hi,
      static_cast<uint4*>(out), n_out);
  return (int)cudaGetLastError();
}
