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
// 6.25 bytes) and, on the known side, one 48-byte table row, and writes a
// 64-byte record; the integer work is a few shifts a lane.
//
// Design: one thread per output row in a grid-stride loop, records and
// table rows moved as 16-byte vectors (a record is 4 x uint4, a table row
// 3 x uint4; the 13-lane new wire row is 52 bytes and read lane by lane).
// Duplicate ids on the new side: escalated rows re-send a resident
// descriptor and every table-less or padding row writes the sacrificial
// slot 0, so an id can repeat within one wire. The last row in batch
// order wins, as for the port's other duplicate writes: the first launch
// takes a per-slot atomicMax of (row + 1) into a scratch array that is
// zero between calls; the second launch lets only that row write the slot
// and clear its scratch entry. Ids past the table are dropped on the new
// side and read the last slot on the known side.
#include "hash.cuh"

namespace {

// Schema field indices (retina_tpu_torch/events/schema.py).
enum Field {
  kTsLo, kTsHi, kSrcIp, kDstIp, kPorts, kMeta, kBytes, kPackets, kVerdict, kDropReason,
  kTsval, kTsecr, kDns, kDnsQhash, kEventType, kIfindex, kFields
};
constexpr int kPacked = 12;

// 12 packed lanes -> 16 record lanes (wire.py's table).
__device__ __forceinline__ void unpack(const uint32_t* p, uint32_t base_lo, uint32_t base_hi,
                                       uint32_t* r) {
  const uint32_t rel = p[0];
  const uint32_t relm1 = rel - 1u;  // wraps for rel == 0; masked below
  const uint32_t ts_lo = base_lo + relm1;
  const uint32_t carry = ts_lo < relm1 ? 1u : 0u;
  const uint32_t misc = p[7];
  r[kTsLo] = rel ? ts_lo : 0u;
  r[kTsHi] = rel ? base_hi + carry : 0u;
  r[kSrcIp] = p[1];
  r[kDstIp] = p[2];
  r[kPorts] = p[3];
  r[kMeta] = p[4];
  r[kBytes] = p[5];
  r[kPackets] = p[6];
  r[kVerdict] = misc >> 29;
  r[kDropReason] = (misc >> 21) & 0xFFu;
  r[kTsval] = p[8];
  r[kTsecr] = p[9];
  r[kDns] = p[10];
  r[kDnsQhash] = p[11];
  r[kEventType] = (misc >> 17) & 0xFu;
  r[kIfindex] = misc & 0x1FFFFu;
}

__device__ __forceinline__ void store_row(uint4* out, long long i, const uint32_t* r) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    out[4 * i + k] = make_uint4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
}

__device__ __forceinline__ void store_zero(uint4* out, long long i) {
#pragma unroll
  for (int k = 0; k < 4; ++k) out[4 * i + k] = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void load12(const uint4* src, long long row, uint32_t* p) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint4 v = src[3 * row + k];
    p[4 * k] = v.x;
    p[4 * k + 1] = v.y;
    p[4 * k + 2] = v.z;
    p[4 * k + 3] = v.w;
  }
}

__global__ void packed_kernel(const uint4* wire, long long bucket, int packed, uint32_t base_lo,
                              uint32_t base_hi, uint4* out, long long n_out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n_out; i += stride) {
    if (i >= bucket) {
      store_zero(out, i);
    } else if (packed) {
      uint32_t p[kPacked], r[kFields];
      load12(wire, i, p);
      unpack(p, base_lo, base_hi, r);
      store_row(out, i, r);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) out[4 * i + k] = wire[4 * i + k];
    }
  }
}

// New side, launch 1: claim each id for its last row, unpack every row.
__global__ void new_claim_kernel(const uint32_t* wire, long long bucket, uint32_t slots,
                                 uint32_t* winner, uint32_t base_lo, uint32_t base_hi,
                                 uint4* out, long long n_out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n_out; i += stride) {
    if (i >= bucket) {
      store_zero(out, i);
      continue;
    }
    const uint32_t* w = wire + 13 * i;
    const uint32_t id = w[0];
    if (id < slots) atomicMax(winner + id, (uint32_t)(i + 1));
    uint32_t p[kPacked], r[kFields];
#pragma unroll
    for (int k = 0; k < kPacked; ++k) p[k] = w[1 + k];
    unpack(p, base_lo, base_hi, r);
    store_row(out, i, r);
  }
}

// New side, launch 2: the winning row writes its slot and clears its claim.
// A losing row reads either the winner's claim or 0, never its own.
__global__ void new_write_kernel(const uint32_t* wire, long long bucket, uint4* table,
                                 uint32_t slots, uint32_t* winner) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < bucket; i += stride) {
    const uint32_t* w = wire + 13 * i;
    const uint32_t id = w[0];
    if (id >= slots || winner[id] != (uint32_t)(i + 1)) continue;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      table[3 * (size_t)id + k] = make_uint4(w[1 + 4 * k], w[2 + 4 * k], w[3 + 4 * k],
                                             w[4 + 4 * k]);
    winner[id] = 0u;
  }
}

// Known side: decode, gather the descriptor, overlay, unpack.
__global__ void known_kernel(const uint32_t* wire, long long bucket, int dense, int id_bits,
                             const uint4* table, uint32_t slots, uint32_t ts_rel,
                             uint32_t base_lo, uint32_t base_hi, uint4* out, long long n_out) {
  const uint32_t id_mask = id_bits >= 32 ? 0xFFFFFFFFu : (1u << id_bits) - 1u;
  const unsigned long long rb = (unsigned long long)id_bits + 10ull + 22ull;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n_out; i += stride) {
    if (i >= bucket) {
      store_zero(out, i);
      continue;
    }
    uint32_t id, pk, by;
    if (dense) {
      // Each field is <= 32 bits, so two words hold it; a shift of 0
      // takes nothing from the upper word (the pad word keeps the last
      // row's read in bounds).
      const unsigned long long row = (unsigned long long)i * rb;
      uint32_t f[3];
      const int off[3] = {0, id_bits, id_bits + 10};
      const uint32_t mask[3] = {id_mask, (1u << 10) - 1u, (1u << 22) - 1u};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const unsigned long long p = row + (unsigned long long)off[k];
        const unsigned long long wi = p >> 5;
        const uint32_t sh = (uint32_t)(p & 31ull);
        const uint32_t lo = wire[wi] >> sh;
        const uint32_t up = sh ? wire[wi + 1] << (32u - sh) : 0u;
        f[k] = (lo | up) & mask[k];
      }
      id = f[0];
      pk = f[1];
      by = f[2];
    } else {
      const uint32_t w0 = wire[2 * i], w1 = wire[2 * i + 1];
      id = w0 & id_mask;
      pk = id_bits >= 32 ? 0u : w0 >> id_bits;
      by = w1;
    }
    if (id >= slots) id = slots - 1u;
    uint32_t p[kPacked], r[kFields];
    load12(table, id, p);
    p[0] = ts_rel;
    p[5] = by;
    p[6] = pk;
    unpack(p, base_lo, base_hi, r);
    store_row(out, i, r);
  }
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int ingest_packed(const void* wire, long long bucket, int packed, unsigned int base_lo,
                             unsigned int base_hi, void* out, long long n_out, void* stream) {
  packed_kernel<<<rt::grid_for(n_out, kThreads), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(wire), bucket, packed, base_lo, base_hi, static_cast<uint4*>(out),
      n_out);
  return (int)cudaGetLastError();
}

extern "C" int ingest_new(const void* wire, long long bucket, void* table, long long slots,
                          void* winner, unsigned int base_lo, unsigned int base_hi, void* out,
                          long long n_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* w = static_cast<const uint32_t*>(wire);
  uint32_t* win = static_cast<uint32_t*>(winner);
  new_claim_kernel<<<rt::grid_for(n_out, kThreads), kThreads, 0, s>>>(
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
  known_kernel<<<rt::grid_for(n_out, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wire), bucket, dense, id_bits,
      static_cast<const uint4*>(table), (uint32_t)slots, ts_rel, base_lo, base_hi,
      static_cast<uint4*>(out), n_out);
  return (int)cudaGetLastError();
}
