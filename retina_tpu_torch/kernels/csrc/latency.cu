// K14: the apiserver latency match of the step.
//
// Replaces the latency block of retina_tpu/models/pipeline.py:565-596,
// inside the pipeline.step program (:682). Rows to the apiserver with
// TSval > 0 ("sends") write their fingerprint hash_cols([dst_ip, TSval],
// 0x1A7) and send time (TS_HI << 12 | TS_LO >> 20, u32) into slot
// fingerprint mod L of lat_key / lat_ts; rows from the apiserver with
// TSecr > 0 ("replies") look up hash_cols([src_ip, TSecr], 0x1A7), and a
// match adds one to lat_hist[min(floor(log2(rtt + 1)), H - 1)], rtt = the
// reply's time - the send time in u32, and zeroes the slot's key. Only rows with the step's
// mask lane set (K1's: inside n_valid, kept by the filter) take part. The
// rules of the plain version (models/pipeline.py latency_update_plain)
// hold: among the sends of one slot the last row in batch order writes
// key and time; every reply reads the table after all of this batch's
// sends; every matching reply counts, and matched slots are zeroed only
// after every reply has read them; the bucket is exact.
//
// Bound on the H100: bytes. The match needs every masked row's lanes 2, 3,
// 10 and 11, in both 32-byte sectors of its 64-byte record, and the tables
// (2 x 4 KiB at L = 4096); K1 reads those lanes for its own work, so what
// is left to this launch is the list (16 bytes a probe; almost no row is
// one) and the tables.
//
// Design: the row scan is K1's (csrc/step_rows.cu): the step's per-event
// kernel holds each row's lanes and final mask in registers already and
// appends every send or reply as one 16-byte entry (row and flags, both
// hashes, the send time) to a list in device memory through one atomic a
// warp, so the batch is not read a second time. This file is the finish,
// one launch a step: a single block of 1024 threads over that list, with
// __syncthreads between the phases the rules need: the per-slot winner (an
// atomicMax of row + 1 in shared memory), the winners' writes, the
// replies' match (histogram in shared memory, kill flags in the reused
// winner array), the kills. At its end thread 0 clears the list's count
// for the next step, so there is no memset and no read back to the host.
#include "hash.cuh"

namespace {

constexpr uint32_t kSend = 1u << 30;
constexpr uint32_t kReply = 1u << 31;
constexpr uint32_t kRowMask = kSend - 1u;
constexpr int kFinishThreads = 1024;

__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(uint32_t* __restrict__ count, const uint4* __restrict__ entries,
              uint32_t* __restrict__ lat_key, uint32_t* __restrict__ lat_ts, uint32_t L,
              uint32_t* __restrict__ lat_hist, uint32_t H) {
  extern __shared__ uint32_t sh[];
  __shared__ uint32_t n_entries;
  uint32_t* slot = sh;       // L: the winner's row + 1, then the kill flags
  uint32_t* hist = sh + L;   // H
  if (threadIdx.x == 0) n_entries = *count;
  for (uint32_t s = threadIdx.x; s < L + H; s += blockDim.x) sh[s] = 0u;
  __syncthreads();
  const uint32_t n = n_entries;
  // The last send row of each slot wins it.
  for (uint32_t e = threadIdx.x; e < n; e += blockDim.x) {
    const uint4 v = entries[e];
    if (v.x & kSend) atomicMax(&slot[v.y & (L - 1u)], (v.x & kRowMask) + 1u);
  }
  __syncthreads();
  for (uint32_t e = threadIdx.x; e < n; e += blockDim.x) {
    const uint4 v = entries[e];
    const uint32_t s = v.y & (L - 1u);
    if ((v.x & kSend) && slot[s] == (v.x & kRowMask) + 1u) {
      lat_key[s] = v.y;
      lat_ts[s] = v.w;
    }
  }
  __syncthreads();
  for (uint32_t s = threadIdx.x; s < L; s += blockDim.x) slot[s] = 0u;
  __syncthreads();
  // Every reply reads the table as this batch's sends left it.
  for (uint32_t e = threadIdx.x; e < n; e += blockDim.x) {
    const uint4 v = entries[e];
    if (!(v.x & kReply)) continue;
    const uint32_t s = v.z & (L - 1u);
    if (lat_key[s] != v.z) continue;
    const uint32_t rtt = v.w - lat_ts[s];
    const uint32_t b = 63u - (uint32_t)__clzll((unsigned long long)rtt + 1ull);
    atomicAdd(&hist[b < H - 1u ? b : H - 1u], 1u);
    slot[s] = 1u;
  }
  __syncthreads();
  for (uint32_t s = threadIdx.x; s < L; s += blockDim.x)
    if (slot[s]) lat_key[s] = 0u;
  for (uint32_t h = threadIdx.x; h < H; h += blockDim.x) lat_hist[h] += hist[h];
  if (threadIdx.x == 0) *count = 0u;  // only thread 0 reads or writes it
}

}  // namespace

// count: one u32, the length of the list K1 filled (left 0); entries: the
// list (csrc/step_rows.cu).
extern "C" int latency_update(void* count, const void* entries, void* lat_key, void* lat_ts, int L,
                              void* lat_hist, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(uint32_t) * ((size_t)L + (size_t)H);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  finish_kernel<<<1, kFinishThreads, smem, st>>>(
      static_cast<uint32_t*>(count), static_cast<const uint4*>(entries),
      static_cast<uint32_t*>(lat_key), static_cast<uint32_t*>(lat_ts), (uint32_t)L,
      static_cast<uint32_t*>(lat_hist), (uint32_t)H);
  return (int)cudaGetLastError();
}
