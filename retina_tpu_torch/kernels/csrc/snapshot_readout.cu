// K17: the snapshot readout, one launch for the whole flat snapshot.
//
// Replaces retina_tpu/parallel/telemetry.py:712 snapshot_flat (the flat
// program over :493 sharded.snapshot: the leaves copied, the HLL estimates
// and the live count, bitcast to u32 and concatenated), and with it the
// HLL half of timetravel/fold.py:163 range_extract:
//
// copy: a state leaf's u32 words into its place in the flat buffer.
// hll: ops/hyperloglog.py:108 estimate of every group of a (G, m) register
//   bank: raw = alpha_m m^2 / sum(2^-reg), zeros = the registers at 0, and
//   the linear count m ln(m / zeros) where raw <= 2.5 m and zeros > 0. f32,
//   as the reference. The plain version is
//   retina_tpu_torch/ops/hyperloglog.py estimate_plain.
// live: ops/conntrack.py:286 active_connections: the resident slots (key
//   words not both 0) whose 16-bit idle time (now - seen16) & 0xFFFF is
//   within the protocol's lifetime or past 0xFFFF - the clock-skew slack,
//   in u32 arithmetic, counted exactly as an int32. The plain version is
//   retina_tpu_torch/ops/conntrack.py active_connections_plain.
// The whole buffer's plain version is retina_tpu_torch/parallel/telemetry.py
// readout_plain.
//
// Bound on the H100: bytes. At the deployed shapes the snapshot copies
// 1.34 MB of leaves, reads 1.33 MB of HLL registers and the conntrack
// table's 2 MiB of keys and the 32-byte sectors of the resident slots'
// 16-byte value rows (at most 4 MiB; only the meta word is used), and
// writes the 1.36 MB buffer: ~10 MB, ~3 us at 3.35 TB/s.
//
// Design. One launch runs a table of jobs passed by value as a
// __grid_constant__ kernel parameter (no copy from the host); each job owns
// a run of blocks, given in proportion to its bytes by the wrapper, and a
// block finds its job by its index. Every block moves about the same bytes
// with all its loads in flight before it uses them, so the launch is one
// wave of short blocks and no job waits on another.
// - copy: the leaf's words into the buffer, 16-byte stores at the buffer's
//   16-byte boundaries (the leaves sit at any word offset), 16-byte loads
//   where the source shares the alignment, else four word loads that L1
//   serves from the same lines.
// - hll, m > 128 (hll_flows, hll_src_per_reason: 4096) or m < 4: a block a
//   group, 16-byte register loads; 4 <= m <= 128 (hll_src_per_pod: 64): a
//   group on m / 4 lanes of a warp, a 16-byte load each, four passes of
//   128 / m groups in flight. Each sums exp2f(-reg) (exact powers of two) and counts zeros
//   with shuffles; one lane writes the estimate with full-precision logf and
//   division.
// - live: a count over the slots, four a thread at a time, the value row
//   read only for a resident key; a block sum, then one 64-bit atomic a
//   block on a ticket that carries the count in its high word and the
//   blocks done in its low word: the last block writes the count and puts
//   the ticket back to 0 for the next call (no memset, no read back).
// kops.hll_estimate and kops.ct_active are one-job launches of the same
// kernel (the range extract and the fleet rollup estimate one bank).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxJobs = 32;
constexpr int kUnroll = 4;  // loads a thread has in flight

enum Kind : int { kCopy = 0, kHllBlock = 1, kHllWarp = 2, kLive = 3 };

struct Job {
  const void* src;   // copy: the leaf's words; hll: the (G, m) registers; live: keys (S, 2)
  const void* src2;  // live: vals (S, 4), 16-byte rows
  long long n;       // copy: words; hll: groups; live: slots
  long long dst;     // the job's first word in the buffer
  int kind;
  int block0;        // the job's first block; the next job's is its end
  int m;             // hll: registers a group
  float alpha_mm;    // hll: alpha_m * m * m
};
static_assert(sizeof(Job) == 48, "Job must match kernels/ops.py _ReadoutJob");

struct Table {
  uint32_t* out;                // the flat buffer (16-byte aligned)
  unsigned long long* ticket;   // the live job's count and blocks done: 0 on entry, left 0
  int n_jobs;
  int n_blocks;
  uint32_t now, tcp_life, other_life, wrap_floor;
  Job jobs[kMaxJobs];
};
static_assert(sizeof(Table) == 40 + 48 * kMaxJobs, "Table must match kernels/ops.py _ReadoutTable");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  return v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ uint32_t hll_value(float s, int zeros, int m, float alpha_mm) {
  const float fm = (float)m, z = (float)zeros;
  const float raw = alpha_mm / s;
  const float lc = fm * logf(fm / fmaxf(z, 1e-9f));
  return __float_as_uint((raw <= 2.5f * fm && z > 0.f) ? lc : raw);
}

__device__ __forceinline__ float reg_term(uint32_t r) { return exp2f(-(float)r); }

__device__ void copy_job(const Job& job, uint32_t* out, long long b, long long nb) {
  const uint32_t* src = static_cast<const uint32_t*>(job.src);
  uint32_t* dst = out + job.dst;
  const long long n = job.n;
  const long long tid = b * kThreads + threadIdx.x, stride = nb * kThreads;
  // Words before the buffer's next 16-byte boundary, then 4-word groups.
  const long long head =
      min(n, (long long)((4 - ((reinterpret_cast<uintptr_t>(dst) >> 2) & 3)) & 3));
  if (tid < head) dst[tid] = src[tid];
  const uint32_t* s = src + head;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  const long long body = (n - head) >> 2;
  const bool vec = aligned16(s);
  for (long long i0 = tid; i0 < body; i0 += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
      if (i < body) {
        if (vec) {
          v[u] = __ldg(reinterpret_cast<const uint4*>(s) + i);
        } else {
          const uint32_t* p = s + 4 * i;
          v[u] = make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
      if (i < body) d4[i] = v[u];
    }
  }
  const long long done = head + 4 * body;
  if (tid < n - done) dst[done + tid] = src[done + tid];
}

// A block a group: groups b, b + nb, ...
__device__ void hll_block_job(const Job& job, uint32_t* out, long long b, long long nb) {
  __shared__ float s_part[kWarps];
  __shared__ int z_part[kWarps];
  const int m = job.m;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long g = b; g < job.n; g += nb) {
    const uint32_t* row = static_cast<const uint32_t*>(job.src) + g * m;
    float s = 0.f;
    int zeros = 0;
    if ((m & 3) == 0 && aligned16(row)) {
      const uint4* r4 = reinterpret_cast<const uint4*>(row);
      for (int i0 = threadIdx.x; i0 < (m >> 2); i0 += kUnroll * kThreads) {
        uint4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kThreads;
          v[u] = i < (m >> 2) ? __ldg(r4 + i) : make_uint4(64u, 64u, 64u, 64u);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i0 + u * kThreads < (m >> 2)) {
            s += reg_term(v[u].x) + reg_term(v[u].y) + reg_term(v[u].z) + reg_term(v[u].w);
            zeros += (v[u].x == 0u) + (v[u].y == 0u) + (v[u].z == 0u) + (v[u].w == 0u);
          }
        }
      }
    } else {
      for (int i = threadIdx.x; i < m; i += kThreads) {
        const uint32_t r = __ldg(row + i);
        s += reg_term(r);
        zeros += r == 0u;
      }
    }
    s = warp_sum(s);
    zeros = warp_sum(zeros);
    if (lane == 0) {
      s_part[warp] = s;
      z_part[warp] = zeros;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float st = 0.f;
      int zt = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        st += s_part[w];
        zt += z_part[w];
      }
      out[job.dst + g] = hll_value(st, zt, m, job.alpha_mm);
    }
    __syncthreads();
  }
}

// 4 <= m <= 128: a group on m / 4 lanes, one 16-byte load a lane, 128 / m groups
// a warp at a time and kUnroll such passes in flight: groups (w + k nw) *
// (128 / m) + the lane's place, for the job's warps w.
__device__ void hll_warp_job(const Job& job, uint32_t* out, long long b, long long nb) {
  const int m = job.m, lane = threadIdx.x & 31;
  const int L = m >> 2, gpw = 32 / L;  // lanes a group, groups a pass
  const int sub = lane / L, sl = lane - sub * L;
  const long long nw = nb * kWarps, w = b * kWarps + (threadIdx.x >> 5);
  const uint32_t* regs = static_cast<const uint32_t*>(job.src);
  const bool vec = aligned16(regs);
  for (long long p0 = w; p0 * gpw < job.n; p0 += kUnroll * nw) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long g = (p0 + u * nw) * gpw + sub;
      const uint32_t* q = regs + g * m + 4 * sl;
      v[u] = g >= job.n ? make_uint4(0u, 0u, 0u, 0u)
             : vec      ? __ldg(reinterpret_cast<const uint4*>(q))
                        : make_uint4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long g = (p0 + u * nw) * gpw + sub;
      float s = reg_term(v[u].x) + reg_term(v[u].y) + reg_term(v[u].z) + reg_term(v[u].w);
      int zeros = (v[u].x == 0u) + (v[u].y == 0u) + (v[u].z == 0u) + (v[u].w == 0u);
      for (int off = L >> 1; off; off >>= 1) {  // within the group's L lanes
        s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
        zeros += __shfl_xor_sync(0xFFFFFFFFu, zeros, off);
      }
      if (sl == 0 && g < job.n) out[job.dst + g] = hll_value(s, zeros, m, job.alpha_mm);
    }
  }
}

__device__ void live_job(const Table& t, const Job& job, long long b, long long nb) {
  __shared__ int part[kWarps];
  const uint2* keys = static_cast<const uint2*>(job.src);
  const uint4* vals = static_cast<const uint4*>(job.src2);
  const long long S = job.n, stride = nb * kThreads;
  int c = 0;
  for (long long i0 = b * kThreads + threadIdx.x; i0 < S; i0 += kUnroll * stride) {
    uint2 k[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
      k[u] = i < S ? __ldg(keys + i) : make_uint2(0u, 0u);
    }
    uint32_t meta[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
      meta[u] = (k[u].x | k[u].y) ? __ldg(reinterpret_cast<const uint32_t*>(vals + i)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t life = (meta[u] >> 31) ? t.tcp_life : t.other_life;
      const uint32_t idle = (t.now - (meta[u] & 0xFFFFu)) & 0xFFFFu;
      c += ((k[u].x | k[u].y) != 0u) && (idle <= life || idle > t.wrap_floor);
    }
  }
  c = warp_sum(c);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = c;
  __syncthreads();
  if (threadIdx.x != 0) return;
  int sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sum += part[w];
  // The ticket carries the count in its high word and the blocks done in
  // its low word, so one atomic a block publishes both.
  const unsigned long long old =
      atomicAdd(t.ticket, ((unsigned long long)(uint32_t)sum << 32) | 1ull);
  if ((uint32_t)old == (uint32_t)(nb - 1)) {
    t.out[job.dst] = (uint32_t)(old >> 32) + (uint32_t)sum;
    *t.ticket = 0ull;  // for the next call on this stream
  }
}

__global__ void __launch_bounds__(kThreads) readout_kernel(const __grid_constant__ Table t) {
  int j = 0;
  while (j + 1 < t.n_jobs && t.jobs[j + 1].block0 <= (int)blockIdx.x) ++j;
  const Job& job = t.jobs[j];
  const long long b = (long long)blockIdx.x - job.block0;
  const long long nb = (j + 1 < t.n_jobs ? t.jobs[j + 1].block0 : t.n_blocks) - job.block0;
  switch (job.kind) {
    case kCopy:
      copy_job(job, t.out, b, nb);
      break;
    case kHllBlock:
      hll_block_job(job, t.out, b, nb);
      break;
    case kHllWarp:
      hll_warp_job(job, t.out, b, nb);
      break;
    case kLive:
      live_job(t, job, b, nb);
      break;
  }
}

}  // namespace

// The readout of one table of jobs (kernels/ops.py _ReadoutTable): the
// table is copied into the launch's parameters, so the caller may reuse it
// at once. At most one live job a table.
extern "C" int snapshot_readout(const void* table, void* stream) {
  const Table& t = *static_cast<const Table*>(table);
  if (t.n_jobs < 1 || t.n_jobs > kMaxJobs) return (int)cudaErrorInvalidValue;
  if (t.n_blocks == 0) return 0;
  readout_kernel<<<t.n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return (int)cudaGetLastError();
}
