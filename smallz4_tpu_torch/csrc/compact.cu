// Compaction of the current chunk's probe results into position order
// (Hopper, sm_90a).
//
// Replaces the TPU kernel smallz4_tpu/ops/chunkmatch.py:_compact_kernel
// together with the 1-key bitonic unsort that follows it in probe_pair.
// The probe kernel gives each current-chunk record key = (local << 4) |
// flags with local a permutation of [0, chunk), and every halo record
// key = 16 * chunk.  So "stable compaction of key < 16 * chunk, then sort
// by key" is one scatter: out[key >> 4] = (key, payload).
//
// Bound: pure data movement: every key read (4 bytes for each of the row's
// 2 * chunk slots), the payloads of the kept records only (4 bytes for each
// of its chunk positions) and 8 bytes written for each position: 83.89 MB,
// 25.04 us for one chunk group, [64, 131072] -> [64, 65536], at 3.35 TB/s.
// (Counting every payload, as a first estimate did, gives 100.66 MB and
// 30.05 us.)
//
// The first design, kept as history: one thread per merged slot, each kept
// record stored straight to device memory at b * chunk + (key >> 4).  The
// slots are in suffix order, so the positions of a warp's 32 records are
// random: each 4-byte store lands in its own 32-byte sector, and a group moved
// some 268 MB of sector traffic for 33.5 MB of data (0.1411 ms, 18% of the
// bound, on an H100 80GB HBM3 at 700 W).
//
// Design: the scatter happens in shared memory.  A row is split over a
// thread-block cluster of C <= 8 blocks (the portable size); block r owns
// the output positions [r * S, (r + 1) * S), S the power of two at or
// above chunk / C (8,192 at chunk = 65,536: 64 KiB of (key, payload)
// pairs).  The row's slots are read in units of 2,048, one 16-byte load a
// thread, unit u by block u mod C: a slot order that puts every current
// record first (or last) still gives each block its share of them, where
// contiguous eighths left half the blocks to store everything.  A thread
// keeps two units' loads in flight and loads a group's 4 payloads only
// where one of its keys is kept.  Each kept record goes as one 8-byte
// store into its owner's shared memory through distributed shared memory;
// after one cluster barrier each block writes its slice of okey and opay
// with coalesced 16-byte stores, so device memory sees 16-byte loads and
// stores only.  A group's payloads are read where any of its 4 keys is
// kept: in the probe's slot order that is nearly every group, so a chunk
// group moves about 100.66 MB, a fifth above the bound's bytes.  At most
// 40 registers a thread let 3 blocks of 512 threads and 64 KiB share an
// SM: a chunk group's 64 rows x 8 blocks = 512 blocks run in 1.3 waves of
// 396.  A block's first remote store waits on a cluster
// barrier that it arrived at before its loads (every peer must be running);
// after the second barrier no block touches a peer's memory, so none waits
// for its peers before it leaves.
//
// What bounds it: the remote stores, one per kept record; a copy of the
// kernel that keeps every store in its own block's memory (wrong results)
// runs in about two thirds of the time.  On a chunk group it takes
// 0.0528-0.0530 ms (H100 80GB HBM3, 700 W), 47% of the bound: short of
// half of it.
//
// Domain: 1 <= B <= 65,535, n = 2 * chunk, 1 <= chunk <= 65,536 (the
// key's 17 position bits; the wrapper reads both limits from
// s4_compact_max_rows and s4_compact_max_chunk), and the kept keys'
// positions a permutation of the row's [0, chunk), as the probe makes
// them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int MAX_CHUNK = 1 << 16;
constexpr int MAX_ROWS = 65535;    // the grid's y dimension, a row each
constexpr int MAX_CLUSTER = 8;     // portable cluster size
constexpr int MIN_SLICE = 256;     // fewest positions a block owns
constexpr int UNIT = 4 * THREADS;  // slots of one load of a block
constexpr int BATCH = 2;           // loads a thread has in flight

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// The 4 slots from p (one 16-byte load when `vec`), reading only below
// `end`; slots past it read as -1.
__device__ __forceinline__ int4 load4(const int32_t* row, int p, int end,
                                      bool vec) {
  if (vec && p < end) return *reinterpret_cast<const int4*>(row + p);
  return make_int4(p < end ? row[p] : -1, p + 1 < end ? row[p + 1] : -1,
                   p + 2 < end ? row[p + 2] : -1,
                   p + 3 < end ? row[p + 3] : -1);
}

// A thread's batch: the group of 4 slots at 4 * threadIdx.x in each of the
// units u, u + C, ..., u + (BATCH - 1) * C of UNIT slots, and the payloads
// of the groups that keep a record.  Keys are compared unsigned: the
// halo's 16 * chunk and the -1 past the row drop.
__device__ __forceinline__ void load_batch(const int32_t* krow,
                                           const int32_t* prow, int u, int C,
                                           int n, uint32_t limit, bool vec,
                                           int4 (&k)[BATCH],
                                           int4 (&v)[BATCH]) {
  const int p0 = u * UNIT + 4 * (int)threadIdx.x;
#pragma unroll
  for (int j = 0; j < BATCH; ++j)
    k[j] = load4(krow, p0 + j * C * UNIT, n, vec);
#pragma unroll
  for (int j = 0; j < BATCH; ++j) {
    const bool any = (uint32_t)k[j].x < limit || (uint32_t)k[j].y < limit ||
                     (uint32_t)k[j].z < limit || (uint32_t)k[j].w < limit;
    v[j] = any ? load4(prow, p0 + j * C * UNIT, n, vec)
               : make_int4(0, 0, 0, 0);
  }
}

// One row a cluster of C blocks; block r reads the units r, r + C, r + 2C,
// ... of the row's slots and owns the positions [r << log_s, (r + 1) <<
// log_s).  `vec`: every row starts on 16 bytes.
__global__ void __launch_bounds__(THREADS, 3)
compact_cluster_kernel(const int32_t* __restrict__ key,
                       const int32_t* __restrict__ payload,
                       int32_t* __restrict__ okey, int32_t* __restrict__ opay,
                       int n, int chunk, int log_s, bool vec) {
  extern __shared__ int4 smem4[];
  int2* slice = reinterpret_cast<int2*>(smem4);  // (key, payload) pairs
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // this block runs (waited on: remote stores)
  const int r = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int32_t* krow = key + (size_t)blockIdx.y * n;
  const int32_t* prow = payload + (size_t)blockIdx.y * n;
  const uint32_t limit = 16u * (uint32_t)chunk;
  int4 k[BATCH], v[BATCH];
  int u = r;
  load_batch(krow, prow, u, C, n, limit, vec, k, v);
  cluster_wait();  // every peer runs: its shared memory may be written
  for (;;) {
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int kk[4] = {k[j].x, k[j].y, k[j].z, k[j].w};
      const int vv[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t w = (uint32_t)kk[e];
        if (w >= limit) continue;
        const int pos = (int)(w >> 4);
        const int owner = pos >> log_s;
        int2* dst = cluster.map_shared_rank(slice, owner);
        dst[pos - (owner << log_s)] = make_int2(kk[e], vv[e]);
      }
    }
    u += BATCH * C;
    if (u * UNIT >= n) break;  // the same for the whole block
    load_batch(krow, prow, u, C, n, limit, vec, k, v);
  }
  cluster.sync();  // every record sits in its owner's slice
  const int o_lo = r << log_s;
  const int o_hi = min(o_lo + (1 << log_s), chunk);
  int32_t* ko = okey + (size_t)blockIdx.y * chunk;
  int32_t* po = opay + (size_t)blockIdx.y * chunk;
  if (vec) {
    for (int i = 4 * (int)threadIdx.x; o_lo + i < o_hi; i += 4 * THREADS) {
      const int4 a = smem4[i / 2], b = smem4[i / 2 + 1];
      *reinterpret_cast<int4*>(ko + o_lo + i) = make_int4(a.x, a.z, b.x, b.z);
      *reinterpret_cast<int4*>(po + o_lo + i) = make_int4(a.y, a.w, b.y, b.w);
    }
  } else {
    for (int i = threadIdx.x; o_lo + i < o_hi; i += THREADS) {
      const int2 e = slice[i];
      ko[o_lo + i] = e.x;
      po[o_lo + i] = e.y;
    }
  }
}

int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// The largest chunk and row count s4_compact takes (no launch).
int s4_compact_max_chunk() { return MAX_CHUNK; }
int s4_compact_max_rows() { return MAX_ROWS; }

// key, payload: [B][n] with n = 2 * chunk; okey, opay: [B][chunk].  One
// cluster launch.
int s4_compact(const int32_t* key, const int32_t* payload, int32_t* okey,
               int32_t* opay, int B, int n, int chunk, void* stream) {
  if (B < 1 || B > MAX_ROWS || chunk < 1 || chunk > MAX_CHUNK ||
      n != 2 * chunk)
    return (int)cudaErrorInvalidValue;
  const int C =
      min(MAX_CLUSTER, next_pow2((chunk + MIN_SLICE - 1) / MIN_SLICE));
  // owned positions a block: a power of two >= 4, at most 8,192 (64 KiB)
  const int S0 = next_pow2((chunk + C - 1) / C);
  const int S = S0 < 4 ? 4 : S0;
  const int log_s = 31 - __builtin_clz((unsigned)S);
  const int smem = S * (int)sizeof(int2);
  const bool vec = (chunk & 3) == 0 && ((uintptr_t)key & 15) == 0 &&
                   ((uintptr_t)payload & 15) == 0 &&
                   ((uintptr_t)okey & 15) == 0 && ((uintptr_t)opay & 15) == 0;
  cudaError_t e = cudaFuncSetAttribute(
      compact_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, compact_cluster_kernel, key, payload, okey,
                         opay, n, chunk, log_s, vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
