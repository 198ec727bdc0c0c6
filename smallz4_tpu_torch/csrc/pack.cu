// Head/delta packing of position-order claims (Hopper, sm_90a).
//
// Replaces the TPU kernel smallz4_tpu/ops/chunkmatch.py:_pack_kernel
// (pack_results).  Per chunk row: a position is a head unless its claim
// is the one predicted from its predecessor ((len-1, same dist) after
// len >= 5; 65535 held flat after a saturated claim; else (1, 0)); slot 0
// is always a head.  Outputs the head, conv and lk bitmask words (bit i of
// word w = position 32w + i, little-endian bit order), the compacted
// min(len, 65535) << 16 | dist words at the head ranks (zero from the head
// count on), and the head count.
//
// Bound: memory, 10 bytes read and 4.375 written per position (18.00 us for
// one chunk group, [64, 65536], at 3.35 TB/s); the head ranks need a scan
// across the row.
//
// The first design, kept as history: one block a row (64 blocks on 132 SMs)
// walked the row in 64 serial tiles of 1,024 positions, four __syncthreads and
// a one-warp scan a tile, 4-byte loads (each thread also loaded its
// predecessor's lens and dists again), conv and lk a byte a thread, lane 0
// alone writing a warp's three bitmask words, and the zero tail written by
// the block at the end (0.0958 ms, 19% of the bound, on an H100 80GB HBM3 at
// 700 W).
//
// Design: a row is split over a thread-block cluster of C <= 8 blocks, one
// tile of whole bitmask words a block (8,192 positions at chunk = 65,536,
// so a chunk group is 512 blocks of 512 threads).  A thread takes 16
// consecutive positions with 16-byte loads (four of lens, four of dists,
// one each of conv and lk); its first position's predecessor is the
// previous lane's last, and only a warp's lane 0 loads it from device
// memory.  The three 16-bit masks of a thread pair make one word each,
// stored by the even lanes, 64 contiguous bytes a warp.  Head ranks come
// from a warp scan of the threads' head counts, a scan of the warp totals,
// and the sum of the lower blocks' totals, which each block reads from its
// peers' shared memory after one cluster barrier.  The heads' words are
// staged in shared memory at their block ranks, rank k at k + k / 16 (a
// thread's 16 heads would otherwise hit 2 banks when every position is a
// head), and written out with coalesced 4-byte stores.  Every block then
// knows the row's total, and block r zeros packed[max(total, tile start) :
// tile end] (16-byte stores) with no race, since every head rank is below
// the total.  A block leaves only after its peers have read its total (a
// split cluster barrier around the stores).
//
// Domain: 1 <= B <= 65,535, chunk % 32 == 0, 32 <= chunk <= 65,536 (the
// wrapper reads both limits from s4_pack_max_rows and s4_pack_max_chunk);
// lens and dists any int32, conv and lk bytes (bit 0 read); every pointer
// on 16 bytes (the wrapper copies a view that starts off that boundary).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int PER_THREAD = 16;      // positions a thread
constexpr int MAX_CHUNK = 1 << 16;
constexpr int MAX_ROWS = 65535;     // the grid's y dimension, a row each
constexpr int MAX_CLUSTER = 8;      // portable cluster size
constexpr int MIN_WORDS = 8;        // fewest bitmask words a block
constexpr int MAX_WORDS = MAX_CHUNK / 32 / MAX_CLUSTER;  // most a block: 256
constexpr int MAX_THREADS = 2 * MAX_WORDS;               // 512
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// bits 0..3: bit 0 of each of the 4 bytes of x (byte 0 -> bit 0)
__device__ __forceinline__ unsigned nibble(unsigned x) {
  return (((x & 0x01010101u) * 0x01020408u) >> 24) & 0xFu;
}

__device__ __forceinline__ unsigned bits16(int4 v) {
  return nibble((unsigned)v.x) | nibble((unsigned)v.y) << 4 |
         nibble((unsigned)v.z) << 8 | nibble((unsigned)v.w) << 12;
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(FULL, v, s);
    if (lane >= s) v += y;
  }
  return v;
}

// One row a cluster; block r holds the bitmask words [r * wpb, ...).
// Every input starts on 16 bytes, so rows and tiles do too.
__global__ void __launch_bounds__(MAX_THREADS)
pack_cluster_kernel(const int32_t* __restrict__ lens,
                    const int32_t* __restrict__ dists,
                    const uint8_t* __restrict__ conv,
                    const uint8_t* __restrict__ lk,
                    int32_t* __restrict__ bits, int32_t* __restrict__ packed,
                    int32_t* __restrict__ count, int32_t* __restrict__ cbits,
                    int32_t* __restrict__ kbits, int chunk, int wpb) {
  // head words at block ranks; rank k at k + k / 16, so that 16 heads a
  // thread (rank 16t + i of lane t) fall into distinct banks
  __shared__ int32_t s_pay[MAX_WORDS * 32 * 17 / 16];
  __shared__ int s_warp[MAX_THREADS / 32];   // warp totals, then offsets
  __shared__ int s_tot, s_lower, s_total;
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n_words = chunk / 32;
  const int w_lo = min(r * wpb, n_words);
  const int w_hi = min(w_lo + wpb, n_words);
  const bool active = t < 2 * (w_hi - w_lo);
  const int p0 = w_lo * 32 + PER_THREAD * t;  // row-local position
  const size_t row = (size_t)blockIdx.y * chunk;
  const int32_t* lrow = lens + row;
  const int32_t* drow = dists + row;

  int L[PER_THREAD], D[PER_THREAD];
  unsigned cm = 0, km = 0;
  int pl = 0, pd = 0;  // the predecessor of p0 (lane 0 of a warp)
  if (active) {
#pragma unroll
    for (int j = 0; j < PER_THREAD / 4; ++j) {
      const int4 a = *reinterpret_cast<const int4*>(lrow + p0 + 4 * j);
      const int4 b = *reinterpret_cast<const int4*>(drow + p0 + 4 * j);
      L[4 * j] = a.x, L[4 * j + 1] = a.y, L[4 * j + 2] = a.z,
      L[4 * j + 3] = a.w;
      D[4 * j] = b.x, D[4 * j + 1] = b.y, D[4 * j + 2] = b.z,
      D[4 * j + 3] = b.w;
    }
    cm = bits16(*reinterpret_cast<const int4*>(conv + row + p0));
    km = bits16(*reinterpret_cast<const int4*>(lk + row + p0));
    if (lane == 0 && p0 > 0) {
      pl = lrow[p0 - 1];
      pd = drow[p0 - 1];
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) L[i] = D[i] = 0;
  }
  {
    const int ul = __shfl_up_sync(FULL, L[PER_THREAD - 1], 1);
    const int ud = __shfl_up_sync(FULL, D[PER_THREAD - 1], 1);
    if (lane > 0) pl = ul, pd = ud;
  }

  // heads, and their words in registers
  unsigned hm = 0;
  uint32_t pay[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int ql = i ? L[i - 1] : pl, qd = i ? D[i - 1] : pd;
    const int pred_len = ql == 65535 ? 65535 : (ql >= 5 ? ql - 1 : 1);
    const int pred_dist = ql >= 5 ? qd : 0;
    const bool head = L[i] != pred_len || D[i] != pred_dist;
    hm |= (unsigned)head << i;
    pay[i] = ((uint32_t)min(L[i], 65535) << 16) | ((uint32_t)D[i] & 0xFFFFu);
  }
  if (p0 == 0) hm |= 1u;  // slot 0 of the row
  if (!active) hm = 0;

  // bitmask words: a thread pair's 16-bit masks, stored by the even lane
  const unsigned hw = hm | __shfl_down_sync(FULL, hm, 1) << 16;
  const unsigned cw = cm | __shfl_down_sync(FULL, cm, 1) << 16;
  const unsigned kw = km | __shfl_down_sync(FULL, km, 1) << 16;
  if (active && (t & 1) == 0) {
    const size_t w = (size_t)blockIdx.y * n_words + w_lo + (t >> 1);
    bits[w] = (int32_t)hw;
    cbits[w] = (int32_t)cw;
    kbits[w] = (int32_t)kw;
  }

  // block ranks: warp scan, then a scan of the warp totals
  const int cnt = __popc(hm);
  const int incl = warp_incl_scan(cnt, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    const int v = lane < nwarps ? s_warp[lane] : 0;
    const int wi = warp_incl_scan(v, lane);
    __syncwarp();
    if (lane < nwarps) s_warp[lane] = wi - v;
    if (lane == 31) s_tot = wi;
  }
  __syncthreads();
  int k = s_warp[warp] + incl - cnt;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i)
    if (hm >> i & 1) s_pay[k + (k >> 4)] = (int32_t)pay[i], ++k;

  cluster.sync();  // every block's total and staged words are in place
  if (warp == 0) {
    const int C = (int)cluster.num_blocks();
    const int v = lane < C ? *cluster.map_shared_rank(&s_tot, lane) : 0;
    int lower = lane < r ? v : 0, total = v;
#pragma unroll
    for (int s = 16; s >= 1; s >>= 1) {
      lower += __shfl_xor_sync(FULL, lower, s);
      total += __shfl_xor_sync(FULL, total, s);
    }
    if (lane == 0) s_lower = lower, s_total = total;
  }
  __syncthreads();
  cluster_arrive();  // done with the peers' shared memory
  const int lower = s_lower, total = s_total, mine = s_tot;
  int32_t* prow = packed + row;
  for (int i = t; i < mine; i += blockDim.x)
    prow[lower + i] = s_pay[i + (i >> 4)];
  // zero tail of this tile: positions [max(total, start), end)
  const int z_end = w_hi * 32;
  const int z = max(total, w_lo * 32);
  const int z4 = min((z + 3) & ~3, z_end);
  if (t < z4 - z) prow[z + t] = 0;
  for (int i = z4 + 4 * t; i < z_end; i += 4 * blockDim.x)
    *reinterpret_cast<int4*>(prow + i) = make_int4(0, 0, 0, 0);
  if (r == 0 && t == 0) count[blockIdx.y] = total;
  cluster_wait();  // the peers have read this block's total
}

int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// The largest chunk and row count s4_pack takes (no launch).
int s4_pack_max_chunk() { return MAX_CHUNK; }
int s4_pack_max_rows() { return MAX_ROWS; }

// lens, dists: int32 [B][chunk]; conv, lk: bytes [B][chunk]; bits, cbits,
// kbits: [B][chunk / 32]; packed: [B][chunk]; count: [B]; every pointer on
// 16 bytes.  One cluster launch.
int s4_pack(const int32_t* lens, const int32_t* dists, const uint8_t* conv,
            const uint8_t* lk, int32_t* bits, int32_t* packed, int32_t* count,
            int32_t* cbits, int32_t* kbits, int B, int chunk, void* stream) {
  if (B < 1 || B > MAX_ROWS || chunk < 32 || chunk > MAX_CHUNK || chunk % 32)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)lens | (uintptr_t)dists | (uintptr_t)conv | (uintptr_t)lk |
       (uintptr_t)packed) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int n_words = chunk / 32;
  const int C = min(MAX_CLUSTER,
                    next_pow2((n_words + MIN_WORDS - 1) / MIN_WORDS));
  const int wpb = (n_words + C - 1) / C;  // at most MAX_WORDS
  const int threads = (2 * wpb + 31) & ~31;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, pack_cluster_kernel, lens, dists, conv, lk,
                         bits, packed, count, cbits, kbits, chunk, wpb);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
