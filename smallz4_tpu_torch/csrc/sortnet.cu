// Record sort and merge for the chunk matcher (Hopper, sm_90a).
//
// Replaces the TPU kernels of smallz4_tpu/ops/sortnet.py:
//   * sort_records -> _bitonic_kernel_unrolled (sortnet.py:164) and its
//     fori_loop twin _bitonic_kernel_compact (sortnet.py:138), which
//     computes the same sort;
//   * merge_sorted -> its inner bitonic merge kernel (sortnet.py:276).
//
// Records are int32 planes laid out [B][P][n] (B independent rows, P planes
// of n words each).  The first n_keys planes are compared as unsigned
// words; unless `unique`, plane n_keys is a signed int32 tiebreak (pos).
// Both kernels are stable: on equal keys the record of lower input index
// (of run A in a merge) goes first, so they equal the plain version's
// stable torch.sort passes even where keys tie.
//
// Bound: a 2^16-record, 6-plane row is 1.5 MiB, far above one SM's 227 KB
// of shared memory, and the work per record is a few word compares, so
// the sort is bound by memory traffic.  The least traffic of this design
// is (1 + passes) x 2 x the bytes of the [B, P, n] array: one read and one
// write for the tile sort and for each of the log2(n / tile) merge passes.
//
// Design: every global read is a 16-byte cp.async into shared memory and
// every global write a 16-byte store of consecutive outputs, and each
// block does all its compares in shared memory or registers.
//   * sort_tiles_kernel sorts tiles of TILE (4096) records, one tile per
//     block of 512 threads: each thread sorts SORT_ITEMS (8) consecutive
//     records in registers (odd-even transposition network on their
//     indices), then the block merges runs of 8, 16, ... records by merge
//     path over a uint16 permutation in shared memory, and writes the tile
//     out in that order.
//   * merge_pass_kernel merges adjacent sorted runs of width w: one block
//     makes one window of MERGE_T (2048) outputs with 256 threads.  Two
//     warps find the window's two merge-path splits by a 32-way search over
//     the runs in device memory (4 rounds at w = 2^16), the block stages
//     both input ranges of every plane in shared memory, each thread merges
//     MERGE_ITEMS (8) outputs there, and the block writes the window plane
//     by plane.  (At 6 planes a merge block holds 54 KB, four to an SM.)
//     merge_sorted is one such pass at w = n / 2.
//   * Compares read the first two key words as one uint64 and touch the
//     other planes only when those tie.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_PLANES = 8;
constexpr int TILE = 4096;     // records per tile sort block
constexpr int MERGE_T = 2048;  // outputs per merge block
constexpr int SORT_ITEMS = 8;    // records per thread of the tile sort
constexpr int MERGE_ITEMS = 8;   // outputs per thread of a merge pass
constexpr int SORT_THREADS = TILE / SORT_ITEMS;
constexpr int MERGE_THREADS = MERGE_T / MERGE_ITEMS;
static_assert(TILE <= 65536 && MERGE_T + 16 <= 65536, "uint16 indices");

// Record qa < record qb over the planes after the head: keys 2..n_keys-1
// unsigned, then the signed tiebreak.  Out of line: heads rarely tie.
__device__ __noinline__ bool tail_less(const int32_t* base, int stride,
                                       int n_keys, int unique, int qa,
                                       int qb) {
  for (int p = 2; p < n_keys; ++p) {
    const uint32_t a = static_cast<uint32_t>(base[p * stride + qa]);
    const uint32_t b = static_cast<uint32_t>(base[p * stride + qb]);
    if (a != b) return a < b;
  }
  if (!unique) return base[n_keys * stride + qa] < base[n_keys * stride + qb];
  return false;
}

// Record order over planes at `stride` from `base` (shared or device memory).
struct Keys {
  const int32_t* base;
  int stride;
  int n_keys;
  int unique;

  // the first two key words as one unsigned 64-bit key (the second 0 when
  // there is one key: plane 1 is then the signed tiebreak)
  __device__ __forceinline__ uint64_t head(int q) const {
    uint64_t h = static_cast<uint64_t>(static_cast<uint32_t>(base[q])) << 32;
    if (n_keys > 1) h |= static_cast<uint32_t>(base[stride + q]);
    return h;
  }

  // record qa < record qb, with their heads already loaded
  __device__ __forceinline__ bool less(uint64_t ha, int qa, uint64_t hb,
                                       int qb) const {
    if (ha != hb) return ha < hb;
    return tail_less(base, stride, n_keys, unique, qa, qb);
  }

  __device__ __forceinline__ bool less(int qa, int qb) const {
    return less(head(qa), qa, head(qb), qb);
  }
};

// Runs seen through an index map: record i of a run is at q = map(i).
struct Offset {  // q = off + i
  int off;
  __device__ __forceinline__ int operator()(int i) const { return off + i; }
};
struct Permuted {  // q = perm[i]
  const uint16_t* perm;
  __device__ __forceinline__ int operator()(int i) const { return perm[i]; }
};

// Merge path: the number of A records among the first d outputs of a
// stable merge of A (na) and B (nb), by binary search.
template <class Seq>
__device__ int path_split(const Keys& k, Seq A, int na, Seq B, int nb, int d) {
  int lo = d > nb ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!k.less(B(d - 1 - mid), A(mid))) lo = mid + 1;  // A[mid] <= B[..]
    else hi = mid;
  }
  return lo;
}

// Merge N outputs from A[i..] and B[j..] (A first on ties) into
// out[0..N), as record indices q.
template <int N, class Seq>
__device__ __forceinline__ void serial_merge(const Keys& k, Seq A, int na,
                                             Seq B, int nb, int i, int j,
                                             uint16_t* out) {
  int qa = i < na ? A(i) : 0, qb = j < nb ? B(j) : 0;
  uint64_t ha = i < na ? k.head(qa) : 0, hb = j < nb ? k.head(qb) : 0;
#pragma unroll
  for (int o = 0; o < N; ++o) {
    const bool take_a = j >= nb || (i < na && !k.less(hb, qb, ha, qa));
    if (take_a) {
      out[o] = static_cast<uint16_t>(qa);
      if (++i < na) { qa = A(i); ha = k.head(qa); }
    } else {
      out[o] = static_cast<uint16_t>(qb);
      if (++j < nb) { qb = B(j); hb = k.head(qb); }
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Write `count` outputs of every plane: output o of plane p is
// sm[p * stride + order[o]]; 16-byte stores, neighbouring threads on
// neighbouring addresses.
__device__ __forceinline__ void store_gathered(const int32_t* sm, int stride,
                                               const uint16_t* order,
                                               int32_t* dst, int P, int n,
                                               int count) {
  for (int p = 0; p < P; ++p) {
    const int32_t* plane = sm + p * stride;
    int4* d4 = reinterpret_cast<int4*>(dst + (size_t)p * n);
    for (int c = threadIdx.x; c < count / 4; c += blockDim.x) {
      const uint2 o = reinterpret_cast<const uint2*>(order)[c];
      int4 v;
      v.x = plane[o.x & 0xFFFF];
      v.y = plane[o.x >> 16];
      v.z = plane[o.y & 0xFFFF];
      v.w = plane[o.y >> 16];
      d4[c] = v;
    }
  }
}

// Sort one tile of `tile` records per block (blockIdx.y = row), ascending
// and stable.  Shared memory: [P][tile] words, then two uint16[tile]
// permutations.
__global__ void __launch_bounds__(SORT_THREADS, 2)
    sort_tiles_kernel(const int32_t* __restrict__ in,
                      int32_t* __restrict__ out, int P, int n, int n_keys,
                      int unique, int tile) {
  extern __shared__ __align__(16) int32_t sm[];
  uint16_t* const perm = reinterpret_cast<uint16_t*>(sm + P * tile);
  const size_t row = (size_t)blockIdx.y * P * n;
  const int t0 = blockIdx.x * tile;
  const int32_t* src = in + row + t0;
  for (int p = 0; p < P; ++p)
    for (int c = threadIdx.x; c < tile / 4; c += blockDim.x)
      cp_async16(sm + p * tile + 4 * c, src + (size_t)p * n + 4 * c);
  cp_async_wait_all();
  __syncthreads();

  const Keys k{sm, tile, n_keys, unique};
  const int first = threadIdx.x * SORT_ITEMS;
  {  // SORT_ITEMS consecutive records per thread, sorted in registers
    uint64_t h[SORT_ITEMS];
    int q[SORT_ITEMS];
#pragma unroll
    for (int i = 0; i < SORT_ITEMS; ++i) {
      q[i] = first + i;
      h[i] = k.head(q[i]);
    }
    // odd-even transposition: swaps only adjacent records out of order,
    // so equal records keep their order
#pragma unroll
    for (int r = 0; r < SORT_ITEMS; ++r) {
#pragma unroll
      for (int i = r & 1; i + 1 < SORT_ITEMS; i += 2) {
        if (k.less(h[i + 1], q[i + 1], h[i], q[i])) {
          const uint64_t th = h[i]; h[i] = h[i + 1]; h[i + 1] = th;
          const int tq = q[i]; q[i] = q[i + 1]; q[i + 1] = tq;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < SORT_ITEMS; ++i)
      perm[first + i] = static_cast<uint16_t>(q[i]);
  }
  __syncthreads();

  int cur = 0;  // the permutation in use: perm + cur * tile
  for (int r = SORT_ITEMS; r < tile; r <<= 1) {  // runs of r -> runs of 2r
    const uint16_t* runs = perm + cur * tile + (first & ~(2 * r - 1));
    const int d = first & (2 * r - 1);
    const Permuted A{runs}, B{runs + r};
    const int i = path_split(k, A, r, B, r, d);
    serial_merge<SORT_ITEMS>(k, A, r, B, r, i, d - i,
                             perm + (1 - cur) * tile + first);
    cur = 1 - cur;
    __syncthreads();
  }
  store_gathered(sm, tile, perm + cur * tile, out + row + t0, P, n, tile);
}

// The number of run-A records among the first d outputs of the merge of
// runs A = rec[a0, a0 + w) and B = rec[b0, b0 + w) in device memory: a
// 32-way search by one warp (every lane returns it).
__device__ int warp_split(const Keys& g, int a0, int b0, int w, int d) {
  const int lane = threadIdx.x & 31;
  int lo = d > w ? d - w : 0;
  int hi = d < w ? d : w;
  while (lo < hi) {  // the answer lies in [lo, hi]
    const int s = (hi - lo + 31) >> 5;
    const int i = lo + lane * s;
    const bool a_first = i < hi && !g.less(b0 + d - 1 - i, a0 + i);
    const int c = __popc(__ballot_sync(0xFFFFFFFFu, a_first));
    if (c == 0) {
      hi = lo;
    } else {
      const int next = lo + (c - 1) * s + 1;
      hi = min(lo + c * s, hi);
      lo = next;
    }
  }
  return lo;
}

// Merge adjacent sorted runs of width w into runs of width 2w: one block
// per window of `win` outputs (win divides 2w).  Shared memory: [P][win +
// 16] words (the A range, then the B range, each widened to 16-byte
// boundaries), then uint16[win] output order.
__global__ void __launch_bounds__(MERGE_THREADS, 2)
    merge_pass_kernel(const int32_t* __restrict__ in,
                      int32_t* __restrict__ out, int P, int n, int n_keys,
                      int unique, int w, int win) {
  extern __shared__ __align__(16) int32_t sm[];
  __shared__ int split[2];
  const int stride = win + 16;
  uint16_t* order = reinterpret_cast<uint16_t*>(sm + P * stride);
  const size_t row = (size_t)blockIdx.y * P * n;
  const int32_t* src = in + row;
  const int o0 = blockIdx.x * win;
  const int pair0 = o0 & ~(2 * w - 1);
  const int d0 = o0 - pair0;

  const Keys g{src, n, n_keys, unique};
  for (int s = threadIdx.x >> 5; s < 2; s += blockDim.x >> 5) {
    const int a = warp_split(g, pair0, pair0 + w, w, d0 + s * win);
    if ((threadIdx.x & 31) == 0) split[s] = a;
  }
  __syncthreads();
  const int a0 = split[0], a1 = split[1];
  const int b0 = d0 - a0, b1 = d0 + win - a1;
  const int fa = a0 & ~3, span_a = ((a1 + 3) & ~3) - fa;
  const int fb = b0 & ~3, span_b = ((b1 + 3) & ~3) - fb;
  for (int p = 0; p < P; ++p) {
    const int32_t* plane = src + (size_t)p * n + pair0;
    int32_t* s = sm + p * stride;
    for (int c = threadIdx.x; c < (span_a + span_b) / 4; c += blockDim.x) {
      if (4 * c < span_a) cp_async16(s + 4 * c, plane + fa + 4 * c);
      else cp_async16(s + 4 * c, plane + w + fb + 4 * c - span_a);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const Keys k{sm, stride, n_keys, unique};
  const Offset A{a0 - fa}, B{span_a + b0 - fb};
  const int na = a1 - a0, nb = b1 - b0;
  const int d = threadIdx.x * MERGE_ITEMS;
  if (d < win) {
    const int i = path_split(k, A, na, B, nb, d);
    serial_merge<MERGE_ITEMS>(k, A, na, B, nb, i, d - i, order + d);
  }
  __syncthreads();
  store_gathered(sm, stride, order, out + row + o0, P, n, win);
}

size_t tile_smem(int P, int tile) {
  return (size_t)P * tile * sizeof(int32_t) + 2 * tile * sizeof(uint16_t);
}

size_t merge_smem(int P, int win) {
  return (size_t)P * (win + 16) * sizeof(int32_t) + win * sizeof(uint16_t);
}

int merge_pass(const int32_t* in, int32_t* out, int B, int P, int n,
               int n_keys, int unique, int w, cudaStream_t stream) {
  const int win = 2 * w < MERGE_T ? 2 * w : MERGE_T;
  const int threads = win < 32 * MERGE_ITEMS ? 32 : win / MERGE_ITEMS;
  dim3 grid(n / win, B);
  merge_pass_kernel<<<grid, threads, merge_smem(P, win), stream>>>(
      in, out, P, n, n_keys, unique, w, win);
  return (int)cudaGetLastError();
}

int set_smem_limits(int P) {
  cudaError_t e = cudaFuncSetAttribute(
      sort_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tile_smem(P, TILE));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(merge_pass_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)merge_smem(P, MERGE_T));
}

bool valid_args(const int32_t* in, int B, int P, int n, int n_keys,
                int unique) {
  if (B < 1 || P < 1 || P > MAX_PLANES) return false;
  if (n < 16 || (n & (n - 1)) != 0) return false;
  if (n_keys < 1 || n_keys + (unique ? 0 : 1) > P) return false;
  return (reinterpret_cast<uintptr_t>(in) & 15) == 0;  // 16-byte loads
}

}  // namespace

extern "C" {

const char* s4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Records per tile of the sort at n records (the merge passes number
// log2(n / tile)).
int s4_sort_tile(int n) { return n < TILE ? n : TILE; }

// Sort every row of `in` into `out`; `tmp` is scratch of the same size.
// Launches one tile sort and log2(n / tile) merge passes on `stream`.
// `in` must be 16-byte aligned (as `out` and `tmp` from the allocator).
int s4_sort_records(const int32_t* in, int32_t* out, int32_t* tmp, int B,
                    int P, int n, int n_keys, int unique, void* stream) {
  if (!valid_args(in, B, P, n, n_keys, unique))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = set_smem_limits(P);
  if (err) return err;
  const int tile = s4_sort_tile(n);
  int passes = 0;
  for (int w = tile; w < n; w <<= 1) ++passes;
  // ping-pong so that the last pass lands in `out`
  int32_t* bufs[2] = {out, tmp};
  int cur = passes % 2;
  sort_tiles_kernel<<<dim3(n / tile, B), tile / SORT_ITEMS,
                      tile_smem(P, tile), s>>>(in, bufs[cur], P, n, n_keys,
                                               unique, tile);
  err = (int)cudaGetLastError();
  if (err) return err;
  for (int w = tile; w < n; w <<= 1) {
    err = merge_pass(bufs[cur], bufs[1 - cur], B, P, n, n_keys, unique, w, s);
    if (err) return err;
    cur = 1 - cur;
  }
  return 0;
}

// Merge the two sorted halves of every row of `in` into `out`.
int s4_merge_halves(const int32_t* in, int32_t* out, int B, int P, int n,
                    int n_keys, int unique, void* stream) {
  if (!valid_args(in, B, P, n, n_keys, unique))
    return (int)cudaErrorInvalidValue;
  int err = set_smem_limits(P);
  if (err) return err;
  return merge_pass(in, out, B, P, n, n_keys, unique, n / 2,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
