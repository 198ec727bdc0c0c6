// Record sort and merge for the chunk matcher (Hopper, sm_90a).
//
// Replaces the TPU kernels of smallz4_tpu/ops/sortnet.py:
//   * sort_records -> _bitonic_kernel_unrolled (and its fori_loop twin
//     _bitonic_kernel_compact, which computes the same sort);
//   * merge_sorted -> its inner bitonic merge kernel.
//
// Records are int32 planes laid out [B][P][n] (B independent rows, P planes
// of n words each).  The first n_keys planes are compared as unsigned
// words; unless `unique`, plane n_keys is a signed int32 tiebreak (pos).
// Every main-path call has distinct keys, so any correct sort gives the
// bitonic network's output exactly.
//
// Bound: a 2^16-record, 6-plane chunk is 1.5 MiB, far above one SM's
// 227 KB of shared memory, and the work per record is a few word compares:
// the sort is bound by memory traffic and by the log(n) passes over it.
// Design: a bitonic sort of 2048-record tiles in dynamic shared memory
// (one block per tile, every row of the batch in blockIdx.y), then
// merge-path passes that double the sorted run width until it spans the
// row.  Each merge thread finds its diagonal split by binary search and
// merges MERGE_ITEMS outputs sequentially; the halves of merge_sorted are
// one such pass.  No pass reads more than the two runs it merges.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_PLANES = 8;
constexpr int TILE = 2048;
constexpr int MERGE_ITEMS = 8;
constexpr int MERGE_THREADS = 256;

// a < b over records (ka, ia) and (kb, ib): planes at stride n
__device__ __forceinline__ bool rec_less(const int32_t* pa, int ia,
                                         const int32_t* pb, int ib,
                                         int stride_a, int stride_b,
                                         int n_keys, int unique) {
  for (int p = 0; p < n_keys; ++p) {
    uint32_t a = static_cast<uint32_t>(pa[p * stride_a + ia]);
    uint32_t b = static_cast<uint32_t>(pb[p * stride_b + ib]);
    if (a != b) return a < b;
  }
  if (!unique) {
    int32_t a = pa[n_keys * stride_a + ia];
    int32_t b = pb[n_keys * stride_b + ib];
    return a < b;
  }
  return false;
}

// Bitonic sort of one tile of `tile` records per block, ascending.
__global__ void sort_tiles_kernel(const int32_t* __restrict__ in,
                                  int32_t* __restrict__ out, int P, int n,
                                  int n_keys, int unique, int tile) {
  extern __shared__ int32_t sm[];  // [P][tile]
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int32_t* src = in + (size_t)b * P * n;
  int32_t* dst = out + (size_t)b * P * n;
  for (int i = threadIdx.x; i < tile; i += blockDim.x)
    for (int p = 0; p < P; ++p) sm[p * tile + i] = src[(size_t)p * n + t0 + i];
  __syncthreads();
  const int half = tile >> 1;
  for (int k = 2; k <= tile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        int i = 2 * t - (t & (j - 1));  // bit j of i is clear
        int l = i + j;
        bool ascending = (i & k) == 0;
        bool swap = ascending
                        ? rec_less(sm, l, sm, i, tile, tile, n_keys, unique)
                        : rec_less(sm, i, sm, l, tile, tile, n_keys, unique);
        if (swap) {
          for (int p = 0; p < P; ++p) {
            int32_t v = sm[p * tile + i];
            sm[p * tile + i] = sm[p * tile + l];
            sm[p * tile + l] = v;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x)
    for (int p = 0; p < P; ++p) dst[(size_t)p * n + t0 + i] = sm[p * tile + i];
}

// Merge adjacent sorted runs of width w into runs of width 2w.  A-elements
// go first on equal keys (a stable merge).
__global__ void merge_runs_kernel(const int32_t* __restrict__ in,
                                  int32_t* __restrict__ out, int P, int n,
                                  int n_keys, int unique, int w) {
  const int b = blockIdx.y;
  const long long first = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                          * MERGE_ITEMS;
  if (first >= n) return;
  const int32_t* src = in + (size_t)b * P * n;
  int32_t* dst = out + (size_t)b * P * n;
  const int pair0 = (int)(first / (2 * w)) * (2 * w);
  const int32_t* A = src + pair0;      // run A = [pair0, pair0 + w)
  const int32_t* Bv = src + pair0 + w;  // run B = [pair0 + w, pair0 + 2w)
  const int d = (int)first - pair0;    // output diagonal inside the pair
  // merge path: i = number of A records among the first d outputs
  int lo = d > w ? d - w : 0;
  int hi = d < w ? d : w;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    // A[mid] <= B[d-1-mid]  <=>  !(B[d-1-mid] < A[mid])
    if (!rec_less(Bv, d - 1 - mid, A, mid, n, n, n_keys, unique))
      lo = mid + 1;
    else
      hi = mid;
  }
  int i = lo, j = d - lo;
  for (int o = 0; o < MERGE_ITEMS; ++o) {
    bool take_a;
    if (i >= w) take_a = false;
    else if (j >= w) take_a = true;
    else take_a = !rec_less(Bv, j, A, i, n, n, n_keys, unique);
    const int32_t* s = take_a ? A + i : Bv + j;
    for (int p = 0; p < P; ++p) dst[(size_t)p * n + pair0 + d + o] = s[(size_t)p * n];
    if (take_a) ++i; else ++j;
  }
}

int merge_pass(const int32_t* in, int32_t* out, int B, int P, int n,
               int n_keys, int unique, int w, cudaStream_t stream) {
  const int per_row = n / MERGE_ITEMS;
  dim3 grid((per_row + MERGE_THREADS - 1) / MERGE_THREADS, B);
  merge_runs_kernel<<<grid, MERGE_THREADS, 0, stream>>>(in, out, P, n, n_keys,
                                                        unique, w);
  return (int)cudaGetLastError();
}

bool valid_shape(int B, int P, int n, int n_keys, int unique) {
  if (B < 1 || P < 1 || P > MAX_PLANES) return false;
  if (n < 2 * MERGE_ITEMS || (n & (n - 1)) != 0) return false;
  if (n_keys < 1 || n_keys + (unique ? 0 : 1) > P) return false;
  return true;
}

}  // namespace

extern "C" {

const char* s4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Sort every row of `in` into `out`; `tmp` is scratch of the same size.
// Launches one tile sort and log2(n / 2048) merge passes on `stream`.
int s4_sort_records(const int32_t* in, int32_t* out, int32_t* tmp, int B,
                    int P, int n, int n_keys, int unique, void* stream) {
  if (!valid_shape(B, P, n, n_keys, unique)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile = n < TILE ? n : TILE;
  int passes = 0;
  for (int w = tile; w < n; w <<= 1) ++passes;
  // ping-pong so that the last pass lands in `out`
  int32_t* bufs[2] = {out, tmp};
  int cur = passes % 2;
  const size_t smem = (size_t)tile * P * sizeof(int32_t);
  cudaError_t e = cudaFuncSetAttribute(
      sort_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n / tile, B);
  const int threads = tile / 2 < 1024 ? tile / 2 : 1024;
  sort_tiles_kernel<<<grid, threads, smem, s>>>(in, bufs[cur], P, n, n_keys,
                                                unique, tile);
  int err = (int)cudaGetLastError();
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
  if (!valid_shape(B, P, n, n_keys, unique)) return (int)cudaErrorInvalidValue;
  return merge_pass(in, out, B, P, n, n_keys, unique, n / 2,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
