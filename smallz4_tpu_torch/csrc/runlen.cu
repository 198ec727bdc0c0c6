// Equal-byte run lengths (Hopper, sm_90a).
//
// Replaces the TPU kernel smallz4_tpu/ops/pallas_kernels.py
// _run_lengths_kernel (run_lengths): for every row of a batch of byte rows
// [B][n], R[i] = the length of the maximal run of equal bytes that starts at
// i, that is nb(i) - i + 1 where nb(i) is the nearest run boundary at or
// after i (i is a boundary when x[i] != x[i+1]; the last byte of a row
// always is).
//
// Bound: one byte in and four out per element, a few operations each:
// memory bound.  A forward walk per thread would be quadratic on long runs
// (an all-zero row is one run of n bytes), so the kernel is a real suffix-min
// scan of boundary indices in three launches: (1) per 1024-element tile, a
// suffix-min in registers and shared memory (warp shuffles, then across the
// tile's 32 warps), written to `out`, and the tile's minimum; (2) per row,
// the exclusive suffix-min of the tile minima, right to left in slices of
// 1024 tiles; (3) per element, the combine min(local, carry) - i + 1.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int RL_THREADS = 1024;  // one element per thread; 32 warps
constexpr unsigned FULL = 0xFFFFFFFFu;

// Inclusive suffix-min of one value per thread across a block of
// RL_THREADS threads; `sh` holds 32 ints of shared memory.
__device__ int block_suffix_min(int v, int* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_down_sync(FULL, v, off);
    if (lane + off < 32) v = min(v, o);
  }
  if (lane == 0) sh[warp] = v;  // the warp's minimum
  __syncthreads();
  if (warp == 0) {
    int w = sh[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_down_sync(FULL, w, off);
      if (lane + off < 32) w = min(w, o);
    }
    int later = __shfl_down_sync(FULL, w, 1);  // min over the later warps
    sh[lane] = lane == 31 ? INT_MAX : later;
  }
  __syncthreads();
  v = min(v, sh[warp]);
  __syncthreads();  // `sh` may be reused after return
  return v;
}

__global__ void tile_kernel(const uint8_t* __restrict__ x,
                            int32_t* __restrict__ out,
                            int32_t* __restrict__ tile_min, int n, int tiles) {
  __shared__ int sh[32];
  const int b = blockIdx.y;
  const int i = blockIdx.x * RL_THREADS + threadIdx.x;
  const uint8_t* row = x + (size_t)b * n;
  int v = INT_MAX;
  if (i < n && (i == n - 1 || row[i] != row[i + 1])) v = i;
  v = block_suffix_min(v, sh);
  if (i < n) out[(size_t)b * n + i] = v;
  if (threadIdx.x == 0) tile_min[(size_t)b * tiles + blockIdx.x] = v;
}

__global__ void carry_kernel(const int32_t* __restrict__ tile_min,
                             int32_t* __restrict__ carry, int tiles) {
  __shared__ int sh[32];
  __shared__ int incl[RL_THREADS];
  __shared__ int run;  // minimum over the slices already done
  const int b = blockIdx.x;
  const int32_t* tm = tile_min + (size_t)b * tiles;
  int32_t* cr = carry + (size_t)b * tiles;
  if (threadIdx.x == 0) run = INT_MAX;
  __syncthreads();
  for (int s0 = ((tiles - 1) / RL_THREADS) * RL_THREADS; s0 >= 0;
       s0 -= RL_THREADS) {
    const int t = s0 + threadIdx.x;
    int v = t < tiles ? tm[t] : INT_MAX;
    v = block_suffix_min(v, sh);
    incl[threadIdx.x] = v;
    __syncthreads();
    const int r = run;
    const int later = threadIdx.x + 1 < RL_THREADS ? incl[threadIdx.x + 1]
                                                   : INT_MAX;
    if (t < tiles) cr[t] = min(later, r);
    __syncthreads();
    if (threadIdx.x == 0) run = min(r, incl[0]);
    __syncthreads();
  }
}

__global__ void combine_kernel(int32_t* __restrict__ out,
                               const int32_t* __restrict__ carry, int n,
                               int tiles) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * RL_THREADS + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)b * n + i;
  out[o] = min(out[o], carry[(size_t)b * tiles + blockIdx.x]) - i + 1;
}

}  // namespace

extern "C" {

// Run lengths of every row of `x` ([B][n] bytes) into `out` ([B][n] int32).
// `scratch` holds 2 * B * ceil(n / 1024) int32.
int s4_run_lengths(const uint8_t* x, int32_t* out, int32_t* scratch, int B,
                   int n, void* stream) {
  if (B < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + RL_THREADS - 1) / RL_THREADS;
  int32_t* tile_min = scratch;
  int32_t* carry = scratch + (size_t)B * tiles;
  dim3 grid(tiles, B);
  tile_kernel<<<grid, RL_THREADS, 0, s>>>(x, out, tile_min, n, tiles);
  int err = (int)cudaGetLastError();
  if (err) return err;
  carry_kernel<<<B, RL_THREADS, 0, s>>>(tile_min, carry, tiles);
  err = (int)cudaGetLastError();
  if (err) return err;
  combine_kernel<<<grid, RL_THREADS, 0, s>>>(out, carry, n, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
