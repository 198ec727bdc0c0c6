// 4-byte grams and their hash (Hopper, sm_90a).
//
// Replaces the TPU kernel smallz4_tpu/ops/pallas_kernels.py
// _gram_hash_kernel (gram_hash): for every row of a batch of byte rows
// [B][n], gram[i] = x[i] | x[i+1] << 8 | x[i+2] << 16 | x[i+3] << 24 and
// hash[i] = (gram[i] * 48271 mod 2^32) >> 12 (the reference's LCG hash,
// smallz4.h:163-169), both int32.  Bytes past the end of a row read as the
// reference kernel lays them out: zero up to m, the row length rounded up to
// its 32768-element tile, and from m on the last tile's own first bytes
// (x[i - 32768]), because the last tile is its own successor there.
//
// Bound: one byte in and eight out per element, a handful of operations:
// memory bound.  Design: one thread per element; a warp's four byte loads
// and its two word stores each fall on consecutive addresses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GH_TILE = 256 * 128;  // the reference kernel's tile
constexpr uint32_t HASH_MULTIPLIER = 48271u;
constexpr int HASH_SHIFT = 32 - 20;  // 20 hash bits
constexpr int GH_THREADS = 256;

__device__ __forceinline__ uint32_t tail_byte(const uint8_t* row, int n, int m,
                                              int i) {
  if (i < n) return row[i];
  if (i < m) return 0;
  return row[i - GH_TILE];
}

__global__ void gram_hash_kernel(const uint8_t* __restrict__ x,
                                 int32_t* __restrict__ grams,
                                 int32_t* __restrict__ hashes, int n, int m) {
  const int i = blockIdx.x * GH_THREADS + threadIdx.x;
  if (i >= n) return;
  const size_t off = (size_t)blockIdx.y * n;
  const uint8_t* row = x + off;
  uint32_t g;
  if (i + 3 < n) {
    g = (uint32_t)row[i] | (uint32_t)row[i + 1] << 8
        | (uint32_t)row[i + 2] << 16 | (uint32_t)row[i + 3] << 24;
  } else {
    g = tail_byte(row, n, m, i) | tail_byte(row, n, m, i + 1) << 8
        | tail_byte(row, n, m, i + 2) << 16 | tail_byte(row, n, m, i + 3) << 24;
  }
  grams[off + i] = (int32_t)g;
  hashes[off + i] = (int32_t)((g * HASH_MULTIPLIER) >> HASH_SHIFT);
}

}  // namespace

extern "C" {

// Grams and hashes of every row of `x` ([B][n] bytes) into `grams` and
// `hashes` ([B][n] int32 each).
int s4_gram_hash(const uint8_t* x, int32_t* grams, int32_t* hashes, int B,
                 int n, void* stream) {
  if (B < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const int m = (n + GH_TILE - 1) / GH_TILE * GH_TILE;
  dim3 grid((n + GH_THREADS - 1) / GH_THREADS, B);
  gram_hash_kernel<<<grid, GH_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, grams, hashes, n, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
