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
// Bound: pure data movement, 16 bytes read and at most 8 written per slot;
// the reads are coalesced and the writes land in a 512 KiB window per row.
// Design: one thread per merged slot, no shared memory, no atomics (the
// destinations are distinct).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void compact_scatter_kernel(const int32_t* __restrict__ key,
                                       const int32_t* __restrict__ payload,
                                       int32_t* __restrict__ okey,
                                       int32_t* __restrict__ opay, int n,
                                       int chunk) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t src = (size_t)b * n + i;
  const uint32_t k = static_cast<uint32_t>(key[src]);
  if (k >= 16u * (uint32_t)chunk) return;  // halo record: dropped
  const size_t dst = (size_t)b * chunk + (k >> 4);
  okey[dst] = (int32_t)k;
  opay[dst] = payload[src];
}

}  // namespace

extern "C" {

int s4_compact(const int32_t* key, const int32_t* payload, int32_t* okey,
               int32_t* opay, int B, int n, int chunk, void* stream) {
  if (B < 1 || n < chunk || chunk < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  dim3 grid((n + threads - 1) / threads, B);
  compact_scatter_kernel<<<grid, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      key, payload, okey, opay, n, chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
