// Head/delta packing of position-order claims (Hopper, sm_90a).
//
// Replaces the TPU kernel smallz4_tpu/ops/chunkmatch.py:_pack_kernel
// (pack_results).  Per chunk row: a position is a head unless its claim
// is the one predicted from its predecessor ((len-1, same dist) after
// len >= 5; 65535 held flat after a saturated claim; else (1, 0)); slot 0
// is always a head.  Outputs the head, conv and lk bitmask words (bit i of
// word w = position 32w + i, little-endian bit order), the compacted
// min(len, 65535) << 16 | dist words at the head ranks (zero beyond the
// head count), and the head count.
//
// Bound: memory, ~10 bytes read and ~4 written per position, plus a scan
// that orders the heads.  Design: one block per chunk walks it in tiles of
// blockDim positions; the three bitmask words of each warp come from
// __ballot_sync (lane i -> bit i), and the head ranks from a block scan
// written by hand (warp popcounts, one warp scanning the warp totals, a
// running carry across tiles).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void pack_kernel(const int32_t* __restrict__ lens,
                            const int32_t* __restrict__ dists,
                            const uint8_t* __restrict__ conv,
                            const uint8_t* __restrict__ lk,
                            int32_t* __restrict__ bits,
                            int32_t* __restrict__ packed,
                            int32_t* __restrict__ count,
                            int32_t* __restrict__ cbits,
                            int32_t* __restrict__ kbits, int chunk) {
  __shared__ int warp_tot[32];
  __shared__ int warp_off[32];
  __shared__ int tile_tot;
  __shared__ int carry;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t base = (size_t)b * chunk;
  const size_t wbase = (size_t)b * (chunk / 32);
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int t0 = 0; t0 < chunk; t0 += blockDim.x) {
    const int pos = t0 + threadIdx.x;
    const bool active = pos < chunk;
    bool head = false;
    int cv = 0, kv = 0;
    uint32_t pay = 0;
    if (active) {
      const int L = lens[base + pos];
      const int D = dists[base + pos];
      if (pos == 0) {
        head = true;
      } else {
        const int pl = lens[base + pos - 1];
        const int pd = dists[base + pos - 1];
        const int pred_len = pl == 65535 ? 65535 : (pl >= 5 ? pl - 1 : 1);
        const int pred_dist = pl >= 5 ? pd : 0;
        head = L != pred_len || D != pred_dist;
      }
      pay = ((uint32_t)min(L, 65535) << 16) | ((uint32_t)D & 0xFFFFu);
      cv = conv[base + pos] & 1;
      kv = lk[base + pos] & 1;
    }
    const uint32_t hm = __ballot_sync(0xFFFFFFFFu, head);
    const uint32_t cm = __ballot_sync(0xFFFFFFFFu, cv);
    const uint32_t km = __ballot_sync(0xFFFFFFFFu, kv);
    if (lane == 0 && active) {
      bits[wbase + (pos >> 5)] = (int32_t)hm;
      cbits[wbase + (pos >> 5)] = (int32_t)cm;
      kbits[wbase + (pos >> 5)] = (int32_t)km;
      warp_tot[warp] = __popc(hm);
    } else if (lane == 0) {
      warp_tot[warp] = 0;
    }
    __syncthreads();
    if (warp == 0) {
      const int v = lane < nwarps ? warp_tot[lane] : 0;
      int incl = v;
      for (int s = 1; s < 32; s <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, incl, s);
        if (lane >= s) incl += y;
      }
      warp_off[lane] = incl - v;
      if (lane == 31) tile_tot = incl;
    }
    __syncthreads();
    if (head) {
      const int rank = carry + warp_off[warp] + __popc(hm & ((1u << lane) - 1u));
      packed[base + rank] = (int32_t)pay;
    }
    __syncthreads();
    if (threadIdx.x == 0) carry += tile_tot;
    __syncthreads();
  }
  const int total = carry;
  if (threadIdx.x == 0) count[b] = total;
  for (int i = total + threadIdx.x; i < chunk; i += blockDim.x)
    packed[base + i] = 0;
}

}  // namespace

extern "C" {

int s4_pack(const int32_t* lens, const int32_t* dists, const uint8_t* conv,
            const uint8_t* lk, int32_t* bits, int32_t* packed, int32_t* count,
            int32_t* cbits, int32_t* kbits, int B, int chunk, void* stream) {
  if (B < 1 || chunk < 32 || chunk % 32 != 0) return (int)cudaErrorInvalidValue;
  const int threads = chunk < 1024 ? chunk : 1024;
  pack_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      lens, dists, conv, lk, bits, packed, count, cbits, kbits, chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
