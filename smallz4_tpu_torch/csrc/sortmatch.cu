// Neighbour scan and same-distance chain of the sort search (Hopper, sm_90a).
//
// Replaces the TPU kernels of smallz4_tpu/ops/sortmatch.py:
//   * s4_scan  -> _scan_kernel (_neighbor_scan), and the unsort that follows
//     it there (the second sort_records call, keyed by the raw position);
//   * s4_chain -> _chain_kernel (_chain).
//
// Scan.  `rec` holds a batch of sorted record rows laid out [B][5][n] int32:
// planes k1 (4-byte gram), k2 (prefix hash, unused here), pos_t (position,
// +2^30 for records that may not match), e1 and e2 (the next two 4-byte
// little-endian words).  Every sorted slot probes the slots at +-{1..8, 12,
// 16, 24, 32, 48, 64} of its own row.  A neighbour with the same gram at a
// distance of 1..65535 is a candidate; its length is 4 plus the equal
// leading bytes of the two payload words (4..12, byte-verified); the longest
// wins and the nearest breaks a tie.  Flags: bit 0, the length reached the
// 12-byte verification reach; bit 1, a neighbour at +-8 shares the gram
// (the group may extend beyond the contiguous probes), whatever its
// distance.  The raw positions (pos_t & (2^30 - 1)) of a row are a
// permutation of [0, n), so storing each result at its raw position is the
// reference's unsort.
//
// Bound: the scan reads 16 bytes and writes 12 per record; its 28 probes
// take some 20 integer operations each, which puts it at the border of the
// memory and the instruction rate.  Design: one thread per sorted slot; a
// block stages its 256-slot tile and a +-64-slot halo of the four planes in
// shared memory, so the probes read shared memory only; the stores are
// scattered.
//
// Chain.  Position-order lengths and distances [B][n]: `steps` doubling
// steps len[p] = max(len[p], s + len[p+s]) where dist[p] == dist[p+s] >= 1
// and len[p] >= s, s = 1, 2, 4, ...  Each step reads the previous step's
// lengths (the reference rebinds the whole array per step), so an in-place
// pass would read half-updated values.  Design: one launch per step,
// ping-pong between the output and a scratch buffer; 12 bytes per record per
// step, memory bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int MAX_PROBE = 64;
constexpr int N_PROBES = 14;
constexpr int MAX_DISTANCE = 65535;
constexpr int EXT_REACH = 12;
constexpr uint32_t POS_MASK = (1u << 30) - 1;
constexpr int CHAIN_THREADS = 256;

// equal leading bytes of a little-endian xor word: its trailing zero bytes,
// 4 when the words are equal (__clz(0) == 32)
__device__ __forceinline__ int zero_bytes(uint32_t x) {
  return __clz(__brev(x)) >> 3;
}

__global__ void scan_kernel(const int32_t* __restrict__ rec,
                            int32_t* __restrict__ olen,
                            int32_t* __restrict__ odist,
                            int32_t* __restrict__ oflag, int n) {
  constexpr int W = SCAN_THREADS + 2 * MAX_PROBE;
  __shared__ int32_t s_k1[W];
  __shared__ int32_t s_pos[W];
  __shared__ uint32_t s_e1[W];
  __shared__ uint32_t s_e2[W];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * SCAN_THREADS;
  const int32_t* k1 = rec + (size_t)b * 5 * n;
  const int32_t* pos = k1 + 2 * (size_t)n;
  const int32_t* e1 = k1 + 3 * (size_t)n;
  const int32_t* e2 = k1 + 4 * (size_t)n;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const int g = t0 - MAX_PROBE + i;
    if (g >= 0 && g < n) {
      s_k1[i] = k1[g];
      s_pos[i] = pos[g];
      s_e1[i] = static_cast<uint32_t>(e1[g]);
      s_e2[i] = static_cast<uint32_t>(e2[g]);
    }
  }
  __syncthreads();
  const int slot = t0 + threadIdx.x;
  if (slot >= n) return;
  const int c = threadIdx.x + MAX_PROBE;
  const int32_t mk = s_k1[c];
  const int32_t mp = s_pos[c];
  const uint32_t me1 = s_e1[c];
  const uint32_t me2 = s_e2[c];
  const int probes[N_PROBES] = {1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 24, 32, 48, 64};
  int best_len = 0, best_dist = 0;
  bool group_more = false;
#pragma unroll
  for (int q = 0; q < N_PROBES; ++q) {
#pragma unroll
    for (int sgn = 1; sgn >= -1; sgn -= 2) {
      const int k = probes[q] * sgn;
      if (slot + k < 0 || slot + k >= n) continue;  // per-row range
      const int cj = c + k;
      if (s_k1[cj] != mk) continue;
      if (probes[q] == 8) group_more = true;
      const int d = mp - s_pos[cj];
      if (d < 1 || d > MAX_DISTANCE) continue;
      const uint32_t x1 = me1 ^ s_e1[cj];
      const int w1 = zero_bytes(x1);
      const int lcp = 4 + (w1 < 4 ? w1 : 4 + zero_bytes(me2 ^ s_e2[cj]));
      if (lcp > best_len || (lcp == best_len && d < best_dist)) {
        best_len = lcp;
        best_dist = d;
      }
    }
  }
  const uint32_t dst = static_cast<uint32_t>(mp) & POS_MASK;
  if (dst >= static_cast<uint32_t>(n)) return;  // not a permutation row
  const size_t o = (size_t)b * n + dst;
  olen[o] = best_len;
  odist[o] = best_dist;
  oflag[o] = (best_len >= EXT_REACH ? 1 : 0) | (group_more ? 2 : 0);
}

__global__ void chain_step_kernel(const int32_t* __restrict__ len_in,
                                  const int32_t* __restrict__ dist,
                                  int32_t* __restrict__ len_out, int n,
                                  int s, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int p = (int)(i % n);
  int ln = len_in[i];
  const int d = dist[i];
  if (p + s < n && d >= 1 && ln >= s && dist[i + s] == d) {
    const int ext = s + len_in[i + s];
    ln = ext > ln ? ext : ln;
  }
  len_out[i] = ln;
}

}  // namespace

extern "C" {

// Probe every sorted slot of `rec` ([B][5][n]) and store (len, dist, flags)
// at each record's raw position in `olen`, `odist`, `oflag` ([B][n]).
int s4_scan(const int32_t* rec, int32_t* olen, int32_t* odist, int32_t* oflag,
            int B, int n, void* stream) {
  if (B < 1 || n < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((n + SCAN_THREADS - 1) / SCAN_THREADS, B);
  scan_kernel<<<grid, SCAN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rec, olen, odist, oflag, n);
  return (int)cudaGetLastError();
}

// `steps` doubling steps over `lens`/`dists` ([B][n]) into `out`; `tmp` is
// scratch of the same size.  `lens` is not modified.
int s4_chain(const int32_t* lens, const int32_t* dists, int32_t* out,
             int32_t* tmp, int B, int n, int steps, void* stream) {
  if (B < 1 || n < 1 || steps < 0 || steps > 30)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)B * n;
  if (steps == 0) {
    return (int)cudaMemcpyAsync(out, lens, total * sizeof(int32_t),
                                cudaMemcpyDeviceToDevice, s);
  }
  const unsigned blocks = (unsigned)((total + CHAIN_THREADS - 1) / CHAIN_THREADS);
  const int32_t* src = lens;
  for (int i = 0; i < steps; ++i) {
    // ping-pong so that the last step lands in `out`
    int32_t* dst = ((steps - 1 - i) % 2 == 0) ? out : tmp;
    chain_step_kernel<<<blocks, CHAIN_THREADS, 0, s>>>(src, dists, dst, n,
                                                       1 << i, total);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    src = dst;
  }
  return 0;
}

}  // extern "C"
