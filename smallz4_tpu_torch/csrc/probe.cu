// Neighbour probes over merged suffix-ordered records (Hopper, sm_90a).
//
// Replaces the TPU kernel smallz4_tpu/ops/chunkmatch.py:_probe_kernel.
// Input: the merged (halo chunk, current chunk) records, 6 int32 planes
// [B][6][n] with n = 2 * chunk (five big-endian key words, then combo).
// For every slot it finds the best (len, dist) among the records at suffix
// order offsets +-k for k in the probe set, byte-verified to 20 bytes, with
// the block match cap applied before the nearest-distance tie-break, the
// boundary-cut exclusion, and the edge-LCP / nearest-sharer certificate
// flags.  Outputs payload = len << 16 | dist and
// key = (local << 4) | flags (halo records: 16 * chunk).
//
// Each probe LCP is a direct 5-word compare.  The reference's composed
// min-table (PROBE_LCP=composed) gives bit-identical values on sorted
// records, so either setting of that switch maps here.
//
// Bound: every slot reads up to 2 * |probes| neighbour records (34 by
// default) of 6 words, about 800 bytes of reads per 8 bytes written, all
// at small static offsets.  Design: a block stages its tile of slots plus a
// +-max(probe) halo of records in shared memory once, so the neighbour reads
// hit shared memory and device memory sees each record about
// (TILE + 2 * halo) / TILE times.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PLANES = 6;
constexpr int MAX_PROBES = 32;
constexpr int TILE = 256;
constexpr int POS_MASK = (1 << 17) - 1;
constexpr int KEY_REACH = 20;
constexpr int EXT_REACH = 20;
constexpr int MIN_MATCH = 4;
constexpr int MAX_DISTANCE = 65535;
constexpr int EDGE = 8;

struct ProbeSet {
  int n;
  int k[MAX_PROBES];
};

// leading equal bytes (0..4) of one big-endian xor word
__device__ __forceinline__ int be_bytes(uint32_t x) {
  return x == 0 ? 4 : (__clz(x) >> 3);
}

__global__ void probe_kernel(const int32_t* __restrict__ planes,
                             int32_t* __restrict__ payload,
                             int32_t* __restrict__ key,
                             const int32_t* __restrict__ cut_gram,
                             const int32_t* __restrict__ cut_pos,
                             const int32_t* __restrict__ match_limit, int n,
                             int chunk, ProbeSet ps, int halo) {
  extern __shared__ uint32_t sm[];  // [PLANES][TILE + 2 * halo]
  const int W = TILE + 2 * halo;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const int32_t* src = planes + (size_t)b * PLANES * n;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    int g = t0 - halo + i;
    bool in = g >= 0 && g < n;
    for (int p = 0; p < PLANES; ++p)
      sm[p * W + i] = in ? static_cast<uint32_t>(src[(size_t)p * n + g]) : 0u;
  }
  __syncthreads();
  const int slot = t0 + threadIdx.x;
  if (slot >= n) return;
  const int li = threadIdx.x + halo;
  uint32_t w[5];
  for (int p = 0; p < 5; ++p) w[p] = sm[p * W + li];
  const int32_t combo = static_cast<int32_t>(sm[5 * W + li]);
  const int32_t cg = cut_gram[b], cp = cut_pos[b], ml = match_limit[b];

  const int raw = combo & POS_MASK;
  const int local = raw - chunk;
  const int cap = local >= 0 ? max(ml - local, 0) : (1 << 30);
  int best_len = 0, best_dist = 0, elcp_lo = -1, elcp_hi = -1, gap = 0;

  for (int pi = 0; pi < ps.n; ++pi) {
    const int sk = ps.k[pi];
    for (int sgn = 1; sgn >= -1; sgn -= 2) {
      const int k = sk * sgn;
      if (slot + k < 0 || slot + k >= n) continue;  // out of range: no effect
      const int nl = li + k;
      int lcp = 0;
      for (int p = 0; p < 5; ++p) {
        int e = be_bytes(w[p] ^ sm[p * W + nl]);
        lcp += e;
        if (e < 4) break;
      }
      const int32_t nb_combo = static_cast<int32_t>(sm[5 * W + nl]);
      const int nb_raw = nb_combo & POS_MASK;
      const int d = raw - nb_raw;
      if (sk == EDGE) {
        if (sgn > 0) elcp_hi = lcp; else elcp_lo = lcp;  // lcp <= KEY_REACH
      }
      if (sk == 1 && sgn < 0)
        gap = (nb_combo >= 0 && d >= 1 && lcp >= KEY_REACH) ? d : 0;
      const bool cut_hit = static_cast<int32_t>(sm[nl]) == cg && nb_raw < cp;
      const bool ok = nb_combo >= 0 && d >= 1 && d <= MAX_DISTANCE && !cut_hit;
      if (!ok) continue;
      const int lcp_eff = min(lcp, cap);
      if (lcp_eff > best_len ||
          (lcp_eff == best_len && lcp_eff >= 1 && d < best_dist)) {
        best_len = lcp_eff;
        best_dist = d;
      }
    }
  }

  const int th = min(max(best_len, MIN_MATCH), KEY_REACH);
  const bool cert_fail = elcp_lo >= th || elcp_hi >= th;
  const int th_len = min(max(best_len + 1, MIN_MATCH), KEY_REACH);
  const bool len_fail = elcp_lo >= th_len || elcp_hi >= th_len ||
                        best_len >= KEY_REACH;
  const bool gap_hit = best_dist == gap && gap >= 1;
  const bool trunc = best_len >= EXT_REACH && cap > EXT_REACH;
  const int flags = (int)trunc | ((int)cert_fail << 1) | ((int)len_fail << 2) |
                    ((int)gap_hit << 3);
  const size_t o = (size_t)b * n + slot;
  payload[o] = (best_len << 16) | best_dist;
  key[o] = local >= 0 ? ((local << 4) | flags) : 16 * chunk;
}

}  // namespace

extern "C" {

// probes: host array of n_probes positive offsets (near 1..8, then far).
int s4_probe(const int32_t* planes, int32_t* payload, int32_t* key,
             const int32_t* cut_gram, const int32_t* cut_pos,
             const int32_t* match_limit, int B, int n, int chunk,
             const int32_t* probes, int n_probes, void* stream) {
  if (B < 1 || n != 2 * chunk || n_probes < 1 || n_probes > MAX_PROBES)
    return (int)cudaErrorInvalidValue;
  ProbeSet ps;
  ps.n = n_probes;
  int halo = 0;
  for (int i = 0; i < n_probes; ++i) {
    if (probes[i] < 1) return (int)cudaErrorInvalidValue;
    ps.k[i] = probes[i];
    halo = probes[i] > halo ? probes[i] : halo;
  }
  for (int i = n_probes; i < MAX_PROBES; ++i) ps.k[i] = 0;
  const size_t smem = (size_t)PLANES * (TILE + 2 * halo) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n + TILE - 1) / TILE, B);
  probe_kernel<<<grid, TILE, smem, static_cast<cudaStream_t>(stream)>>>(
      planes, payload, key, cut_gram, cut_pos, match_limit, n, chunk, ps,
      halo);
  return (int)cudaGetLastError();
}

}  // extern "C"
