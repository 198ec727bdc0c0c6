// Neighbour probes over merged suffix-ordered records (Hopper, sm_90a).
//
// Replaces the TPU kernel smallz4_tpu/ops/chunkmatch.py:199 _probe_kernel
// with its default strategy, PROBE_LCP="composed".  Input: the merged
// (halo chunk, current chunk) records, 6 int32 planes [B][6][n] with
// n = 2 * chunk (five big-endian key words, then combo), sorted by the five
// key words.  For every slot it finds the best (len, dist) among the
// records at suffix-order offsets +-k for k in the probe set, byte-verified
// to 20 bytes, with the block match cap applied before the
// nearest-distance tie-break, the boundary-cut exclusion, and the edge-LCP /
// nearest-sharer certificate flags.  Outputs payload = len << 16 | dist and
// key = (local << 4) | flags (halo records: 16 * chunk).
//
// Composed LCPs: on records sorted by their 20-byte key, the key LCP of
// slots i < j is the least adjacent LCP a[i..j) (the suffix-array min
// property; min caps compose).  A block stages the six planes of its tile
// and a +-max(probe) halo with 16-byte cp.async, computes a[] once per
// record (one 5-word compare) and a sparse min-table M[l][i] =
// min a[i .. i + 2^l) in shared memory.  The near probes 1..8 are running
// mins of a[]; every far probe's window is the previous probe's plus the
// segment between the two offsets, the min of two table entries (one for a
// power-of-two length), so the table only needs the levels of the longest
// segment (6 for the default probes, whose segments are 4..32 long).  The
// neighbour's combo and the candidate test come from one derived word a
// record: combo's invalid bit 31 and pos, and bit 17 set for a record that
// is no candidate (invalid, or its own cut test plane0 == cut_gram &&
// raw < cut_pos, which the reference puts in combo bit 29), so one
// unsigned range test on the distance covers validity, the cut and the
// window.  On unsorted planes the composed values are not the direct ones.
// VERIFY_WORDS=7 (not ported) would extend a probe whose key LCP reaches
// 20 by words 5-6, as the reference does.
//
// Bound: the planes read once and the two outputs written once, 32 bytes a
// slot (80 us at [64, 6, 131072] on 3.35 TB/s).  The design's own floor is
// its staged bytes: a block of TILE = 1024 slots reads its records plus a
// +-max(probe) halo, (1024 + 2 * 160) / 1024 = 1.31 times the six planes at
// the default probes, plus the outputs, about 0.1 ms at that shape; the
// copies alone run at that rate.  The probes are bound by the instruction
// rate, so a thread takes 4 consecutive slots and keeps their LCPs as the 4
// bytes of one word: a near probe is one funnel shift and one per-byte min
// (__vminu4) for all 4, a far probe two 4-byte table reads, two per-byte
// mins and one 16-byte read of the 4 neighbours' words, and the block cap
// is one more per-byte min.  Each slot keeps its best (len, dist) as one
// packed score, max of len << 17 | (2^17 - 1 - dist): the longest, then
// the nearest.  Blocks away from the row's ends skip the range tests and
// write their outputs with 16-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PLANES = 6;
constexpr int MAX_PROBES = 32;
constexpr int THREADS = 256;
constexpr int SLOTS = 4;                  // consecutive slots a thread
constexpr int TILE = THREADS * SLOTS;     // slots a block
constexpr int POS_MASK = (1 << 17) - 1;
constexpr int32_t INVALID = (int32_t)0x80000000u;
constexpr int32_t NOT_CANDIDATE = 1 << 17;  // derived word: invalid or cut
constexpr int KEY_REACH = 20;
constexpr int EXT_REACH = 20;
constexpr int MIN_MATCH = 4;
constexpr int MAX_DISTANCE = 65535;
constexpr int EDGE = 8;                   // probes 1..EDGE are the near ones

// The far probes k[0] < k[1] < ... (all > EDGE): probe m's window is the
// previous one's (EDGE's for m = 0) plus the segment between the two
// offsets, of length k[m] - k[m - 1] and table level lvl[m] =
// floor(log2 length).
struct ProbeSet {
  int n_far;
  int k[MAX_PROBES];
  int lvl[MAX_PROBES];
};

// leading equal bytes (0..4) of one big-endian xor word
__device__ __forceinline__ int be_bytes(uint32_t x) {
  return x == 0 ? 4 : (__clz(x) >> 3);
}

// A candidate's score: its capped LCP << 17 | (2^17 - 1 - dist), or 0 where
// the neighbour is not a candidate (NOT_CANDIDATE makes its distance
// negative) or is not 1..65535 back.  The max over a slot's probes is the
// longest, then the nearest; a max below 2^17 (LCP 0) is no match.
__device__ __forceinline__ int score(uint32_t lcp, int32_t nb, int raw) {
  const int d = raw - (nb & (POS_MASK | NOT_CANDIDATE));
  return (unsigned)(d - 1) < (unsigned)MAX_DISTANCE
             ? (int)(lcp << 17) + (POS_MASK - d) : 0;
}

// The 4 bytes a[x .. x + 4) from a window held as 32-bit words from its
// byte 0 (x a compile-time offset after unrolling)
__device__ __forceinline__ uint32_t bytes4(const uint32_t* w, int x) {
  return __funnelshift_r(w[x >> 2], w[(x >> 2) + 1], 8 * (x & 3));
}

template <bool CHECK>
__device__ __forceinline__ void probe_slots(
    const int32_t* D, const uint8_t* M, int W, int li0, int slot0, int n,
    int chunk, int ml, const ProbeSet& ps, int32_t* payload, int32_t* key,
    size_t row) {
  // capped and uncapped LCPs travel as 4 bytes, one a slot
  int raw[SLOTS], cap[SLOTS], best[SLOTS], gap[SLOTS];
  uint32_t cap4 = 0, up4 = 0xFFFFFFFFu, down4 = 0xFFFFFFFFu, ehi4, elo4;
  {
    // near probes: a[li0 - 8 .. li0 + 12) and D[li0 - 8 .. li0 + 12)
    uint32_t aw[5];
    int32_t dw[20];
    const uint32_t* a32 = reinterpret_cast<const uint32_t*>(M + li0 - EDGE);
#pragma unroll
    for (int i = 0; i < 5; ++i) aw[i] = a32[i];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int4 v = *reinterpret_cast<const int4*>(D + li0 - EDGE + 4 * i);
      dw[4 * i] = v.x; dw[4 * i + 1] = v.y; dw[4 * i + 2] = v.z;
      dw[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      raw[j] = dw[EDGE + j] & POS_MASK;
      const int local = raw[j] - chunk;
      cap[j] = local >= 0 ? max(ml - local, 0) : (1 << 30);
      cap4 |= (uint32_t)min(cap[j], KEY_REACH) << (8 * j);
      best[j] = 0;
      gap[j] = 0;
    }
#pragma unroll
    for (int k = 1; k <= EDGE; ++k) {
      up4 = __vminu4(up4, bytes4(aw, EDGE + k - 1));  // a[li0 + j + k - 1]
      down4 = __vminu4(down4, bytes4(aw, EDGE - k));  // a[li0 + j - k]
      const uint32_t ue = __vminu4(up4, cap4), de = __vminu4(down4, cap4);
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        if (!CHECK || slot0 + j + k < n)
          best[j] = max(best[j], score((ue >> (8 * j)) & 0xFF, dw[EDGE + j + k], raw[j]));
        if (!CHECK || slot0 + j >= k) {
          const int32_t nb = dw[EDGE + j - k];
          best[j] = max(best[j], score((de >> (8 * j)) & 0xFF, nb, raw[j]));
          if (k == 1) {
            const int d = raw[j] - (nb & POS_MASK);
            gap[j] = nb >= 0 && d >= 1 && ((down4 >> (8 * j)) & 0xFF) >= KEY_REACH ? d : 0;
          }
        }
      }
    }
    ehi4 = up4;
    elo4 = down4;
  }

  // far probes: each window is the last one plus a segment, a[li0 + prev_k
  // .. li0 + sk) above and a[li0 - sk .. li0 - prev_k) below, each the min
  // of two windows of 2^lvl entries (the same one for a power-of-two length)
  int prev_k = EDGE;
  for (int pi = 0; pi < ps.n_far; ++pi) {
    const int sk = ps.k[pi];
    const uint8_t* Ml = M + ps.lvl[pi] * W;
    const int e = 1 << ps.lvl[pi];
    const int u0 = li0 + prev_k, u1 = li0 + sk - e;
    const int d0 = li0 - sk, d1 = li0 - prev_k - e;
    int32_t nb_up[SLOTS], nb_dn[SLOTS];
    if (((sk | prev_k) & 3) == 0) {
      up4 = __vminu4(up4, __vminu4(*reinterpret_cast<const uint32_t*>(Ml + u0),
                                   *reinterpret_cast<const uint32_t*>(Ml + u1)));
      down4 = __vminu4(down4, __vminu4(*reinterpret_cast<const uint32_t*>(Ml + d0),
                                       *reinterpret_cast<const uint32_t*>(Ml + d1)));
      const int4 vu = *reinterpret_cast<const int4*>(D + li0 + sk);
      const int4 vd = *reinterpret_cast<const int4*>(D + li0 - sk);
      nb_up[0] = vu.x; nb_up[1] = vu.y; nb_up[2] = vu.z; nb_up[3] = vu.w;
      nb_dn[0] = vd.x; nb_dn[1] = vd.y; nb_dn[2] = vd.z; nb_dn[3] = vd.w;
    } else {
      uint32_t su = 0, sd = 0;
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        su |= (uint32_t)min(Ml[u0 + j], Ml[u1 + j]) << (8 * j);
        sd |= (uint32_t)min(Ml[d0 + j], Ml[d1 + j]) << (8 * j);
        nb_up[j] = D[li0 + sk + j];
        nb_dn[j] = D[li0 - sk + j];
      }
      up4 = __vminu4(up4, su);
      down4 = __vminu4(down4, sd);
    }
    const uint32_t ue = __vminu4(up4, cap4), de = __vminu4(down4, cap4);
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      if (!CHECK || slot0 + j + sk < n)
        best[j] = max(best[j], score((ue >> (8 * j)) & 0xFF, nb_up[j], raw[j]));
      if (!CHECK || slot0 + j >= sk)
        best[j] = max(best[j], score((de >> (8 * j)) & 0xFF, nb_dn[j], raw[j]));
    }
    prev_k = sk;
  }

  int32_t out_pay[SLOTS], out_key[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int slot = slot0 + j;
    const bool hit = best[j] >= (1 << 17);
    const int best_len = best[j] >> 17;
    const int best_dist = hit ? POS_MASK - (best[j] & POS_MASK) : 0;
    // the LCPs with the records at +-EDGE, -1 out of range
    const int ehi = !CHECK || slot + EDGE < n ? (int)((ehi4 >> (8 * j)) & 0xFF) : -1;
    const int elo = !CHECK || slot >= EDGE ? (int)((elo4 >> (8 * j)) & 0xFF) : -1;
    const int th = min(max(best_len, MIN_MATCH), KEY_REACH);
    const bool cert_fail = elo >= th || ehi >= th;
    const int th_len = min(max(best_len + 1, MIN_MATCH), KEY_REACH);
    const bool len_fail = elo >= th_len || ehi >= th_len ||
                          best_len >= KEY_REACH;
    const bool gap_hit = best_dist == gap[j] && gap[j] >= 1;
    const bool trunc = best_len >= EXT_REACH && cap[j] > EXT_REACH;
    const int flags = (int)trunc | ((int)cert_fail << 1) |
                      ((int)len_fail << 2) | ((int)gap_hit << 3);
    const int local = raw[j] - chunk;
    out_pay[j] = (best_len << 16) | best_dist;
    out_key[j] = local >= 0 ? ((local << 4) | flags) : 16 * chunk;
  }
  if (!CHECK && ((row + slot0) & 3) == 0) {  // 16-byte stores
    *reinterpret_cast<int4*>(payload + row + slot0) =
        make_int4(out_pay[0], out_pay[1], out_pay[2], out_pay[3]);
    *reinterpret_cast<int4*>(key + row + slot0) =
        make_int4(out_key[0], out_key[1], out_key[2], out_key[3]);
  } else {
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      if (slot0 + j >= n) break;
      payload[row + slot0 + j] = out_pay[j];
      key[row + slot0 + j] = out_key[j];
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

// smem: the six planes R[6][W] of the W = TILE + 2 * halo records from
// t0 - halo (halo a multiple of 4, at least EDGE), the combo plane then
// turned into the derived words D in place, and the min-table
// M[levels][W] (bytes)
__global__ void __launch_bounds__(THREADS, 4)
probe_kernel(const int32_t* __restrict__ planes, int32_t* __restrict__ payload,
             int32_t* __restrict__ key, const int32_t* __restrict__ cut_gram,
             const int32_t* __restrict__ cut_pos,
             const int32_t* __restrict__ match_limit, int n, int chunk,
             ProbeSet ps, int halo, int levels) {
  extern __shared__ __align__(16) int32_t sm[];
  const int W = TILE + 2 * halo;
  int32_t* R = sm;
  int32_t* D = sm + 5 * W;
  uint8_t* M = reinterpret_cast<uint8_t*>(sm + PLANES * W);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE, g0 = t0 - halo;
  const int32_t* src = planes + (size_t)b * PLANES * n;
  const int32_t cg = cut_gram[b], cp = cut_pos[b], ml = match_limit[b];

  // 16-byte copies, all in flight at once; records outside [0, n) are 0
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n & 3) == 0;
  for (int p = 0; p < PLANES; ++p) {
    for (int i = 4 * threadIdx.x; i < W; i += 4 * THREADS) {
      const int g = g0 + i;
      const int32_t* from = src + (size_t)p * n + g;
      if (vec && g >= 0 && g + 4 <= n) {
        cp_async16(R + p * W + i, from);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          R[p * W + i + e] = g + e >= 0 && g + e < n ? from[e] : 0;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // adjacent LCPs and derived words, 4 records a thread; records outside
  // [0, n) are never probed, and no window of an in-range probe covers
  // their a[]
  for (int i = 4 * threadIdx.x; i < W; i += 4 * THREADS) {
    uint32_t w[5][5];  // [plane][record i .. i + 4]
#pragma unroll
    for (int p = 0; p < 5; ++p) {
      const uint4 v = *reinterpret_cast<const uint4*>(R + p * W + i);
      w[p][0] = v.x; w[p][1] = v.y; w[p][2] = v.z; w[p][3] = v.w;
      w[p][4] = i + 4 < W ? static_cast<uint32_t>(R[p * W + i + 4]) : 0u;
    }
    const int4 combo = *reinterpret_cast<const int4*>(D + i);
    const int32_t cv[4] = {combo.x, combo.y, combo.z, combo.w};
    int32_t d[4];
    uint32_t a4 = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int g = g0 + i + r;
      int a = 0;
      bool eq = true;
#pragma unroll
      for (int p = 0; p < 5; ++p) {
        const int e = be_bytes(w[p][r] ^ w[p][r + 1]);
        a += eq ? e : 0;
        eq = eq && e == 4;
      }
      if (g >= 0 && g + 1 < n && i + r + 1 < W) a4 |= (uint32_t)a << (8 * r);
      const bool cut = static_cast<int32_t>(w[0][r]) == cg && (cv[r] & POS_MASK) < cp;
      d[r] = (cv[r] & (INVALID | POS_MASK)) | (cv[r] < 0 || cut ? NOT_CANDIDATE : 0);
    }
    *reinterpret_cast<int4*>(D + i) = make_int4(d[0], d[1], d[2], d[3]);
    *reinterpret_cast<uint32_t*>(M + i) = a4;
  }
  __syncthreads();
  // level l from level l - 1, four entries a thread at a time; an entry
  // whose window runs past the stage keeps its lower level's value
  const int WW = W / 4;
  for (int l = 1; l < levels; ++l) {
    const int half = 1 << (l - 1);
    const uint32_t* lo = reinterpret_cast<const uint32_t*>(M + (l - 1) * W);
    uint32_t* hi = reinterpret_cast<uint32_t*>(M + l * W);
    for (int wi = threadIdx.x; wi < WW; wi += THREADS) {
      const uint32_t x = lo[wi];
      uint32_t y;
      if (half >= 4) {
        y = wi + half / 4 < WW ? lo[wi + half / 4] : 0xFFFFFFFFu;
      } else {
        const uint32_t nxt = wi + 1 < WW ? lo[wi + 1] : 0xFFFFFFFFu;
        y = __funnelshift_r(x, nxt, 8 * half);
      }
      hi[wi] = __vminu4(x, y);
    }
    __syncthreads();
  }

  const int li0 = halo + SLOTS * threadIdx.x;
  const int slot0 = t0 + SLOTS * threadIdx.x;
  const size_t row = (size_t)b * n;
  if (t0 >= halo && t0 + TILE + halo <= n)
    probe_slots<false>(D, M, W, li0, slot0, n, chunk, ml, ps, payload, key, row);
  else if (slot0 < n)
    probe_slots<true>(D, M, W, li0, slot0, n, chunk, ml, ps, payload, key, row);
}

}  // namespace

extern "C" {

// slots a block of s4_probe covers (no launch)
int s4_probe_tile() { return TILE; }

// probes: host array of n_probes offsets, the near 1..8 in order, then
// increasing far ones.
int s4_probe(const int32_t* planes, int32_t* payload, int32_t* key,
             const int32_t* cut_gram, const int32_t* cut_pos,
             const int32_t* match_limit, int B, int n, int chunk,
             const int32_t* probes, int n_probes, void* stream) {
  if (B < 1 || n != 2 * chunk || n_probes < EDGE || n_probes > MAX_PROBES)
    return (int)cudaErrorInvalidValue;
  ProbeSet ps = {};
  int far = EDGE, levels = 1;
  for (int i = 0; i < n_probes; ++i) {
    const int k = probes[i];
    if (i < EDGE ? k != i + 1 : k <= far) return (int)cudaErrorInvalidValue;
    if (i < EDGE) continue;
    const int lvl = 31 - __builtin_clz((unsigned)(k - far));
    ps.k[ps.n_far] = k;
    ps.lvl[ps.n_far++] = lvl;
    levels = lvl + 1 > levels ? lvl + 1 : levels;
    far = k;
  }
  const int halo = (far + 3) & ~3;
  const size_t smem = (size_t)(TILE + 2 * halo) * (PLANES * sizeof(int32_t) + levels);
  cudaError_t e = cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n + TILE - 1) / TILE, B);
  probe_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      planes, payload, key, cut_gram, cut_pos, match_limit, n, chunk, ps,
      halo, levels);
  return (int)cudaGetLastError();
}

}  // extern "C"
