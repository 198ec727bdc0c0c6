// The candidate walk of the walk search engine (Hopper, sm_90a).
//
// Replaces smallz4_tpu/ops/match_finder.py _match_core's lockstep walk,
// which the reference writes in XLA (two nested while loops over all lanes
// at once), not in Pallas.  Every searched position p of a row holds its
// current candidate q (first prev[p], then prev[q]) and its best match so
// far.  A round, while the lane is active (q >= 0, p - q <= 65535 and a
// longer match still fits the cap), does a cheap reject (the candidate must
// extend the best by a byte), takes a distance-1 candidate's common prefix
// from the run lengths, extends any other candidate by 4-byte words up to
// min(cap, ext_cap), keeps the longest (the nearest on ties, since
// candidates come nearest first) and hops to prev[q].  An inactive lane
// never changes again, so the reference's lockstep loops equal one loop per
// lane; in PyTorch the lockstep loop would need a host sync per round and
// per extension step, this kernel needs none.  Indices are clipped to
// [0, n) as the reference's `take` does.  A lane converges when its walk
// ended for a benign reason (chain end, window edge, no longer match fits)
// without an extension cut short by ext_cap and without its match reaching
// the cap.
//
// Bound: the operations of the hops and extension words that the input
// needs (some 20 and 12 integer operations each) or the bytes read once,
// a few microseconds a dispatch.  What holds this design back is the
// instruction rate and the latency of each round's chain of shared-memory
// reads and warp votes: a warp's lanes run their rounds in lockstep (on the
// fixture's dispatch, 900 K warp-rounds for 14.5 M hops, half the lane
// slots idle), and one window fills an SM's shared memory, so an SM holds
// 32 warps.  The one-thread-per-position design instead gathered every
// hop's c[q + best], c[p + best] and prev[q] and every extension word's
// g[p + k] and g[q + k] from L2 (about 60 M 32-byte sectors a dispatch),
// and its warps waited, every round, for their longest extension (p99 127
// words, mean 7).
//
// Design: a block takes TILE consecutive searched positions [P, P + TILE)
// of one row and stages in shared memory what their walks read:
//   * the predecessors of [P - 65535, P + TILE) as 16-bit back-distances
//     p - prev[p], 0 for none or farther than 65535.  A predecessor that
//     far ends the walk just as -1 does (both leave the lane exhausted and
//     best/dist alone), so the encoding is exact; it needs prev[p] < p.
//     While a lane is active its q lies in [p - 65535, p), so every hop
//     reads shared memory;
//   * the bytes [P - 65535, P + TILE + ext_cap + 4), clipped to the row
//     and to what fits.  The rejects read them, and the extension's grams
//     are their little-endian words (funnel shifts of aligned words), the
//     last three grams of the row 0, which is what `grams` holds.  A read
//     outside them (a reject at p + best after a long run) goes to device
//     memory, `ctx` or `grams`, so the result stays exact;
//   * the run lengths of [P - 1, P + TILE - 1), read at q = p - 1.
// At TILE = 2048 that is about 207 KiB, one block of 1024 threads an SM
// and 256 blocks a dispatch, each reading some 0.35 MB from L2 once, with
// 16-byte loads.  Warps take chunks of 32 consecutive positions from a
// block counter in shared memory and run their rounds in lockstep.  Each
// lane extends its candidate by up to SERIAL_WORDS words itself; the
// extensions still open after that are taken one by one by the whole warp,
// 32 words a step, so a long extension no longer holds its 31 neighbours a
// word at a time.  The outputs stay in device memory.  `stats`, if not
// null, receives the bytes the blocks staged and the reads that fell
// outside the staged window.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_DISTANCE = 65535;
constexpr int BLOCK_END_NO_MATCH = 12;
constexpr int BLOCK_END_LITERALS = 5;
constexpr int THREADS = 1024;
constexpr int TILE = 2048;            // searched positions a block
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SERIAL_WORDS = 4;       // extension words a lane reads alone
constexpr int SMEM_MAX = 232448;      // dynamic shared memory a block may use
constexpr int HEADER = 16;            // the position counter, 16-byte aligned

// smem: [HEADER][run lengths of [P - 1, P + TILE - 1): TILE + 4 int32]
// [bd: n_bd uint16][bytes: n_bytes, then a zero word]
__global__ void __launch_bounds__(THREADS, 1)
walk_kernel(const uint8_t* __restrict__ ctx, const int32_t* __restrict__ grams,
            const int32_t* __restrict__ prev, const int32_t* __restrict__ runs,
            const int32_t* __restrict__ start_valid,
            const int32_t* __restrict__ end_valid, int32_t* __restrict__ lens,
            int32_t* __restrict__ dists, uint8_t* __restrict__ conv, int n,
            int base, int search_len, int max_candidates, int ext_cap,
            int n_bd, int n_bytes, unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* next = reinterpret_cast<int*>(smem);
  int32_t* rls = reinterpret_cast<int32_t*>(smem + HEADER);
  uint16_t* bd = reinterpret_cast<uint16_t*>(smem + HEADER + 4 * (TILE + 4));
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + HEADER + 4 * (TILE + 4) + 2 * n_bd);
  const uint8_t* sbytes = reinterpret_cast<const uint8_t*>(words);

  const int b = blockIdx.y;
  const size_t row = (size_t)b * n;
  const uint8_t* c = ctx + row;
  const uint32_t* g = reinterpret_cast<const uint32_t*>(grams) + row;
  const int32_t* pv = prev + row;
  const int32_t* rl = runs + row;
  const int t_lo = blockIdx.x * TILE;
  const int t_hi = min(t_lo + TILE, search_len);
  const int p_hi = base + t_hi;
  const int w0 = max(base + t_lo - MAX_DISTANCE, 0);  // hops land in [w0, p_hi)
  const int s0 = w0 & ~3;  // bd covers [s0, p_hi), the bytes [s0, s1)
  const int s1 = min(min(p_hi + max(ext_cap, 0) + 4, n), s0 + n_bytes);

  // 16-byte loads, four in flight a thread, coalesced across the block
  const bool vec_p = (reinterpret_cast<uintptr_t>(pv + s0) & 15) == 0;
  for (int i0 = s0 + 4 * threadIdx.x; i0 < p_hi; i0 += 16 * THREADS) {
    int p[16];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = i0 + 4 * THREADS * m;
      if (vec_p && i + 4 <= p_hi) {
        const int4 v = *reinterpret_cast<const int4*>(pv + i);
        p[4 * m] = v.x; p[4 * m + 1] = v.y; p[4 * m + 2] = v.z;
        p[4 * m + 3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) p[4 * m + e] = i + e < p_hi ? pv[i + e] : -1;
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = i0 + 4 * THREADS * m;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = i + e - p[4 * m + e];
        v[e] = (p[4 * m + e] >= 0 && d >= 1 && d <= MAX_DISTANCE) ? d : 0;
      }
      if (i + 4 <= p_hi) {
        *reinterpret_cast<uint2*>(bd + (i - s0)) =
            make_uint2(v[0] | v[1] << 16, v[2] | v[3] << 16);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i + e < p_hi) bd[i + e - s0] = (uint16_t)v[e];
      }
    }
  }
  const bool vec_c = (reinterpret_cast<uintptr_t>(c + s0) & 15) == 0;
  const bool word_c = (reinterpret_cast<uintptr_t>(c + s0) & 3) == 0;
  const int n_words = (s1 - s0 + 3) >> 2;  // then a zero word
  for (int k0 = 4 * threadIdx.x; k0 <= n_words; k0 += 16 * THREADS) {
    uint32_t w[16];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = k0 + 4 * THREADS * m, i = s0 + 4 * k;
      if (vec_c && i + 16 <= s1) {
        const uint4 v = *reinterpret_cast<const uint4*>(c + i);
        w[4 * m] = v.x; w[4 * m + 1] = v.y; w[4 * m + 2] = v.z;
        w[4 * m + 3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ie = i + 4 * e;
          uint32_t x = 0;
          if (word_c && ie + 4 <= s1) {
            x = *reinterpret_cast<const uint32_t*>(c + ie);
          } else {
            for (int y = 0; y < 4 && ie + y < s1; ++y)
              x |= (uint32_t)c[ie + y] << (8 * y);
          }
          w[4 * m + e] = x;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = k0 + 4 * THREADS * m;
      if (k + 3 <= n_words) {
        *reinterpret_cast<uint4*>(words + k) =
            make_uint4(w[4 * m], w[4 * m + 1], w[4 * m + 2], w[4 * m + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e <= n_words) words[k + e] = w[4 * m + e];
      }
    }
  }
  for (int i = threadIdx.x; i <= t_hi - t_lo; i += THREADS) {
    const int at = base + t_lo - 1 + i;  // a distance-1 candidate's q
    rls[i] = at >= 0 ? rl[at] : 0;
  }
  if (threadIdx.x == 0) {
    *next = 0;
    if (stats)
      atomicAdd(stats, 4ull * (p_hi - s0) + (s1 - s0) + 4ull * (t_hi - t_lo + 1));
  }
  __syncthreads();

  const int ev = end_valid[b], sv = start_valid[b];
  unsigned far = 0;
  auto clip = [n](int i) { return min(max(i, 0), n - 1); };
  auto byte_at = [&](int i) -> uint32_t {
    i = clip(i);
    if (i >= s0 && i < s1) return sbytes[i - s0];
    ++far;
    return c[i];
  };
  // the gram at i from the staged bytes (s0 <= i, i + 4 <= s1)
  auto staged_gram = [&](int i) -> uint32_t {
    const int o = i - s0;
    return __funnelshift_r(words[o >> 2], words[(o >> 2) + 1], 8 * (o & 3));
  };
  auto gram_at = [&](int i) -> uint32_t {
    i = clip(i);
    if (i > n - 4) return 0u;
    if (i >= s0 && i + 4 <= s1) return staged_gram(i);
    ++far;
    return g[i];
  };

  const int lane = threadIdx.x & (WARP - 1);
  for (;;) {  // the warp takes the next 32 positions of the tile
    int chunk = 0;
    if (lane == 0) chunk = atomicAdd(next, WARP);
    chunk = __shfl_sync(FULL, chunk, 0);
    if (chunk >= t_hi - t_lo) break;
    const int t = t_lo + chunk + lane;
    const bool live = t < t_hi;
    const int pos = base + t;
    const bool searchable = live && pos >= sv && pos + BLOCK_END_NO_MATCH <= ev;
    const int cap = max(ev - BLOCK_END_LITERALS - pos, 0);
    const int eff_cap = min(cap, ext_cap);
    const int q_min = max(pos - MAX_DISTANCE, 0);  // q >= q_min: in the window
    int q = -1;
    if (live) {
      const int d = bd[pos - s0];
      q = d ? pos - d : -1;
    }
    int best = 1, dist = 0;
    bool hit_cap = false;
    for (int r = 0; r < max_candidates; ++r) {  // the rounds, in lockstep
      const bool go = searchable && q >= q_min && best < cap;
      if (!__any_sync(FULL, go)) break;
      bool cand = false, open_ext = false;
      int k = 0, hop = 0;
      if (go) {
        hop = bd[q - s0];  // the next candidate, read beside the reject
        // s0 <= q + best < pos + best < s1 <= n: staged, nothing to clip
        const bool match = pos + best < s1
                               ? sbytes[q + best - s0] == sbytes[pos + best - s0]
                               : byte_at(q + best) == byte_at(pos + best);
        if (match) {
          cand = true;
          if (pos - q != 1) {
            k = min(4, eff_cap);  // equal grams: 4 bytes are known
            open_ext = k < eff_cap;
            for (int s = 0; s < SERIAL_WORDS && open_ext; ++s) {
              const uint32_t x = pos + k + 4 <= s1
                                     ? staged_gram(pos + k) ^ staged_gram(q + k)
                                     : gram_at(pos + k) ^ gram_at(q + k);
              if (x != 0) {  // equal low-order bytes before the mismatch
                k = min(k + ((__ffs(x) - 1) >> 3), eff_cap);
                open_ext = false;
              } else {
                k = min(k + 4, eff_cap);
                open_ext = k < eff_cap;
              }
            }
          }
        }
      }
      // the extensions still open, one at a time, 32 words a step
      for (unsigned m = __ballot_sync(FULL, open_ext); m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        const int P = __shfl_sync(FULL, pos, src);
        const int Q = __shfl_sync(FULL, q, src);
        const int E = __shfl_sync(FULL, eff_cap, src);
        int K = __shfl_sync(FULL, k, src), res = E;
        for (; K < E; K += 4 * WARP) {
          const int at = K + 4 * lane;
          uint32_t x = 0;
          if (at < E)
            x = P + at + 4 <= s1 ? staged_gram(P + at) ^ staged_gram(Q + at)
                                 : gram_at(P + at) ^ gram_at(Q + at);
          const unsigned hit = __ballot_sync(FULL, x != 0);
          if (hit) {
            const int j = __ffs(hit) - 1;
            const uint32_t xj = __shfl_sync(FULL, x, j);
            res = min(K + 4 * j + ((__ffs(xj) - 1) >> 3), E);
            break;
          }
        }
        if (lane == src) k = res;
      }
      if (go) {
        if (cand) {
          int lcp;
          if (pos - q == 1) {  // a byte run: the common prefix is analytic
            lcp = min(rls[q - (base + t_lo - 1)] - 1, cap);
          } else {
            lcp = k;
            hit_cap |= lcp >= eff_cap && eff_cap < cap;
          }
          if (lcp > best) {
            best = lcp;
            dist = pos - q;
          }
        }
        q = hop ? q - hop : -1;
      }
    }
    if (live) {
      const bool exhausted = q < q_min || best >= cap;
      const bool at_limit = best >= cap;
      const size_t o = (size_t)b * search_len + t;
      lens[o] = searchable ? best : 1;
      dists[o] = searchable ? dist : 0;
      conv[o] = !searchable || (exhausted && !hit_cap && !at_limit);
    }
  }
  if (stats && far) atomicAdd(stats + 1, (unsigned long long)far);
}

}  // namespace

extern "C" {

// Walk of positions [base, base + search_len) of every row of `ctx`
// ([B][n] bytes) with its grams (last three zeroed), predecessors (-1 for
// none, else earlier) and run lengths ([B][n] int32 each) and its valid
// range [start_valid[b], end_valid[b]).  Writes lens, dists
// ([B][search_len] int32) and conv ([B][search_len] bytes, 0 or 1).
// stats: null, or two uint64 counters that receive the staged bytes and
// the reads outside the staged window.
int s4_walk(const uint8_t* ctx, const int32_t* grams, const int32_t* prev,
            const int32_t* runs, const int32_t* start_valid,
            const int32_t* end_valid, int32_t* lens, int32_t* dists,
            uint8_t* conv, int B, int n, int base, int search_len,
            int max_candidates, int ext_cap, unsigned long long* stats,
            void* stream) {
  if (B < 1 || n < 1 || search_len < 1 || base < 0 || base + search_len > n)
    return (int)cudaErrorInvalidValue;
  // back-distances of the longest window (+3: its start is rounded down to
  // a word), rounded to 16 bytes
  const int tile = search_len < TILE ? search_len : TILE;
  long long n_bd = (long long)tile + MAX_DISTANCE;
  if (n_bd > (long long)base + search_len) n_bd = (long long)base + search_len;
  n_bd = (n_bd + 3 + 7) & ~7ll;
  // bytes of that window and the read-ahead (+3: s0 is rounded down to a
  // word), what fits beside it; a zero word follows them
  long long n_bytes = (long long)tile + MAX_DISTANCE + (ext_cap > 0 ? ext_cap : 0) + 7;
  if (n_bytes > (long long)n + 3) n_bytes = (long long)n + 3;
  n_bytes = (n_bytes + 3) & ~3ll;
  const long long room = (SMEM_MAX - HEADER - 4 * (TILE + 4) - 2 * n_bd - 4) & ~3ll;
  if (n_bytes > room) n_bytes = room;
  if (n_bytes < 4) return (int)cudaErrorInvalidValue;
  const size_t smem = HEADER + 4 * (TILE + 4) + 2 * n_bd + n_bytes + 4;
  cudaError_t e = cudaFuncSetAttribute(
      walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((search_len + TILE - 1) / TILE, B);
  walk_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      ctx, grams, prev, runs, start_valid, end_valid, lens, dists, conv, n,
      base, search_len, max_candidates, ext_cap, (int)n_bd, (int)n_bytes,
      stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
