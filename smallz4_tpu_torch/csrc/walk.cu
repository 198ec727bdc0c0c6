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
// never changes again, so the reference's lockstep loops equal one serial
// loop per lane; in PyTorch the lockstep loop would need a host sync per
// round and per extension step, this kernel needs none.  Indices are
// clipped to [0, n) as the reference's `take` does.  A lane converges when
// its walk ended for a benign reason (chain end, window edge, no longer
// match fits) without an extension cut short by ext_cap and without its
// match reaching the cap.
//
// Bound: the hops and extension words are data dependent gathers within a
// row that the L2 cache holds (a row is some 1.7 MB of bytes, grams,
// predecessors and run lengths); the work is latency bound.  Design: one
// thread per searched position, 128 threads a block, each lane walks alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_DISTANCE = 65535;
constexpr int BLOCK_END_NO_MATCH = 12;
constexpr int BLOCK_END_LITERALS = 5;
constexpr int WALK_THREADS = 128;

__global__ void walk_kernel(const uint8_t* __restrict__ ctx,
                            const int32_t* __restrict__ grams,
                            const int32_t* __restrict__ prev,
                            const int32_t* __restrict__ runs,
                            const int32_t* __restrict__ start_valid,
                            const int32_t* __restrict__ end_valid,
                            int32_t* __restrict__ lens,
                            int32_t* __restrict__ dists,
                            uint8_t* __restrict__ conv, int n, int base,
                            int search_len, int max_candidates, int ext_cap) {
  const int t = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (t >= search_len) return;
  const int b = blockIdx.y;
  const size_t row = (size_t)b * n;
  const uint8_t* c = ctx + row;
  const uint32_t* g = reinterpret_cast<const uint32_t*>(grams) + row;
  const int32_t* pv = prev + row;
  const int32_t* rl = runs + row;
  const int pos = base + t;
  const int ev = end_valid[b];
  const bool searchable =
      pos >= start_valid[b] && pos + BLOCK_END_NO_MATCH <= ev;
  const int cap = max(ev - BLOCK_END_LITERALS - pos, 0);
  const int eff_cap = min(cap, ext_cap);
  auto clip = [n](int i) { return min(max(i, 0), n - 1); };

  int q = pv[pos];
  int best = 1, dist = 0;
  bool hit_cap = false;
  if (searchable) {
    for (int r = 0; r < max_candidates; ++r) {
      if (q < 0 || pos - q > MAX_DISTANCE || best + 1 > cap) break;
      if (c[clip(q + best)] == c[clip(pos + best)]) {
        int lcp;
        if (pos - q == 1) {  // a byte run: the common prefix is analytic
          lcp = min(rl[q] - 1, cap);
        } else {
          int k = min(4, eff_cap);  // equal grams: 4 bytes are known
          while (k < eff_cap) {
            const uint32_t x = g[clip(pos + k)] ^ g[clip(q + k)];
            if (x != 0) {  // equal low-order bytes before the mismatch
              k = min(k + ((__ffs(x) - 1) >> 3), eff_cap);
              break;
            }
            k = min(k + 4, eff_cap);
          }
          lcp = k;
          hit_cap |= lcp >= eff_cap && eff_cap < cap;
        }
        if (lcp >= best + 1) {
          best = lcp;
          dist = pos - q;
        }
      }
      q = pv[q];
    }
  }
  const bool exhausted = q < 0 || pos - q > MAX_DISTANCE || best + 1 > cap;
  const bool at_limit = best >= cap;
  const size_t o = (size_t)b * search_len + t;
  lens[o] = searchable ? best : 1;
  dists[o] = searchable ? dist : 0;
  conv[o] = !searchable || (exhausted && !hit_cap && !at_limit);
}

}  // namespace

extern "C" {

// Walk of positions [base, base + search_len) of every row of `ctx`
// ([B][n] bytes) with its grams (last three zeroed), predecessors (-1 for
// none) and run lengths ([B][n] int32 each) and its valid range
// [start_valid[b], end_valid[b]).  Writes lens, dists ([B][search_len]
// int32) and conv ([B][search_len] bytes, 0 or 1).
int s4_walk(const uint8_t* ctx, const int32_t* grams, const int32_t* prev,
            const int32_t* runs, const int32_t* start_valid,
            const int32_t* end_valid, int32_t* lens, int32_t* dists,
            uint8_t* conv, int B, int n, int base, int search_len,
            int max_candidates, int ext_cap, void* stream) {
  if (B < 1 || n < 1 || search_len < 1 || base < 0 || base + search_len > n)
    return (int)cudaErrorInvalidValue;
  dim3 grid((search_len + WALK_THREADS - 1) / WALK_THREADS, B);
  walk_kernel<<<grid, WALK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ctx, grams, prev, runs, start_valid, end_valid, lens, dists, conv, n,
      base, search_len, max_candidates, ext_cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
