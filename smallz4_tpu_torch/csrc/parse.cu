// Optimal parse by policy iteration (Hopper, sm_90a).
//
// Replaces smallz4_tpu/ops/parse.py estimate_costs_device, an XLA
// lax.while_loop (not Pallas) that runs until no decision changes, capped
// at max_iters rounds.  Each round evaluates the current decisions choice[i]
// (1 = literal, else the match length) exactly, then re-decides every
// position against the evaluated costs with the reference DP's rule.  In
// PyTorch that loop would cost a host sync a round and hundreds of small
// launches for its pointer doubling, so the whole iteration is one
// cooperative launch: a persistent grid of co-resident blocks (occupancy x
// SMs, at most one block a tile) with grid barriers between phases; the
// round's "changed" flag stays in device memory.
//
// A block owns tiles of 2,048 positions (4 a thread), the same ones in
// every phase.  A round:
//   P1  literal flags of the policy; each tile's first non-literal position.
//   P2  num_lit[i] = (the first non-literal after i) - i, from a suffix min
//       over the thread's 4 positions, the later threads and the later
//       tiles; then each position's step cost and jump target, packed as
//       one 64-bit word W[i] = nxt << 32 | acc (the absorbing tail, i >=
//       n - 5, is acc 0 jumping to itself).
//   P3  pointer jumping in place: W[i] <- (acc + acc[nxt], nxt[nxt]) until
//       every jump reaches the tail.  A word is read and written whole, so
//       a block that reads a word already advanced this round still gets a
//       consistent (sum, target) pair, which only shortens the rounds.
//   P4  cost[i] = acc; and, when a claim reaches tier 2 (length >= 19) and
//       another improvement follows, the range-min table: for levels k =
//       1..7, the offset (0..2^k - 1) of the last argmin of cost over
//       [j, j + 2^k), one byte a level, packed into a 64-bit word a
//       position (level 0 is the position itself), built in shared memory
//       from the tile's costs and a 128-position halo.
//   P5  the improvement: the literal, tier 1 (lengths 4..18) in the
//       ascending `<=` scan from the tile's costs staged in shared memory,
//       each tier >= 2 as (min, last argmin) of two table lookups, the
//       MAX_SAME_LETTER distance-1 shortcut overriding the scan.  Any change
//       raises the round's flag.
// The result is the reference's, round for round: the same decisions, the
// same costs of the final policy (over the whole array, padding
// included), the same `converged` when max_iters cuts the iteration.
//
// Bound: the inputs (lens, dists) read once and the outputs (choice, cost)
// written once, 16 bytes a position: 20 us at 4 MiB on 3.35 TB/s.  The
// design moves, a round, 66 bytes a position outside the jump rounds (more
// where tiers reach the table) and 24 a position a jump round, of which an
// evaluation takes log2 of the policy's longest path in tokens (about 20
// at 4 MiB), so the jump rounds carry most of its traffic; their working
// set, W (8 bytes a position, 32 MB at 4 MiB), fits the 50 MB L2.  A round
// takes 4 grid barriers and one a jump round.
//
// Barriers: an arrival counter and a generation word (the last block to
// arrive resets the counter and bumps the generation), so the state needs
// no reset between calls.  The round flags and the longest scanned claim
// are 64-bit words tagged with the call's epoch in the high half and only
// ever raised with atomicMax, so they too need no reset.  Data written
// during the launch is read through L2 (ld.global.cg): L1 is not coherent
// across SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int PER = 4;                    // positions a thread
constexpr int TILE = THREADS * PER;       // positions a tile
constexpr int WARPS = THREADS / 32;
constexpr int LEVELS = 8;                 // range-min table levels
constexpr int HALO = 1 << (LEVELS - 1);   // reach of the widest level
constexpr int MIN_MATCH = 4;
constexpr int TIER0_HI = 18;
constexpr int TIER_W = 255;
constexpr int MAX_SAME_LETTER = 19 + 255 * 256;
constexpr int BLOCK_END_LITERALS = 5;
constexpr int BIG = 1 << 30;              // cost past the array
constexpr int MAX_N = 1 << 26;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_acquire64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// every block of the (co-resident) grid arrives before any leaves
__device__ void grid_sync(unsigned* count, unsigned* gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned g = ld_acquire(gen);
    __threadfence();
    if (atomicAdd(count, 1u) == gridDim.x - 1) {
      atomicExch(count, 0u);
      __threadfence();
      atomicAdd(gen, 1u);
    } else {
      while (ld_acquire(gen) == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// a flag word raised by any block this launch to at least `want`, read by
// thread 0 and shared with the block
__device__ bool flag_at_least(const unsigned long long* flag,
                              unsigned long long want, int* s_bcast) {
  if (threadIdx.x == 0) *s_bcast = ld_acquire64(flag) >= want;
  __syncthreads();
  const bool r = *s_bcast != 0;
  __syncthreads();
  return r;
}

__device__ int block_min(int v, int* s_red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(FULL, v, off));
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = s_red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = min(r, s_red[w]);
  __syncthreads();
  return r;
}

// the claim clamped to the DP's legal range: 1, or a length 4..limit-i
__device__ __forceinline__ int clamp_claim(int len, int i, int limit) {
  const int L = min(len, max(limit - i, 0));
  return (L >= MIN_MATCH && i < limit) ? L : 1;
}

__device__ __forceinline__ int lit_extra(int num_lit) {
  return (num_lit == 15 ||
          (num_lit >= 15 + TIER_W && (num_lit - 15) % TIER_W == 0)) ? 1 : 0;
}

__device__ __forceinline__ int extra_match(int len) {
  return len <= TIER0_HI ? 3 : 4 + (len - (TIER0_HI + 1)) / TIER_W;
}

__global__ void __launch_bounds__(THREADS)
parse_kernel(const int32_t* __restrict__ lens,
             const int32_t* __restrict__ dists, int32_t* choice,
             int32_t* cost, int32_t* flags, unsigned long long* W,
             unsigned long long* table, uint8_t* lit_cost, int32_t* agg,
             unsigned long long* state, int N, int n, int max_iters,
             unsigned epoch) {
  __shared__ int s_cost[TILE + HALO];
  __shared__ uint8_t s_off[LEVELS][TILE + HALO];
  __shared__ int s_red[WARPS];
  __shared__ int s_bcast;

  unsigned* count = reinterpret_cast<unsigned*>(state + 1);
  unsigned* gen = reinterpret_cast<unsigned*>(state + 2);
  unsigned long long* jump_flag = state + 3;
  unsigned long long* change_flag = state + 4;
  unsigned long long* max_len = state + 5;
  const unsigned long long tag = (unsigned long long)epoch << 32;
  const int tiles = (N + TILE - 1) / TILE;
  const int limit = n - BLOCK_END_LITERALS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // P0: the first policy takes every clamped claim; the longest claim the
  // scan will see (the shortcut's are not scanned)
  int lmax = 1;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i0 = t * TILE + threadIdx.x * PER;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int i = i0 + q;
      if (i >= N) break;
      const int L = clamp_claim(lens[i], i, limit);
      choice[i] = L;
      if (!(L >= MAX_SAME_LETTER && dists[i] == 1)) lmax = max(lmax, L);
    }
  }
  lmax = -block_min(-lmax, s_red);
  if (threadIdx.x == 0) atomicMax(max_len, tag | (unsigned)lmax);

  int it = 0;
  bool changed = true;
  unsigned g = 0;  // jump rounds of this launch
  while (true) {
    // P1: each tile's first non-literal position (N if none)
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int i0 = t * TILE + threadIdx.x * PER;
      int m = N;
#pragma unroll
      for (int q = PER - 1; q >= 0; --q) {
        const int i = i0 + q;
        if (i < N && !((choice[i] <= 1 || i >= limit) && i < n)) m = i;
      }
      m = block_min(m, s_red);
      if (threadIdx.x == 0) __stcg(agg + t, m);
    }
    grid_sync(count, gen);

    // P2: literal runs; each position's step and jump
    ++g;
    bool active = false;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int later = N;  // first non-literal of the later tiles
      for (int u = t + 1 + threadIdx.x; u < tiles; u += THREADS)
        later = min(later, __ldcg(agg + u));
      later = block_min(later, s_red);
      const int i0 = t * TILE + threadIdx.x * PER;
      int c[PER];
      bool lit[PER];
      int mine = N;  // the thread's first non-literal
#pragma unroll
      for (int q = PER - 1; q >= 0; --q) {
        const int i = i0 + q;
        c[q] = i < N ? choice[i] : 1;
        lit[q] = (c[q] <= 1 || i >= limit) && i < n;
        if (i < N && !lit[q]) mine = i;
      }
      // the first non-literal of the later threads of the tile: a suffix
      // min over the warp, then over the later warps
      int incl = mine;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_down_sync(FULL, incl, off);
        if (lane + off < 32) incl = min(incl, o);
      }
      int after = __shfl_down_sync(FULL, incl, 1);
      if (lane == 31) after = N;
      if (lane == 0) s_red[warp] = incl;
      __syncthreads();
      for (int w = warp + 1; w < WARPS; ++w) after = min(after, s_red[w]);
      __syncthreads();
      int next = min(after, later);  // first non-literal after position q
#pragma unroll
      for (int q = PER - 1; q >= 0; --q) {
        const int i = i0 + q;
        if (i >= N) continue;
        const int lx = 1 + lit_extra(next - i);
        int step, nxt;
        if (i >= limit) {
          step = 0;
          nxt = i;
        } else if (lit[q]) {
          step = lx;
          nxt = min(i + 1, N - 1);
        } else {
          step = extra_match(c[q]);
          nxt = min(i + c[q], N - 1);
        }
        lit_cost[i] = (uint8_t)lx;
        __stcg(W + i, ((unsigned long long)(unsigned)nxt << 32) |
                          (unsigned)step);
        active |= i < limit && nxt < limit;
        if (!lit[q]) next = i;
      }
    }
    if (__syncthreads_or(active) && threadIdx.x == 0)
      atomicMax(jump_flag, tag | g);
    grid_sync(count, gen);

    // P3: pointer jumping until every jump lands in the absorbing tail
    while (flag_at_least(jump_flag, tag | g, &s_bcast)) {
      ++g;
      active = false;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int i0 = t * TILE + threadIdx.x * PER;
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          const int i = i0 + q;
          if (i >= N) break;
          const unsigned long long w = __ldcg(W + i);
          const int nx = (int)(w >> 32);
          if (nx >= limit) continue;
          const unsigned long long w2 = __ldcg(W + nx);
          __stcg(W + i, (w2 & 0xFFFFFFFF00000000ull) |
                            (unsigned)((unsigned)w + (unsigned)w2));
          active |= (int)(w2 >> 32) < limit;
        }
      }
      if (__syncthreads_or(active) && threadIdx.x == 0)
        atomicMax(jump_flag, tag | g);
      grid_sync(count, gen);
    }

    const bool go = changed && it < max_iters;
    const bool tiers =
        go && (int)(unsigned)ld_acquire64(max_len) > TIER0_HI;
    // P4: the policy's costs; the range-min table for the improvement
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int s = t * TILE;
      const int i0 = s + threadIdx.x * PER;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int i = i0 + q;
        if (i < N) __stcg(cost + i, (int)(unsigned)__ldcg(W + i));
      }
      if (!tiers) continue;
      for (int k = threadIdx.x; k < TILE + HALO; k += THREADS) {
        const int j = s + k;
        s_cost[k] = j < N ? (int)(unsigned)__ldcg(W + j) : BIG;
        s_off[0][k] = 0;
      }
      __syncthreads();
#pragma unroll
      for (int lev = 1; lev < LEVELS; ++lev) {
        const int h = 1 << (lev - 1);
        // the later half's argmin lies further right: it wins ties
        for (int k = threadIdx.x; k < TILE + HALO - (1 << lev) + 1;
             k += THREADS) {
          const int o1 = s_off[lev - 1][k];
          const int o2 = h + s_off[lev - 1][k + h];
          s_off[lev][k] = (uint8_t)(s_cost[k + o2] <= s_cost[k + o1] ? o2
                                                                     : o1);
        }
        __syncthreads();
      }
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int k = threadIdx.x * PER + q;
        if (s + k >= N) break;
        unsigned long long word = 0;
#pragma unroll
        for (int lev = 1; lev < LEVELS; ++lev)
          word |= (unsigned long long)s_off[lev][k] << (8 * lev);
        __stcg(table + s + k, word);
      }
      __syncthreads();
    }
    if (!go) break;
    grid_sync(count, gen);

    // P5: re-decide every position
    bool ch = false;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int s = t * TILE;
      for (int k = threadIdx.x; k < TILE + TIER0_HI + 1; k += THREADS) {
        const int j = s + k;
        s_cost[k] = j < N ? __ldcg(cost + j) : 0;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int k = threadIdx.x * PER + q;
        const int i = s + k;
        if (i >= N) break;
        const int L = clamp_claim(lens[i], i, limit);
        int best_l;
        if (i >= limit) {
          best_l = 1;
        } else if (L >= MAX_SAME_LETTER && dists[i] == 1) {
          best_l = L;
        } else {
          int best_c = s_cost[k + 1] + lit_cost[i];
          best_l = 1;
          const int hi1 = min(L, TIER0_HI);
          for (int ln = MIN_MATCH; ln <= hi1; ++ln) {
            const int tot = s_cost[k + ln] + 3;
            if (tot <= best_c) {
              best_c = tot;
              best_l = ln;
            }
          }
          for (int tier = 2, lo = TIER0_HI + 1; lo <= L;
               ++tier, lo += TIER_W) {
            const int e = min(L, lo + TIER_W - 1);
            const int lev = 31 - __clz(e - lo + 1);
            const int a = i + lo, b = i + e - (1 << lev) + 1;
            const int j1 = a + (int)((__ldcg(table + a) >> (8 * lev)) & 0xFF);
            const int j2 = b + (int)((__ldcg(table + b) >> (8 * lev)) & 0xFF);
            const int c1 = __ldcg(cost + j1), c2 = __ldcg(cost + j2);
            const bool take2 = c2 < c1 || (c2 == c1 && j2 > j1);
            const int tot = (take2 ? c2 : c1) + 2 + tier;
            if (tot <= best_c) {
              best_c = tot;
              best_l = (take2 ? j2 : j1) - i;
            }
          }
        }
        if (best_l != choice[i]) {
          choice[i] = best_l;
          ch = true;
        }
      }
      __syncthreads();
    }
    if (__syncthreads_or(ch) && threadIdx.x == 0)
      atomicMax(change_flag, tag | (unsigned)(it + 1));
    grid_sync(count, gen);
    changed = flag_at_least(change_flag, tag | (unsigned)(it + 1), &s_bcast);
    ++it;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    flags[0] = changed ? 0 : 1;
    flags[1] = it;
  }
}

size_t scratch_bytes(long long N) {
  const long long tiles = (N + TILE - 1) / TILE;
  return (size_t)(16 * N + 4 * tiles + N);
}

}  // namespace

extern "C" {

// the most positions of s4_parse (no launch)
int s4_parse_max_n() { return MAX_N; }

// bytes of s4_parse's scratch at N positions (no launch)
int s4_parse_scratch_bytes(int N) { return (int)scratch_bytes(N); }

// Policy-iteration parse of int32 claims lens, dists [N] whose first n
// positions are the block, at most max_iters improvements: choice and cost
// int32 [N], flags int32 [2] = (converged, rounds).  `scratch` holds
// s4_parse_scratch_bytes(N) bytes, 8-byte aligned; `state` int64 words 1..5
// are zero before the first call on the stream and reused by later calls
// with epochs 1, 2, ... < 2^30.  One cooperative launch.
int s4_parse(const int32_t* lens, const int32_t* dists, int32_t* choice,
             int32_t* cost, int32_t* flags, void* scratch,
             unsigned long long* state, int N, int n, int max_iters,
             unsigned epoch, void* stream) {
  if (N < 1 || N > MAX_N || n < 0 || n > N || max_iters < 0 || epoch < 1 ||
      ((uintptr_t)scratch & 7))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, parse_kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int tiles = (N + TILE - 1) / TILE;
  const int grid = per_sm * sms < tiles ? per_sm * sms : tiles;
  unsigned long long* W = static_cast<unsigned long long*>(scratch);
  unsigned long long* table = W + N;
  int32_t* agg = reinterpret_cast<int32_t*>(table + N);
  uint8_t* lit_cost = reinterpret_cast<uint8_t*>(agg + tiles);
  void* args[] = {&lens, &dists, &choice, &cost, &flags, &W, &table,
                  &lit_cost, &agg, &state, &N, &n, &max_iters, &epoch};
  err = cudaLaunchCooperativeKernel((const void*)parse_kernel, dim3(grid),
                                    dim3(THREADS), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
