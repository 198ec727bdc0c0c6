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
// every phase.  The evaluation follows each position's jumps (a literal to
// i + 1, a match to i + length, the absorbing tail i >= limit = n - 5 to
// itself at cost 0).  Jumps only go forward and integer sums are exact in
// any order, so it runs on two levels: inside a tile in shared memory, and
// across tiles only over the few positions where some path enters a tile.
// A round:
//   P2  num_lit[i] = (the first non-literal after i) - i, from a suffix min
//       over the thread's 4 positions, the later threads and the first
//       later tile that has a non-literal (the last warp's look-forward
//       over the tiles' first non-literals, agg); each position's step
//       cost and first jump.
//   E1  (fused into P2) in-tile resolve: the tile's words W = nxt << 32 |
//       acc jump in shared memory (each thread's own in registers) until
//       every target is at or past the tile's end or in the tail: first
//       within a thread's 4 positions, then within a warp's 128 (warp
//       barriers only), then across the tile (one block barrier a round,
//       two copies of the words, at most log2 of its 16 warps rounds).  W'[i] = (exit, sum to the exit) goes to
//       global memory.  Every first jump that leaves the tile below limit
//       lands on an entry: the first block to claim it (atomicExch of the
//       evaluation's number on its mark) appends it to one global list,
//       one atomicAdd a warp.
//       The exit of every position is an entry or in the tail, so the
//       entries are closed under exit.
//   E2  global pointer jumping over the entries only: W'[p] <- (exit of
//       W'[x], sum + sum of W'[x]), x = exit of W'[p], a round a grid
//       barrier, until every entry's exit is in the tail.  A word is read
//       and written whole, so a word another block has already advanced
//       this round is still a consistent (target, sum) pair, which only
//       shortens the rounds.  A path crosses at least one tile a hop, so
//       the rounds are log2 of the tiles the longest path crosses.  Only
//       an entry's thread writes its word, so the thread keeps it (for its
//       first entries) in registers: a round is one gather an entry.  A
//       list of at most 2,048 entries runs in block 0 alone, a block
//       barrier a round instead of a grid barrier.
//   P4  (with E3) cost[i] = sum of W'[i] + (its exit below limit ? the
//       exit's final sum : 0); and, when a claim reaches tier 2 (length >=
//       19) and another improvement follows, the range-min table: for
//       levels k = 1..7, the offset (0..2^k - 1) of the last argmin of cost
//       over [j, j + 2^k), one byte a level, packed into a 64-bit word a
//       position (level 0 is the position itself), built in shared memory
//       from the tile's costs and a 128-position halo whose costs come the
//       same way.
//   P5  the improvement: the literal, tier 1 (lengths 4..18) in the
//       ascending `<=` scan from the tile's costs staged in shared memory,
//       each tier >= 2 as (min, last argmin) of two table lookups (four
//       tiers' lookups in flight at a time), the MAX_SAME_LETTER
//       distance-1 shortcut overriding the scan.  Any change
//       raises the round's flag.  Each tile's first non-literal of the new
//       policy goes to agg for the next round's P2.
// The result is the reference's, round for round: the same decisions, the
// same costs of the final policy (over the whole array, padding
// included), the same `converged` when max_iters cuts the iteration.
//
// Bound: the inputs (lens, dists) read once and the outputs (choice, cost)
// written once, 16 bytes a position: 20 us at 4 MiB on 3.35 TB/s.  The
// design moves, a round, 62 bytes a position (more where tiers reach the
// table), 20 an entry for its mark, its list slot and its word, and 16 an
// entry a global round; on real text a tile has a few entries, so the
// global rounds move little and the round is about 3 + log2(tiles) grid
// barriers and one pass over the arrays.  Jumping every position
// globally instead would move 24 bytes a position a jump round, about 20
// jump rounds an evaluation at 4 MiB.  What bounds the design on the card
// is latency: a block resolves its tiles one after another, each a chain
// of block barriers and memory round trips.
//
// Barriers: arrivals and a generation in one word (the last block to
// arrive clears the arrivals and bumps the generation in one atomic), so
// the state needs no reset between calls.  The round flags and the
// longest scanned claim are 64-bit words tagged with the call's epoch in
// the high half and only ever raised with atomicMax, so they too need no
// reset.  The entry marks
// live in the scratch, which the wrapper does not clear: the launch zeroes
// them once, and an evaluation marks with its own number (1, 2, ...), so
// nothing is cleared between rounds.  Data written during the launch is
// read through L2 (ld.global.cg): L1 is not coherent across SMs.

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
constexpr unsigned long long HI = 0xFFFFFFFF00000000ull;
constexpr unsigned long long NOWHERE = 0x7FFFFFFFull << 32;  // no jump
// shared memory: the table's costs and offsets (P4, P5), or two copies of
// the tile's words (E1), one phase at a time
constexpr int TABLE_SMEM = (4 + LEVELS) * (TILE + HALO);
constexpr int WORD_SMEM = 2 * 8 * TILE;
constexpr int SMEM = TABLE_SMEM > WORD_SMEM ? TABLE_SMEM : WORD_SMEM;
// a thread's share of a tile and its halo in P4
constexpr int SPAN_LOADS = (TILE + HALO + THREADS - 1) / THREADS;
constexpr int HELD = 2;      // entries a thread keeps in registers in E2
constexpr int SOLO_HELD = 4;  // ... when block 0 runs E2 alone
constexpr int TIER_ILP = 4;  // tiers >= 2 looked up together in P5

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

// every block of the (co-resident) grid arrives before any leaves.  One
// word: the arrivals in its low 16 bits (a grid has fewer blocks), the
// generation above them; the last block to arrive clears the arrivals and
// bumps the generation with one atomic, the others wait for the bump.
__device__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned old = atomicAdd(bar, 1u);
    if ((old & 0xFFFFu) == gridDim.x - 1) {
      atomicAdd(bar, 0x10000u - gridDim.x);
      __threadfence();
    } else {
      while (((ld_acquire(bar) ^ old) >> 16) == 0) __nanosleep(32);
    }
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

// a position that ends a literal run (the block end and padding too)
__device__ __forceinline__ bool non_literal(int c, int i, int limit, int n) {
  return !((c <= 1 || i >= limit) && i < n);
}

__device__ __forceinline__ int lit_extra(int num_lit) {
  return (num_lit == 15 ||
          (num_lit >= 15 + TIER_W && (num_lit - 15) % TIER_W == 0)) ? 1 : 0;
}

__device__ __forceinline__ int extra_match(int len) {
  return len <= TIER0_HI ? 3 : 4 + (len - (TIER0_HI + 1)) / TIER_W;
}

__device__ __forceinline__ int target(unsigned long long w) {
  return (int)(w >> 32);
}

// the word of two jumps: w's sum plus w2's, to w2's target
__device__ __forceinline__ unsigned long long join(unsigned long long w,
                                                   unsigned long long w2) {
  return (w2 & HI) | (unsigned)((unsigned)w + (unsigned)w2);
}

__global__ void __launch_bounds__(THREADS, 2)
parse_kernel(const int32_t* __restrict__ lens,
             const int32_t* __restrict__ dists, int32_t* __restrict__ choice,
             int32_t* __restrict__ cost, int32_t* flags,
             unsigned long long* __restrict__ W,
             unsigned long long* __restrict__ table,
             uint8_t* __restrict__ lit_cost, int32_t* __restrict__ agg,
             unsigned* __restrict__ mark, int32_t* __restrict__ list,
             int32_t* __restrict__ n_entries, unsigned long long* state,
             int N, int n, int max_iters, unsigned epoch) {
  __shared__ __align__(16) unsigned char s_raw[SMEM];
  __shared__ int s_red[WARPS];
  __shared__ int s_bcast, s_later;
  int* s_cost = reinterpret_cast<int*>(s_raw);
  uint8_t(*s_off)[TILE + HALO] = reinterpret_cast<uint8_t(*)[TILE + HALO]>(
      s_raw + 4 * (TILE + HALO));
  unsigned long long* s_w = reinterpret_cast<unsigned long long*>(s_raw);

  unsigned* bar = reinterpret_cast<unsigned*>(state + 1);
  unsigned long long* jump_flag = state + 3;
  unsigned long long* change_flag = state + 4;
  unsigned long long* max_len = state + 5;
  const unsigned long long tag = (unsigned long long)epoch << 32;
  const int tiles = (N + TILE - 1) / TILE;
  const int limit = n - BLOCK_END_LITERALS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // P0: the first policy takes every clamped claim; each tile's first
  // non-literal; the longest claim the scan will see (the shortcut's are
  // not scanned); the entry marks and the entry count cleared
  int lmax = 1;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i0 = t * TILE + threadIdx.x * PER;
    int m = N;
#pragma unroll
    for (int q = PER - 1; q >= 0; --q) {
      const int i = i0 + q;
      if (i >= N) continue;
      const int L = clamp_claim(lens[i], i, limit);
      choice[i] = L;
      __stcg(mark + i, 0u);
      if (!(L >= MAX_SAME_LETTER && dists[i] == 1)) lmax = max(lmax, L);
      if (non_literal(L, i, limit, n)) m = i;
    }
    m = block_min(m, s_red);
    if (threadIdx.x == 0) __stcg(agg + t, m);
  }
  lmax = -block_min(-lmax, s_red);
  if (threadIdx.x == 0) atomicMax(max_len, tag | (unsigned)lmax);
  if (blockIdx.x == 0 && threadIdx.x == 0) __stcg(n_entries, 0);
  grid_sync(bar);

  int it = 0;
  bool changed = true;
  unsigned g = 0;  // jump flag rounds of this launch
  while (true) {
    const unsigned ev = (unsigned)it + 1;  // this evaluation's mark
    // P2 + E1: literal runs; steps and first jumps; the in-tile resolve;
    // the entries
    ++g;
    bool active = false;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int s = t * TILE, tend = s + TILE;
      const int i0 = s + threadIdx.x * PER;
      int c[PER];
#pragma unroll
      for (int q = 0; q < PER; ++q) c[q] = i0 + q < N ? choice[i0 + q] : 1;
      // the first non-literal of the later tiles: the last warp looks
      // forward over agg, 128 tiles at a time, while the others go on
      if (warp == WARPS - 1) {
        int later = N;
        for (int u0 = t + 1; u0 < tiles && later == N; u0 += 4 * 32) {
          int v[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int u = u0 + r * 32 + lane;
            v[r] = u < tiles ? __ldcg(agg + u) : N;
          }
          later = min(min(v[0], v[1]), min(v[2], v[3]));
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            later = min(later, __shfl_xor_sync(FULL, later, off));
        }
        if (lane == 0) s_later = later;
      }
      bool lit[PER];
      int mine = N;  // the thread's first non-literal
#pragma unroll
      for (int q = PER - 1; q >= 0; --q) {
        const int i = i0 + q;
        lit[q] = !non_literal(c[q], i, limit, n);
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
      int next = min(after, s_later);  // first non-literal after position q
      __syncthreads();
      unsigned long long w[PER];
      int first[PER];  // the first jumps
#pragma unroll
      for (int q = PER - 1; q >= 0; --q) {
        const int i = i0 + q;
        w[q] = NOWHERE;
        first[q] = 0;
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
        w[q] = ((unsigned long long)(unsigned)nxt << 32) | (unsigned)step;
        first[q] = nxt;
        // E1 starts in the thread: a jump to one of its later positions
        // takes that one's word (already resolved past the thread)
#pragma unroll
        for (int r = q + 1; r < PER; ++r)
          if (nxt == i0 + r && nxt < limit) w[q] = join(w[q], w[r]);
        s_w[i - s] = w[q];
        if (!lit[q]) next = i;
      }
      // E1 in the warp: jump inside the warp's 128 positions (each lane
      // wrote its own words), then in the tile until every target leaves
      // it or rests in the tail; the targets are read before any word of
      // the round moves
      const int wend = min(s + (warp + 1) * 32 * PER, tend);
      bool in_warp = false;
#pragma unroll
      for (int q = 0; q < PER; ++q)
        in_warp |= target(w[q]) < wend && target(w[q]) < limit;
      __syncwarp();
      while (__any_sync(FULL, in_warp)) {
        unsigned long long nw[PER];
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          const int nx = target(w[q]);
          nw[q] = (i0 + q < N && nx < wend && nx < limit)
                      ? join(w[q], s_w[nx - s]) : w[q];
        }
        __syncwarp();
        in_warp = false;
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          if (i0 + q >= N) continue;
          w[q] = nw[q];
          s_w[i0 + q - s] = w[q];
          in_warp |= target(w[q]) < wend && target(w[q]) < limit;
        }
        __syncwarp();
      }
      // the tile's rounds read one copy of the words and write the other,
      // one block barrier a round
      bool open = false;
#pragma unroll
      for (int q = 0; q < PER; ++q)
        open |= target(w[q]) < tend && target(w[q]) < limit;
      for (int side = 0; __syncthreads_or(open); side ^= 1) {
        const unsigned long long* from = s_w + side * TILE;
        unsigned long long* to = s_w + (side ^ 1) * TILE;
        open = false;
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          if (i0 + q >= N) continue;
          const int nx = target(w[q]);
          if (nx < tend && nx < limit) w[q] = join(w[q], from[nx - s]);
          to[i0 + q - s] = w[q];
          open |= target(w[q]) < tend && target(w[q]) < limit;
        }
      }
#pragma unroll
      for (int q = 0; q < PER; ++q)
        if (i0 + q < N) __stcg(W + i0 + q, w[q]);
      // the entries: first jumps out of the tile, below limit, each
      // appended by the first block to mark it this evaluation; the lanes
      // of a warp that share a target leave it to one (runs of claims
      // that end together would queue on one mark), and the warp takes
      // its slots in the list with one atomicAdd
      bool won[PER];
      int mine_n = 0;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int p = first[q];
        const bool out = p >= tend && p < limit;
        const unsigned same = __match_any_sync(FULL, out ? p : -1);
        won[q] = out && lane == __ffs(same) - 1;
      }
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        won[q] = won[q] && atomicExch(mark + first[q], ev) != ev;
        mine_n += won[q];
      }
      int upto = mine_n;  // the warp's inclusive prefix of the wins
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(FULL, upto, off);
        if (lane >= off) upto += o;
      }
      int slot = 0;
      if (lane == 31 && upto) slot = atomicAdd(n_entries, upto);
      slot = __shfl_sync(FULL, slot, 31) + upto - mine_n;
#pragma unroll
      for (int q = 0; q < PER; ++q)
        if (won[q]) __stcg(list + slot++, first[q]);
      active |= mine_n > 0;
    }
    if (__syncthreads_or(active) && threadIdx.x == 0)
      atomicMax(jump_flag, tag | g);
    grid_sync(bar);

    // E2: pointer jumping over the entries until every one reaches the
    // tail.  An entry's word has no writer but its thread, so a thread
    // keeps its first entries and their words in registers.  A list that
    // fits one block's registers runs in block 0 alone, a block barrier a
    // round, while the others wait at one grid barrier; a longer one runs
    // on the grid, a grid barrier a round.
    const int entries = __ldcg(n_entries);
    if (entries <= THREADS * SOLO_HELD) {
      if (blockIdx.x == 0) {
        int sp[SOLO_HELD];
        unsigned long long sw[SOLO_HELD];
#pragma unroll
        for (int h = 0; h < SOLO_HELD; ++h) {
          const int k = threadIdx.x + h * THREADS;
          sp[h] = k < entries ? __ldcg(list + k) : -1;
        }
        bool more = false;
#pragma unroll
        for (int h = 0; h < SOLO_HELD; ++h) {
          sw[h] = sp[h] >= 0 ? __ldcg(W + sp[h]) : NOWHERE;
          more |= target(sw[h]) < limit;
        }
        while (__syncthreads_or(more)) {
          unsigned long long w2[SOLO_HELD];
#pragma unroll
          for (int h = 0; h < SOLO_HELD; ++h)
            w2[h] = target(sw[h]) < limit ? __ldcg(W + target(sw[h])) : 0;
          more = false;
#pragma unroll
          for (int h = 0; h < SOLO_HELD; ++h) {
            if (target(sw[h]) >= limit) continue;
            sw[h] = join(sw[h], w2[h]);
            __stcg(W + sp[h], sw[h]);
            more |= target(sw[h]) < limit;
          }
        }
      }
      grid_sync(bar);
    } else {
      const int k0 = blockIdx.x * THREADS + threadIdx.x;
      int hp[HELD];
      unsigned long long hw[HELD];
#pragma unroll
      for (int h = 0; h < HELD; ++h) {
        const int k = k0 + h * gridDim.x * THREADS;
        hp[h] = k < entries ? __ldcg(list + k) : -1;
      }
#pragma unroll
      for (int h = 0; h < HELD; ++h)
        hw[h] = hp[h] >= 0 ? __ldcg(W + hp[h]) : NOWHERE;
      while (flag_at_least(jump_flag, tag | g, &s_bcast)) {
        ++g;
        active = false;
        unsigned long long w2[HELD];
#pragma unroll
        for (int h = 0; h < HELD; ++h)
          w2[h] = target(hw[h]) < limit ? __ldcg(W + target(hw[h])) : 0;
#pragma unroll
        for (int h = 0; h < HELD; ++h) {
          if (target(hw[h]) >= limit) continue;
          hw[h] = join(hw[h], w2[h]);
          __stcg(W + hp[h], hw[h]);
          active |= target(hw[h]) < limit;
        }
        for (int k = k0 + HELD * gridDim.x * THREADS; k < entries;
             k += gridDim.x * THREADS) {
          const int p = __ldcg(list + k);
          const unsigned long long wp = __ldcg(W + p);
          if (target(wp) >= limit) continue;
          const unsigned long long w2 = __ldcg(W + target(wp));
          __stcg(W + p, join(wp, w2));
          active |= target(w2) < limit;
        }
        if (__syncthreads_or(active) && threadIdx.x == 0)
          atomicMax(jump_flag, tag | g);
        grid_sync(bar);
      }
    }

    const bool go = changed && it < max_iters;
    const bool tiers =
        go && (int)(unsigned)ld_acquire64(max_len) > TIER0_HI;
    // the next evaluation's list starts empty (E2 read its count before
    // the barrier that ended it)
    if (blockIdx.x == 0 && threadIdx.x == 0) __stcg(n_entries, 0);
    // P4 + E3: the policy's costs; the range-min table for the improvement
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int s = t * TILE;
      const int span = tiers ? TILE + HALO : TILE;
      // every word of the thread, then every exit's word, then the costs:
      // the loads of a tile in flight together
      unsigned long long wj[SPAN_LOADS];
      int ce[SPAN_LOADS];
#pragma unroll
      for (int r = 0; r < SPAN_LOADS; ++r) {
        const int k = threadIdx.x + r * THREADS;
        wj[r] = k < span && s + k < N ? __ldcg(W + s + k) : NOWHERE;
      }
#pragma unroll
      for (int r = 0; r < SPAN_LOADS; ++r)
        ce[r] = target(wj[r]) < limit ? (int)(unsigned)__ldcg(
                                            W + target(wj[r])) : 0;
#pragma unroll
      for (int r = 0; r < SPAN_LOADS; ++r) {
        const int k = threadIdx.x + r * THREADS, j = s + k;
        if (k >= span) continue;
        const int cj = j < N ? (int)(unsigned)wj[r] + ce[r] : BIG;
        if (j < N && k < TILE) __stcg(cost + j, cj);
        if (tiers) {
          s_cost[k] = cj;
          s_off[0][k] = 0;
        }
      }
      if (!tiers) continue;
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
    grid_sync(bar);

    // P5: re-decide every position; each tile's first non-literal
    bool ch = false;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int s = t * TILE;
      const int i0 = s + threadIdx.x * PER;
      int len[PER], cur[PER];  // loaded before the staging's barrier
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        len[q] = i0 + q < N ? lens[i0 + q] : 1;
        cur[q] = i0 + q < N ? choice[i0 + q] : 0;
      }
      for (int k = threadIdx.x; k < TILE + TIER0_HI + 1; k += THREADS) {
        const int j = s + k;
        s_cost[k] = j < N ? __ldcg(cost + j) : 0;
      }
      __syncthreads();
      int m = N;
#pragma unroll
      for (int q = PER - 1; q >= 0; --q) {
        const int k = threadIdx.x * PER + q;
        const int i = s + k;
        if (i >= N) continue;
        const int L = clamp_claim(len[q], i, limit);
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
          // TIER_ILP tiers at a time: their lookups in flight together,
          // their minima taken in ascending order
          for (int tier = 2, lo = TIER0_HI + 1; lo <= L;
               tier += TIER_ILP, lo += TIER_ILP * TIER_W) {
            int j1[TIER_ILP], j2[TIER_ILP], lev[TIER_ILP];
            unsigned long long t1[TIER_ILP], t2[TIER_ILP];
#pragma unroll
            for (int u = 0; u < TIER_ILP; ++u) {
              const int lu = lo + u * TIER_W, e = min(L, lu + TIER_W - 1);
              lev[u] = lu <= L ? 31 - __clz(e - lu + 1) : 0;
              j1[u] = i + lu;
              j2[u] = i + e - (1 << lev[u]) + 1;
              t1[u] = lu <= L ? __ldcg(table + j1[u]) : 0;
              t2[u] = lu <= L ? __ldcg(table + j2[u]) : 0;
            }
            int c1[TIER_ILP], c2[TIER_ILP];
#pragma unroll
            for (int u = 0; u < TIER_ILP; ++u) {
              const bool ok = lo + u * TIER_W <= L;
              j1[u] += (int)((t1[u] >> (8 * lev[u])) & 0xFF);
              j2[u] += (int)((t2[u] >> (8 * lev[u])) & 0xFF);
              c1[u] = ok ? __ldcg(cost + j1[u]) : 0;
              c2[u] = ok ? __ldcg(cost + j2[u]) : 0;
            }
#pragma unroll
            for (int u = 0; u < TIER_ILP; ++u) {
              if (lo + u * TIER_W > L) break;
              const bool take2 =
                  c2[u] < c1[u] || (c2[u] == c1[u] && j2[u] > j1[u]);
              const int tot = (take2 ? c2[u] : c1[u]) + 2 + tier + u;
              if (tot <= best_c) {
                best_c = tot;
                best_l = (take2 ? j2[u] : j1[u]) - i;
              }
            }
          }
        }
        cur[q] = best_l != cur[q] ? best_l : 0;  // 0: unchanged
        if (non_literal(best_l, i, limit, n)) m = i;
      }
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        if (cur[q] == 0) continue;
        choice[i0 + q] = cur[q];
        ch = true;
      }
      m = block_min(m, s_red);  // its barrier also frees s_cost
      if (threadIdx.x == 0) __stcg(agg + t, m);
    }
    if (__syncthreads_or(ch) && threadIdx.x == 0)
      atomicMax(change_flag, tag | (unsigned)(it + 1));
    grid_sync(bar);
    changed = flag_at_least(change_flag, tag | (unsigned)(it + 1), &s_bcast);
    ++it;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    flags[0] = changed ? 0 : 1;
    flags[1] = it;
  }
}

// scratch: W and the table (8 bytes a position each), the tiles' first
// non-literals and the entry count, the marks and the entry list (4 bytes
// a position each), the literal costs (1 byte a position)
size_t scratch_bytes(long long N) {
  const long long tiles = (N + TILE - 1) / TILE;
  return (size_t)(16 * N + 4 * (tiles + 2) + 8 * N + N);
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
// s4_parse_scratch_bytes(N) bytes, 8-byte aligned, of any content; `state`
// int64 words 1..5 are zero before the first call on the stream and reused
// by later calls with epochs 1, 2, ... < 2^30 (word 2 is unused).  One
// cooperative launch.
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
  int32_t* n_entries = agg + tiles;
  unsigned* mark = reinterpret_cast<unsigned*>(n_entries + 2);
  int32_t* list = reinterpret_cast<int32_t*>(mark + N);
  uint8_t* lit_cost = reinterpret_cast<uint8_t*>(list + N);
  void* args[] = {&lens,   &dists, &choice, &cost,      &flags,
                  &W,      &table, &lit_cost, &agg,     &mark,
                  &list,   &n_entries, &state, &N,      &n,
                  &max_iters, &epoch};
  err = cudaLaunchCooperativeKernel((const void*)parse_kernel, dim3(grid),
                                    dim3(THREADS), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
